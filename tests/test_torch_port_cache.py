"""The port's dataset cache (ROADMAP C.8) and ``train_val_split``, against
the JAX package on the CPU.

The cache file carries the port's own name and the decoder's version
(``data/native/loader.py::DECODE_VERSION``): a cache planted under the JAX
package's name, or under an older port tag, holding wrong pixels, is never
read, and the images equal a ``use_cache=False`` decode. ``train_val_split``
gives the JAX function's split, index for index, on the same seed.
"""

import numpy as np
import pytest

from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative
from siggan_tpu_torch.data.synthetic import save_dataset_pngs


@pytest.fixture()
def pngs(tmp_path):
    return save_dataset_pngs(6, tmp_path / "d", seed=3)


def test_cache_name_carries_the_port_and_the_decoder_version(pngs):
    ds = tdataset.SignatureDataset(pngs, 64)
    name = ds._cache_path().name
    assert name.startswith(f".siggan_torch_cache_64_{tnative.DECODE_VERSION}_")
    assert name != jdataset.SignatureDataset(pngs, 64, use_cache=False)._cache_path().name
    assert [p.name for p in pngs.glob(".siggan*")] == [name]
    np.testing.assert_array_equal(np.load(pngs / name), ds.images)


@pytest.mark.parametrize("planted", ["jax", "older port tag", "untagged port name", "d3 tag",
                                     "d4 tag", "d5 tag", "d6 tag"])
def test_foreign_and_stale_caches_are_ignored(pngs, planted):
    """A cache of wrong pixels under another name is not read; the port
    decodes and writes its own."""
    want = tdataset.SignatureDataset(pngs, 64, use_cache=False).images
    own = tdataset.SignatureDataset(pngs, 64, use_cache=False)._cache_path().name
    sig = own.rsplit("_", 1)[1]
    if planted == "jax":
        name = jdataset.SignatureDataset(pngs, 64, use_cache=False)._cache_path().name
    elif planted == "older port tag":
        name = f".siggan_torch_cache_64_d1_{sig}"
    elif planted == "d3 tag":  # written before C.13's last repairs and A.6.7-A.6.12
        name = f".siggan_torch_cache_64_d3_{sig}"
    elif planted == "d4 tag":  # written before damaged CCITT data was read as libtiff reads it
        name = f".siggan_torch_cache_64_d4_{sig}"
    elif planted == "d5 tag":  # written before damaged ZSTD literals were read as libzstd reads them
        name = f".siggan_torch_cache_64_d5_{sig}"
    elif planted == "d6 tag":  # written before damaged old-style JPEG-in-TIFF was read as libtiff reads it
        name = f".siggan_torch_cache_64_d6_{sig}"
    else:
        name = f".siggan_cache_64_{sig}"
    assert name != own
    np.save(pngs / name, np.full_like(want, 0.5))
    got = tdataset.SignatureDataset(pngs, 64).images
    np.testing.assert_array_equal(got, want)
    assert (pngs / own).exists()
    np.testing.assert_array_equal(np.load(pngs / own), want)


def test_a_d3_cache_of_a_tree_the_port_now_reads_is_not_read(tmp_path):
    """A tree with a BigTIFF (d3 raised on it; d4 reads it) and a d3 cache
    holding other pixels: the dataset decodes anew under its own name (d10
    since old-style JPEG-in-TIFF headers skip as libtiff skips, C.26)."""
    from PIL import Image
    save_dataset_pngs(3, tmp_path, seed=4)
    scan = (np.random.RandomState(5).rand(30, 50) * 255).astype(np.uint8)
    Image.fromarray(scan).save(tmp_path / "scan.tif", big_tiff=True)
    assert tnative.DECODE_VERSION == "d10"
    want = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    own = want._cache_path().name
    np.save(tmp_path / own.replace("_d10_", "_d3_"), np.zeros_like(want.images))
    got = tdataset.SignatureDataset(tmp_path, 32)
    assert got.images.any() and (tmp_path / own).exists()
    np.testing.assert_array_equal(got.images, want.images)


def test_a_d5_cache_of_a_tree_the_port_now_reads_is_not_read(tmp_path, monkeypatch):
    """A tree with a CCITT TIFF in tiles and an old-style LZW TIFF (d5
    raised on both; d6 reads them, A.6.16 and A.6.18) and a d5 cache holding
    other pixels: the dataset decodes anew under its own name, as the JAX
    package reads the tree (its PIL path)."""
    import chip_smoke
    from siggan_tpu.data.native import loader as jnative
    monkeypatch.setattr(jnative, "available", lambda: False)
    save_dataset_pngs(3, tmp_path, seed=6)
    scan = (np.random.RandomState(7).rand(40, 70) * 255).astype(np.int64)
    (tmp_path / "tiles.tif").write_bytes(chip_smoke.tiff_g4(scan < 100, tile=(32, 16)))
    (tmp_path / "old_lzw.tif").write_bytes(
        chip_smoke.tiff_layout(scan[..., None], 8, 1, compression=-5, rows_per_strip=16))
    want = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    own = want._cache_path().name
    assert "_d10_" in own
    np.save(tmp_path / own.replace("_d10_", "_d5_"), np.zeros_like(want.images))
    got = tdataset.SignatureDataset(tmp_path, 32)
    assert got.images.any() and (tmp_path / own).exists()
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(
        got.images, jdataset.SignatureDataset(tmp_path, 32, use_cache=False).images)


def test_jax_package_still_reads_its_own_cache(pngs):
    """The JAX package's cache is left alone by the port (it is frozen and
    keeps its own name)."""
    jds = jdataset.SignatureDataset(pngs, 64)
    tdataset.SignatureDataset(pngs, 64)
    jname = jds._cache_path().name
    np.testing.assert_array_equal(np.load(pngs / jname), jds.images)


@pytest.mark.parametrize("n,frac,seed", [(6, 0.1, 0), (6, 0.5, 3), (6, 0.34, 7), (6, 0.0, 1)])
def test_train_val_split_matches_jax(pngs, n, frac, seed):
    ds = tdataset.SignatureDataset(pngs, 64, use_cache=False)
    jds = jdataset.SignatureDataset(pngs, 64, use_cache=False)
    assert len(ds) == n
    t_train, t_val = tdataset.train_val_split(ds, frac, seed)
    j_train, j_val = jdataset.train_val_split(jds, frac, seed)
    np.testing.assert_array_equal(t_train, j_train)
    np.testing.assert_array_equal(t_val, j_val)
    assert len(t_val) == int(n * frac) and len(t_train) + len(t_val) == n
