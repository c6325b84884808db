"""The port's preprocessing and its PIL-exact resize against the JAX package.

Same inputs (numpy seeds) go through ``siggan_tpu.data.preprocess`` /
``siggan_tpu.cli.preprocess`` (JAX, PIL) and ``siggan_tpu_torch.data``
(batched tensor ops on the CPU here). Tolerances:

- ``resize_bilinear``, ``decode_image``, ``load_canvas``: bit-equal with
  PIL and the JAX package;
- the stages on the same input (JAX's output of the stage before): blur,
  opening, validity, bounding box, centre-of-mass shift, CLAHE and the
  normalization equal to atol 1e-4; adaptive binarization: at most 0.1 %
  of the pixels flipped (its 11-tap Gaussian from each package's f32
  ``exp``); the crop + resize within 1e-3 grey levels of a float64
  reference, and within 2 grey levels of JAX (mean 0.1), whose f32
  integral image rounds (ulp 0.5 at a 128 px canvas's 4.2e6);
- the whole pipeline, where CLAHE rounds each pixel to a level and a
  tile's histogram takes those levels, so JAX's crop rounding flips some:
  the same valid flags; in uint8 grey levels at most 25 % of the pixels
  differ, at most 8 % by more than 2 levels, none by more than 40, with a
  mean difference of at most 1 level (CLAHE); with binarization at most
  0.5 % of the pixels differ. On integer canvases of the output size, with
  no crop, shift or blur, nothing rounds and the pipelines are bit-equal up
  to CLAHE's output.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data import preprocess as jp
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data import preprocess as tp
from siggan_tpu_torch.data.resample import resize_bilinear


# -- the resize ---------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((100, 80), (64, 64)), ((300, 500), (64, 64)), ((48, 48), (64, 64)),
    ((130, 128), (64, 64)), ((1, 1), (64, 64)), ((1, 57), (9, 4)),
    ((700, 301), (512, 220)), ((64, 64), (64, 65)), ((5, 911), (3, 511)),
    ((33, 17), (1, 1))])
def test_resize_matches_pil(src, dst):
    """Pillow's 8-bit L-mode BILINEAR resize, bit for bit: downscales,
    upscales, odd sizes, 1-pixel extents, one axis only."""
    a = np.random.RandomState(src[0] * 1000 + src[1]).randint(0, 256, src).astype(np.uint8)
    want = np.asarray(Image.fromarray(a).resize((dst[1], dst[0]), Image.BILINEAR))
    got = resize_bilinear(a, dst[1], dst[0])
    assert got.dtype == np.uint8 and got.shape == dst
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,size", [("L", (100, 80)), ("L", (48, 48)), ("RGB", (130, 128)),
                                       ("RGBA", (37, 300)), ("L", (64, 64))])
def test_decode_image_matches_jax(tmp_path, mode, size):
    """``decode_image`` of PNGs of other sizes (and the 64 px one) equals
    the JAX package's PIL decode + resize, bit for bit."""
    rs = np.random.RandomState(size[0])
    chans = {"L": (), "RGB": (3,), "RGBA": (4,)}[mode]
    path = tmp_path / "x.png"
    Image.fromarray(rs.randint(0, 256, size + chans).astype(np.uint8), mode).save(path)
    for s in (64, 128):
        np.testing.assert_array_equal(tdataset.decode_image(path, s),
                                      jdataset.decode_image(path, s))


@pytest.mark.parametrize("size", [(100, 60), (300, 200), (129, 50), (40, 700)])
def test_load_canvas_matches_jax(tmp_path, size):
    """The CLIs' letterbox: the same canvas and extent, downscaled when
    over the canvas (``int(w * s)`` truncation, PIL's bilinear)."""
    from siggan_tpu.cli.preprocess import load_canvas as jload
    from siggan_tpu_torch.cli.preprocess import load_canvas as tload
    path = tmp_path / "s.png"
    Image.fromarray(np.random.RandomState(1).randint(0, 256, size + (3,)).astype(np.uint8)
                    ).save(path)
    got, want = tload(path, 128), jload(path, 128)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


# -- scans ---------------------------------------------------------------------

def scans(n, canvas, seed, blank=()):
    """Letterboxed grey pages with dark strokes and specks; the images in
    ``blank`` are white pages (invalid)."""
    rs = np.random.RandomState(seed)
    c = np.full((n, canvas, canvas), 255.0, np.float32)
    hw = np.zeros((n, 2), np.int32)
    for i in range(n):
        h, w = rs.randint(canvas // 2, canvas + 1, 2)
        hw[i] = h, w
        page = rs.randint(200, 256, (h, w)).astype(np.float32)
        if i not in blank:
            for _ in range(rs.randint(8, 16)):
                y, x = rs.randint(0, h), rs.randint(0, w)
                page[max(0, y - 2):y + 3, max(0, x - 15):x + 15] = rs.randint(0, 90)
        c[i, :h, :w] = page
    return c, hw


@pytest.fixture(scope="module")
def batch():
    c, hw = scans(8, 128, 0, blank=(3,))
    return c, hw


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _crop_reference(x, bbox, out=64):
    """Float64 box averages over the crop's source spans (each pixel
    weighted by its overlap with the span), the spans' edges computed in
    f32 as the JAX function computes them."""
    f = np.float32
    res = np.full((len(x), out, out), 255.0)
    for n, (bx, by, bw, bh) in enumerate(np.asarray(bbox, f)):
        scale = min(f(out) / bw, f(out) / bh)
        new_w, new_h = max(int(np.floor(bw * scale)), 1), max(int(np.floor(bh * scale)), 1)
        ox, oy = (out - new_w) // 2, (out - new_h) // 2
        sx, sy = bw / f(new_w), bh / f(new_h)

        def overlaps(b0, step, size, new):
            lo = (b0 + np.arange(new).astype(f) * step).astype(f)
            hi = (lo + step).astype(f)
            px = np.arange(size, dtype=np.float64)
            w = np.minimum(px[None] + 1, hi[:, None]) - np.maximum(px[None], lo[:, None])
            return np.clip(w, 0, None), (hi - lo).astype(f)
        wx, lx = overlaps(bx, sx, x.shape[2], new_w)
        wy, ly = overlaps(by, sy, x.shape[1], new_h)
        box = wy @ np.asarray(x[n], np.float64) @ wx.T
        area = (ly[:, None] * lx[None, :]).astype(f).astype(np.float64)
        res[n, oy:oy + new_h, ox:ox + new_w] = box / area
    return res


def test_stages_match_jax_on_the_same_input(batch):
    """Each stage of the pipeline on JAX's output of the stage before."""
    c, hw = batch
    jc, jhw = jnp.asarray(c), jnp.asarray(hw)
    x = np.asarray(jax.vmap(jp.remove_noise)(jc))
    np.testing.assert_allclose(tp.remove_noise(_t(c)).numpy(), x, rtol=0, atol=1e-4)
    for stage in (jp.gaussian_blur3, jp.morph_open2):
        np.testing.assert_allclose(
            getattr(tp, stage.__name__)(_t(c)).numpy(), np.asarray(jax.vmap(stage)(jc)),
            rtol=0, atol=1e-4)
    valid = np.asarray(jax.vmap(jp.is_valid_signature)(x, jhw))
    assert not valid[3] and valid.sum() >= 5
    np.testing.assert_array_equal(tp.is_valid_signature(_t(x), _t(hw)).numpy(), valid)
    bbox = np.asarray(jax.vmap(jp.find_bbox)(x, jhw))
    np.testing.assert_array_equal(tp.find_bbox(_t(x), _t(hw)).numpy(), bbox)
    crop_j = np.asarray(jax.vmap(lambda a, b: jp.crop_resize_pad(a, b, 64))(x, bbox))
    crop_t = tp.crop_resize_pad(_t(x), _t(bbox), 64).numpy()
    np.testing.assert_allclose(crop_t, _crop_reference(x, bbox), rtol=0, atol=1e-3)
    np.testing.assert_allclose(crop_t, crop_j, rtol=0, atol=2.0)
    assert np.abs(crop_t - crop_j).mean() <= 0.1
    cen = np.asarray(jax.vmap(jp.center_signature)(crop_j))
    np.testing.assert_allclose(tp.center_signature(_t(crop_j)).numpy(), cen, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp.clahe(_t(cen)).numpy(), np.asarray(jax.vmap(jp.clahe)(cen)),
                               rtol=0, atol=1e-4)
    flips = tp.adaptive_binarize(_t(cen)).numpy() != np.asarray(jax.vmap(jp.adaptive_binarize)(cen))
    assert flips.mean() <= 1e-3
    np.testing.assert_array_equal(tp.threshold_binarize(_t(cen)).numpy(),
                                  np.asarray(jp.threshold_binarize(cen)))
    norm = np.asarray(jp.normalize_pixels(cen))
    np.testing.assert_allclose(tp.normalize_pixels(_t(cen)).numpy(), norm, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tp.denormalize_pixels(_t(norm)).numpy(),
                                  np.asarray(jp.denormalize_pixels(norm)))
    one, ok = tp.preprocess_one(_t(c[0]), _t(hw[0]))
    assert one.shape == (64, 64) and bool(ok)


def _u8(imgs, normalize, denorm):
    return (np.asarray(denorm(imgs)) if normalize
            else np.clip(np.asarray(imgs), 0, 255).astype(np.uint8)).astype(np.int64)


@pytest.mark.parametrize("flags", [
    {}, {"binarize": True}, {"remove_margin": False, "center": False},
    {"denoise": False, "validate": False, "normalize": False}, {"target_size": 32}],
    ids=["default", "binarize", "no_crop_no_center", "raw_unnormalized", "size32"])
def test_pipeline_matches_preprocess_batch_device(batch, flags):
    """``preprocess_batch`` against the JAX package's jitted
    ``preprocess_batch_device`` on the same canvases (the module
    docstring's whole-pipeline tolerance)."""
    c, hw = batch
    ij, vj = jp.preprocess_batch_device(jnp.asarray(c), jnp.asarray(hw), **flags)
    it, vt = tp.preprocess_batch(_t(c), _t(hw), **flags)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    size = flags.get("target_size", 64)
    assert it.shape == (8, size, size) and it.dtype == torch.float32
    norm = flags.get("normalize", True)
    d = np.abs(_u8(it.numpy(), norm, lambda a: tp.denormalize_pixels(_t(a)))
               - _u8(ij, norm, jp.denormalize_pixels))
    if flags.get("binarize"):
        assert (d > 0).mean() <= 5e-3
    else:
        assert (d > 0).mean() <= 0.25 and (d > 2).mean() <= 0.08
        assert d.max() <= 40 and d.mean() <= 1.0


def test_pipeline_without_rounding_is_bit_equal():
    """64 px integer canvases of their true size, no blur, crop or shift:
    the resample is the identity in both packages and the pipelines agree
    bit for bit up to CLAHE's output (its histograms and LUTs are exact)."""
    rs = np.random.RandomState(5)
    c = rs.randint(0, 256, (4, 64, 64)).astype(np.float32)
    hw = np.full((4, 2), 64, np.int32)
    flags = dict(denoise=False, remove_margin=False, center=False, normalize=False)
    ij, vj = jp.preprocess_batch_device(jnp.asarray(c), jnp.asarray(hw), **flags)
    it, vt = tp.preprocess_batch(_t(c), _t(hw), **flags)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


# -- the CLI -----------------------------------------------------------------------

def test_cli_preprocess_matches_jax_cli(tmp_path, monkeypatch):
    """``cli.preprocess --device cpu`` and the JAX CLI on one tree of raw
    scans (per-writer directories; blank pages, RGB scans, scans over the
    canvas; batch 4 with a padded tail): the same valid / invalid split and
    report, images within the whole-pipeline tolerance; JPEG, BMP and TIFF
    scans read as the JAX CLI reads them, a progressive JPEG whose scan
    script was cut (libjpeg smooths its unrefined coefficients) among them;
    a kind the port does not read yet (a WebP under a .tif name; a BigTIFF
    before A.6.7, now read among the others, an LZMA TIFF before A.6.13, a
    CCITT TIFF in tiles before A.6.16 and an LZMA TIFF of the ARM64 BCJ
    filter before A.6.25) is refused, naming ROADMAP A.6."""
    from siggan_tpu.cli import preprocess as jcli
    from siggan_tpu.core import platform as jplatform
    from siggan_tpu_torch.cli import preprocess as tcli
    monkeypatch.setattr(jplatform, "setup", lambda *a, **k: None)
    rs = np.random.RandomState(2)
    raw = tmp_path / "raw"
    for i in range(10):
        h, w = (150, 220) if i == 4 else rs.randint(40, 120, 2)
        page = rs.randint(215, 256, (h, w)).astype(np.uint8)
        if i not in (2, 7):
            for _ in range(60 if i == 4 else 12):
                y, x = rs.randint(4, h - 4), rs.randint(4, w - 20)
                page[y - 3:y + 3, x:x + 16] = rs.randint(0, 80)
        img = np.repeat(page[..., None], 3, -1) if i % 3 == 0 else page
        (raw / f"w{i % 3}").mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(raw / f"w{i % 3}" / f"w{i % 3}_{i:02d}.png")
    flags = ["--canvas_size", "128", "--batch_size", "4"]
    assert jcli.main(["--input_dir", str(raw), "--output_dir", str(tmp_path / "j")] + flags) == 0
    assert tcli.main(["--input_dir", str(raw), "--output_dir", str(tmp_path / "t"),
                      "--device", "cpu"] + flags) == 0
    want = json.loads((tmp_path / "j" / "preprocess_report.json").read_text())
    got = json.loads((tmp_path / "t" / "preprocess_report.json").read_text())
    assert got == want and len(got["invalid"]) == 2 and len(got["processed"]) == 8
    for name in got["processed"]:
        a = tdataset.decode_gray(tmp_path / "t" / name).astype(np.int64)
        b = np.asarray(Image.open(tmp_path / "j" / name)).astype(np.int64)
        d = np.abs(a - b)
        assert a.shape == (64, 64) and (d > 0).mean() <= 0.25 and d.max() <= 40
    other = tmp_path / "other"
    from test_torch_port_progressive import cut_scans, pil_jpeg
    for i, fmt in enumerate(("JPEG", "BMP", "TIFF", "cut", "BigTIFF")):
        page = rs.randint(215, 256, (90, 110)).astype(np.uint8)
        for _ in range(12):
            y, x = rs.randint(4, 86), rs.randint(4, 90)
            page[y - 3:y + 3, x:x + 16] = rs.randint(0, 80)
        (other / f"w{i}").mkdir(parents=True)
        if fmt == "cut":
            (other / f"w{i}" / f"w{i}_0.jpg").write_bytes(
                cut_scans(pil_jpeg(page, progressive=True), 3))
            continue
        if fmt == "BigTIFF":
            Image.fromarray(page).save(other / f"w{i}" / f"w{i}_0.tif", big_tiff=True)
            continue
        Image.fromarray(page).save(other / f"w{i}" / f"w{i}_0.{fmt.lower()}", fmt)
    assert jcli.main(["--input_dir", str(other), "--output_dir", str(tmp_path / "jo")] + flags) == 0
    assert tcli.main(["--input_dir", str(other), "--output_dir", str(tmp_path / "to"),
                      "--device", "cpu"] + flags) == 0
    want = json.loads((tmp_path / "jo" / "preprocess_report.json").read_text())
    assert json.loads((tmp_path / "to" / "preprocess_report.json").read_text()) == want
    assert len(want["processed"]) == 5
    for name in want["processed"]:
        path = next(other.rglob(name))
        np.testing.assert_array_equal(tcli.load_canvas(path, 64)[0], jcli.load_canvas(path, 64)[0])
    from test_torch_port_decode import webp_bytes
    (raw / "w1" / "scan.tif").write_bytes(webp_bytes())
    with pytest.raises(NotImplementedError, match="WebP.*ROADMAP A.6"):
        tcli.main(["--input_dir", str(raw), "--output_dir", str(tmp_path / "x"),
                   "--device", "cpu"])
