"""CMYK and YCCK JPEG and CMYK TIFF in the port's decoder against PIL,
through the JAX package.

PIL opens a four-component JPEG as CMYK and reads it as Adobe's inverted
"CMYK;I" whatever its markers say; libjpeg decodes the components as coded
where Adobe's transform is 0 (or there is no Adobe marker) and turns YCCK
(any other transform) into CMYK through its YCbCr tables. A CMYK TIFF is
read as it is, 8 or 16 bits (the high byte), with up to two extra samples,
in strips or tiles, uncompressed, PackBits, LZW (predictor 1 or 2), Deflate
or JPEG-in-TIFF (libtiff hands the components over as coded). PIL's
``convert("L")`` goes by way of its CMYK -> RGB. Everything here holds the
port bit-equal with PIL's grey (``decode_gray``, ``load_canvas``,
``decode_image``), and the datasets on a tree of these kinds equal the JAX
package's (its PIL path). PIL ignores InkSet and DotRange; so does the
port."""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import (FIXTURES, assert_port_reads_as_pil, jpeg_bytes, pixels,
                                    tiff_bytes, tiff_file)
from test_torch_port_progressive import progressive_bytes

from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu.verify import pairs as jpairs
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative
from siggan_tpu_torch.verify import pairs as tpairs


def adobe(transform: int) -> bytes:
    """An APP14 "Adobe" segment with the given colour transform."""
    body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    return b"\xff\xee" + struct.pack(">H", len(body) + 2) + body


def ycc_planes(cmyk: np.ndarray) -> np.ndarray:
    """The four planes a YCCK encoder codes (libjpeg's jccolor.c
    cmyk_ycck_convert): Y, Cb, Cr of (255 - C, 255 - M, 255 - Y), then K."""
    r, g, b = (255.0 - cmyk[..., i] for i in range(3))
    return np.dstack([0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128, cmyk[..., 3].astype(np.float64)])


def with_app14(data: bytes, transform) -> bytes:
    return data if transform is None else data[:2] + adobe(transform) + data[2:]


def ycck_bytes(cmyk: np.ndarray, sampling, quality: int, transform=2, script=None) -> bytes:
    """A baseline (or, with a scan ``script``, progressive) JPEG of uint8
    (H, W, 4) CMYK: YCCK with an Adobe marker of ``transform`` 1 or 2, the
    components as they are with transform 0 or None (no marker)."""
    planes = ycc_planes(cmyk) if transform else cmyk
    data = (jpeg_bytes(planes, sampling, quality) if script is None
            else progressive_bytes(planes, sampling, quality, script))
    return with_app14(data, transform)


def page(seed: int, h: int = 29, w: int = 37) -> np.ndarray:
    return np.asarray(Image.fromarray(pixels(np.random.RandomState(seed), (h, w, 3))
                                      .astype(np.uint8)).convert("CMYK"))


@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_pil_cmyk_jpeg_matches_pil(tmp_path, sub, progressive):
    """PIL's CMYK JPEGs (Adobe transform 0, inverted CMYK), baseline and
    progressive, of a page converted to CMYK and of random inks."""
    rs = np.random.RandomState(sub)
    for i, cmyk in enumerate((page(sub), rs.randint(0, 256, (23, 41, 4)).astype(np.uint8))):
        path = tmp_path / f"c{i}.jpg"
        Image.fromarray(cmyk, "CMYK").save(path, quality=85, subsampling=sub,
                                           progressive=progressive)
        assert b"Adobe" in path.read_bytes()
        assert_port_reads_as_pil(path)


SAMPLINGS = {"444": ((1, 1),) * 4, "420_k22": ((2, 2), (1, 1), (1, 1), (2, 2)),
             "422": ((2, 1), (1, 1), (1, 1), (1, 1))}


@pytest.mark.parametrize("transform", [0, 1, 2, None])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_written_ycck_and_cmyk_match_pil(tmp_path, transform, sampling):
    """Written files: YCCK (Adobe transform 1 or 2, which libjpeg takes as
    YCCK) and CMYK (transform 0, or no Adobe marker), baseline and
    progressive (an interleaved DC scan, then each component's ACs)."""
    cmyk = page(7)
    script = [((0, 1, 2, 3), 0, 0, 0, 0)] + [((c,), 1, 63, 0, 0) for c in range(4)]
    for prog in (None, script):
        path = tmp_path / f"w{prog is not None}.jpg"
        path.write_bytes(ycck_bytes(cmyk, SAMPLINGS[sampling], 80, transform, prog))
        assert_port_reads_as_pil(path)


def test_cmyk_progressive_smoothed_and_grey_like_cmyk(tmp_path):
    """A CMYK progressive script cut after its DC scans (libjpeg smooths
    all four components) and a grey page as CMYK (C = M = Y = 0)."""
    from test_torch_port_progressive import cut_scans
    cmyk = page(8, 40, 56)
    path = tmp_path / "cut.jpg"
    Image.fromarray(cmyk, "CMYK").save(path, quality=85, progressive=True)
    path.write_bytes(cut_scans(path.read_bytes(), 2))
    assert_port_reads_as_pil(path)
    grey = pixels(np.random.RandomState(9), (40, 56)).astype(np.uint8)
    Image.fromarray(grey).convert("CMYK").save(tmp_path / "g.jpg", quality=90)
    assert_port_reads_as_pil(tmp_path / "g.jpg")


@pytest.mark.parametrize("compression", [None, "packbits", "tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate", "jpeg", "lzw_predictor_2"])
def test_pil_cmyk_tiff_matches_pil(tmp_path, compression):
    cmyk = page(10, 33, 45)
    kw = ({"compression": "tiff_lzw", "tiffinfo": {317: 2}} if compression == "lzw_predictor_2"
          else {} if compression is None else {"compression": compression})
    path = tmp_path / "c.tif"
    Image.fromarray(cmyk, "CMYK").save(path, **kw)
    assert_port_reads_as_pil(path)


@pytest.mark.parametrize("kind", ["16_le", "16_be", "cmykx", "cmykxx", "tiles", "strips_be",
                                  "inkset_dotrange"])
def test_written_cmyk_tiff_matches_pil(tmp_path, kind):
    """What PIL does not write: 16-bit CMYK either way round, one or two
    extra samples (PIL's CMYKX, CMYKXX), tiles, big-endian strips, and the
    InkSet (2: not CMYK) and DotRange tags, which PIL ignores."""
    rs = np.random.RandomState(11)
    s = rs.randint(0, 256, (19, 27, 6))
    data = {"16_le": lambda: tiff_bytes(rs.randint(0, 65536, (19, 27, 4)), 16, 5),
            "16_be": lambda: tiff_bytes(rs.randint(0, 65536, (19, 27, 4)), 16, 5, be=True),
            "cmykx": lambda: tiff_bytes(s[..., :5], 8, 5, extra=[0]),
            "cmykxx": lambda: tiff_bytes(s, 8, 5, extra=[0, 0]),
            "tiles": lambda: tiff_bytes(s[..., :4], 8, 5, tile=(16, 16)),
            "strips_be": lambda: tiff_bytes(s[..., :4], 8, 5, rows_per_strip=4, be=True,
                                            packbits=True),
            "inkset_dotrange": lambda: tiff_file(27, 19, [s[..., :4].astype(np.uint8).tobytes()],
                                                 [(258, 3, [8] * 4), (259, 3, [1]), (262, 3, [5]),
                                                  (277, 3, [4]), (273, 4, None), (278, 4, [19]),
                                                  (279, 4, None), (332, 3, [2]),
                                                  (336, 3, [30, 220])])}[kind]()
    path = tmp_path / f"{kind}.tif"
    path.write_bytes(data)
    assert_port_reads_as_pil(path)


def test_cmyk_fixtures_and_datasets_match_jax(tmp_path, monkeypatch):
    """The committed CMYK, YCCK and CMYK TIFF fixtures read as PIL's grey;
    a tree of CMYK and YCCK scans builds in both packages' SignatureDataset
    and PairDataset with equal arrays (the JAX side on its PIL path)."""
    for name in ("cmyk.jpg", "ycck.jpg", "cmyk.tif"):
        assert_port_reads_as_pil(FIXTURES / name)
    monkeypatch.setattr(jnative, "available", lambda: False)
    for wi in range(2):
        d = tmp_path / "raw" / f"w{wi}"
        d.mkdir(parents=True)
        for k in range(3):
            cmyk = page(20 + 3 * wi + k, 30 + 5 * k, 44 - 3 * k)
            if k == 0:
                Image.fromarray(cmyk, "CMYK").save(d / f"w{wi}_{k}.jpg", quality=80)
            elif k == 1:
                (d / f"w{wi}_{k}.jpg").write_bytes(ycck_bytes(cmyk, SAMPLINGS["420_k22"], 80))
            else:
                Image.fromarray(cmyk, "CMYK").save(d / f"w{wi}_{k}.tif", compression="tiff_lzw")
    j = jdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    assert len(t) == 6 and t.images.std() > 0
    np.testing.assert_array_equal(t.images, j.images)
    jp = jpairs.PairDataset(tmp_path / "raw", pairs_per_user=3, image_size=32, seed=1)
    tp = tpairs.PairDataset(tmp_path / "raw", pairs_per_user=3, image_size=32, seed=1)
    np.testing.assert_array_equal(tp.img1, jp.img1)
    np.testing.assert_array_equal(tp.img2, jp.img2)


def test_cmyk_tiff_page_of_a_grey_page_is_that_grey():
    """``chip_smoke.tiff_cmyk``'s page (C = M = Y = 0, K = 255 - grey) reads,
    in PIL and in the port, as the grey it was written from: the card's
    CMYK TIFF page needs no golden array of its own."""
    import chip_smoke
    grey = pixels(np.random.RandomState(12), (37, 53)).astype(np.uint8)
    data = chip_smoke.tiff_cmyk(grey, 16)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "CMYK"
        np.testing.assert_array_equal(np.asarray(im.convert("L")), grey)
    np.testing.assert_array_equal(tnative.decode(data), grey)


def test_tiled_cmyk_page_is_the_tiled_grey():
    """``chip_smoke.tile_jpeg``'s CMYK page (restart intervals of cmyk.jpg,
    one MCU row each, side by side) reads in PIL and in the port as
    ``tile_golden`` gives it from cmyk.jpg's golden array."""
    import chip_smoke
    from test_torch_port_decode import load_golden
    page = chip_smoke.tile_jpeg((FIXTURES / "cmyk.jpg").read_bytes(), 600, 60,
                                chip_smoke.page_pick)
    want = chip_smoke.tile_golden(load_golden()["cmyk.jpg"], 600, 60, chip_smoke.page_pick)
    with Image.open(io.BytesIO(page)) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("L")), want)
    np.testing.assert_array_equal(tnative.decode(page), want)
