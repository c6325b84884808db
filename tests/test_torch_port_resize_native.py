"""The C++ host resize (``data/native/decode.cpp::sig_resize_bilinear``)
against Pillow's ``L``-mode bilinear and the port's numpy version
(``data/resample.py``), bit for bit, over sizes drawn by hypothesis: up
and down, 1 px sides, a side that keeps its size (its pass skipped), and
4000 px pages. The datasets and ``cli.preprocess`` resize through it, the
pixels they give are the JAX package's (so ``DECODE_VERSION`` stays d2),
and threads resize at once."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from siggan_tpu.cli.preprocess import load_canvas as j_load_canvas
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.cli.preprocess import load_canvas as t_load_canvas
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data import resample
from siggan_tpu_torch.data.native import loader as native
from siggan_tpu_torch.infer.export import encode_png

SETTINGS = dict(deadline=None, derandomize=True, database=None,
                suppress_health_check=[HealthCheck.too_slow])


def pil(a, w, h):
    return np.asarray(Image.fromarray(a).resize((w, h), Image.BILINEAR))


def image(seed, h, w):
    """Scan-like: a white page with dark strokes and grey noise."""
    rs = np.random.RandomState(seed)
    a = np.full((h, w), 245, np.uint8)
    a[rs.rand(h, w) < 0.05] = 20
    return np.clip(a.astype(int) + rs.randint(-10, 10, (h, w)), 0, 255).astype(np.uint8)


@settings(max_examples=60, **SETTINGS)
@given(h=st.integers(1, 300), w=st.integers(1, 300), oh=st.integers(1, 300),
       ow=st.integers(1, 300), seed=st.integers(0, 2 ** 16))
def test_resize_equals_pil_and_numpy(h, w, oh, ow, seed):
    a = image(seed, h, w)
    got = native.resize_bilinear(a, ow, oh)
    np.testing.assert_array_equal(got, pil(a, ow, oh))
    np.testing.assert_array_equal(got, resample.resize_bilinear(a, ow, oh))


@settings(max_examples=12, **SETTINGS)
@given(side=st.sampled_from(["w", "h", "both"]), n=st.integers(1, 90),
       keep=st.integers(1, 90), seed=st.integers(0, 2 ** 16))
def test_one_pixel_and_kept_sides(side, n, keep, seed):
    """1 px inputs and outputs, and a side that keeps its size."""
    shapes = {"w": ((keep, 1), (keep, n)), "h": ((1, keep), (n, keep)),
              "both": ((1, 1), (n, n))}
    (h, w), (oh, ow) = shapes[side]
    a = image(seed, h, w)
    for src, (dh, dw) in ((a, (oh, ow)), (image(seed + 1, oh, ow), (h, w))):
        np.testing.assert_array_equal(native.resize_bilinear(src, dw, dh),
                                      pil(src, dw, dh))


@settings(max_examples=4, **SETTINGS)
@given(w=st.integers(3000, 4000), h=st.integers(300, 1800), seed=st.integers(0, 2 ** 16))
def test_scan_pages_to_the_dataset_and_canvas_sizes(w, h, seed):
    """Pages up to 4000 px to 64 x 64 (the dataset) and to the 512 px
    canvas aspect kept (``cli.preprocess``), and a slight upscale."""
    a = image(seed, h, w)
    s = 512 / max(w, h)
    for ow, oh in ((64, 64), (max(1, int(w * s)), max(1, int(h * s))), (w + 7, h + 3)):
        got = native.resize_bilinear(a, ow, oh)
        np.testing.assert_array_equal(got, pil(a, ow, oh))
        if ow < 1000:
            np.testing.assert_array_equal(got, resample.resize_bilinear(a, ow, oh))


def test_strided_views_and_bad_sizes():
    a = image(1, 40, 60)
    view = a[::2, 5:50]
    np.testing.assert_array_equal(native.resize_bilinear(view, 17, 9),
                                  pil(np.ascontiguousarray(view), 17, 9))
    np.testing.assert_array_equal(native.resize_bilinear(a[:, ::3], 9, 9),
                                  pil(np.ascontiguousarray(a[:, ::3]), 9, 9))
    for w, h in ((0, 4), (4, 0)):
        with pytest.raises(ValueError, match="cannot resize"):
            native.resize_bilinear(a, w, h)
    with pytest.raises(ValueError, match=r"one \(H, W\) image"):
        native.resize_bilinear(a[..., None], 4, 4)


def test_dataset_and_canvas_pixels_stay_the_jax_packages(tmp_path, monkeypatch):
    """``decode_images`` (threads) and ``load_canvas`` resize in C++ and
    give the JAX package's PIL pixels, so the resize moved no pixel and
    needed no new cache version (d2 then; d3 since damaged JPEG data decodes
    as libjpeg-turbo decodes it, d4 since C.13's last repairs, d5 since
    damaged CCITT data decodes as libtiff decodes it, d6 since damaged ZSTD
    literals read as libzstd reads them, d7 since old-style JPEG-in-TIFF
    without its last strip's data reads as libtiff reads it, d8 since
    planar YCbCr old-style JPEG-in-TIFF, GIF and Netpbm read, d9 since BMP
    files read as PIL reads a pixel offset of 0 and its grey palettes, d10
    since old-style JPEG-in-TIFF headers skip as libtiff skips); the
    resize is the native one, not numpy's."""
    assert native.DECODE_VERSION == "d10"
    paths = []
    for i, (h, w) in enumerate(((500, 1200), (90, 210), (64, 64), (700, 300))):
        p = tmp_path / f"s{i}.png"
        p.write_bytes(encode_png(image(i, h, w)))
        paths.append(p)
    calls = []
    resize = native.resize_bilinear
    monkeypatch.setattr(native, "resize_bilinear",
                        lambda *a: calls.append(a[1:]) or resize(*a))
    got = tdataset.decode_images(paths, 64, n_threads=4)
    assert sorted(calls) == [(64, 64)] * 3
    want = np.stack([jdataset.decode_image(p, 64) for p in paths])
    np.testing.assert_array_equal(got, want)
    for p in paths:
        g, hw = t_load_canvas(p, 512)
        w_, whw = j_load_canvas(p, 512)
        np.testing.assert_array_equal(g, w_)
        assert tuple(hw) == tuple(whw)
    assert (512, 213) in calls


def test_threads_resize_at_once_and_agree():
    """Eight threads resizing pages at once (ctypes releases the interpreter
    lock) give each page's single-threaded result."""
    pages = [image(s, 500, 1200) for s in range(16)]
    want = [native.resize_bilinear(p, 64, 64) for p in pages]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda p: native.resize_bilinear(p, 64, 64), pages * 4))
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, want[i % 16])
