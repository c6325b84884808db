"""The port's PNG decoding in C++ (``data/native/decode.cpp``,
``sig_png_unfilter``): the row filters against a Python reference and
against the rows a test-local filter writer started from, every filter type
at 1 to 8 bytes a pixel; PIL-exact decodes of every PNG fixture and of a
scan-size page that PIL saved with its default adaptive filters; the
threaded ``decode_images`` against one-at-a-time decodes.

``python tests/test_torch_port_png_native.py --write-fixtures`` rewrites
the page and PIL's grey of it (needs PIL); ``--time`` prints the page's
decode time, through the C++ unfilter and through the Python reference.
"""

import os
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative
from siggan_tpu_torch.infer.export import decode_png
from test_torch_port_decode import FIXTURES, png_bytes, pil_gray

PAGE_DIR = FIXTURES / "png_page"
PAGE, PAGE_GREY = PAGE_DIR / "page.png", PAGE_DIR / "page_grey.npz"


# -- the test reference: the Python unfilter the C++ entry replaced -------------

def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def reference_unfilter(raw: bytes, pos: int, h: int, stride: int, bpp: int) -> np.ndarray:
    """Test reference only: the Python unfilter ``infer/export.py`` ran
    before the C++ entry (None, Sub and Up as numpy row operations, Average
    and Paeth byte by byte)."""
    if len(raw) < pos + h * (stride + 1):
        raise ValueError("PNG image data is too short")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1), pos).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        f, line = rows[r, 0], rows[r, 1:]
        if f > 4:
            raise ValueError(f"bad PNG filter type {f}")
        if f == 0:
            cur = line
        elif f == 1 and stride % bpp == 0:
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64) & 0xFF
                   ).astype(np.uint8).reshape(stride)
        elif f == 2:
            cur = line + prev
        else:
            vals, up_ = line.tolist(), prev.tolist()
            for i in range(stride):
                left = vals[i - bpp] if i >= bpp else 0
                if f == 1:
                    pred = left
                elif f == 3:
                    pred = (left + up_[i]) // 2
                else:
                    pred = _paeth(left, up_[i], up_[i - bpp] if i >= bpp else 0)
                vals[i] = (vals[i] + pred) & 0xFF
            cur = np.asarray(vals, np.uint8)
        out[r] = cur
        prev = out[r]
    return out


def filter_rows(rows: np.ndarray, filters, bpp: int) -> bytes:
    """(h, stride) uint8 rows -> PNG-filtered rows, filter ``filters[r]``
    on row r (a test-local writer)."""
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for row, f in zip(rows.astype(np.int64), filters):
        left = np.concatenate([np.zeros(bpp, np.int64), row])[:row.size]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev])[:row.size]
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        pred = (np.zeros_like(row), left, prev, (left + prev) // 2,
                np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft)))[f]
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


@pytest.mark.parametrize("bpp", range(1, 9))
@pytest.mark.parametrize("f", range(5))
def test_unfilter_undoes_each_filter(f, bpp):
    """Each filter type at each pixel size, on rows where the first row's
    zero neighbours and a ragged last pixel both occur; then a mix of all
    five filters."""
    rs = np.random.RandomState(10 * bpp + f)
    stride = 5 * bpp + (bpp > 1)           # a ragged tail when bpp > 1
    rows = rs.randint(0, 256, (7, stride)).astype(np.uint8)
    for filters in ([f] * 7, rs.randint(0, 5, 7)):
        raw = filter_rows(rows, filters, bpp)
        got = tnative.png_unfilter(np.frombuffer(raw, np.uint8), 0, 7, stride, bpp)
        np.testing.assert_array_equal(got, rows)
        np.testing.assert_array_equal(got, reference_unfilter(raw, 0, 7, stride, bpp))


def test_unfilter_refuses_bad_rows():
    raw = np.frombuffer(filter_rows(np.zeros((2, 4), np.uint8), [0, 2], 1), np.uint8)
    with pytest.raises(ValueError, match="too short"):
        tnative.png_unfilter(raw[:-1], 0, 2, 4, 1)
    bad = raw.copy()
    bad[5] = 5
    with pytest.raises(ValueError, match="bad PNG filter type 5"):
        tnative.png_unfilter(bad, 0, 2, 4, 1)
    np.testing.assert_array_equal(tnative.png_unfilter(raw, 0, 0, 4, 1), np.zeros((0, 4)))


@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("*.png")))
def test_png_fixtures_equal_pil(name):
    want = pil_gray(FIXTURES / name)
    np.testing.assert_array_equal(tdataset.decode_gray(FIXTURES / name), want)
    with np.load(FIXTURES / "golden.npz") as g:
        np.testing.assert_array_equal(g[name], want)


def test_pil_saved_scan_page_equals_pil():
    """The committed 1200 x 500 page (PIL's default adaptive filters: Sub,
    Up and Paeth rows) decodes to PIL's committed grey and to PIL's grey
    now, and its rows agree with the Python reference."""
    data = PAGE.read_bytes()
    assert len(data) < 100_000
    with np.load(PAGE_GREY) as f:
        want = f["grey"]
    assert want.shape == (500, 1200)
    np.testing.assert_array_equal(pil_gray(PAGE), want)
    np.testing.assert_array_equal(tdataset.decode_gray(PAGE), want)
    raw = zlib.decompress(b"".join(_chunks(data, b"IDAT")))
    assert {raw[r * 1201] for r in range(500)} >= {1, 2, 4}
    np.testing.assert_array_equal(
        tnative.png_unfilter(np.frombuffer(raw, np.uint8), 0, 500, 1200, 1),
        reference_unfilter(raw, 0, 500, 1200, 1))


def _chunks(data: bytes, tag: bytes):
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == tag:
            yield data[pos + 8:pos + 8 + n]
        pos += 12 + n


def test_threaded_decode_images_equals_one_at_a_time(tmp_path):
    """A PNG tree of many kinds (Adam7, 16-bit, palette, the page) decoded
    on 8 threads equals ``decode_image`` of each file, and a corrupt PNG
    becomes a zero image there too."""
    rs = np.random.RandomState(3)
    paths = []
    for i in range(24):
        kind = i % 4
        if kind == 0:
            data = png_bytes(rs.randint(0, 256, (30, 41, 1)), 0, 8, rs)
        elif kind == 1:
            data = png_bytes(rs.randint(0, 1 << 16, (23, 17, 1)), 0, 16, rs, interlace=True)
        elif kind == 2:
            data = png_bytes(rs.randint(0, 16, (19, 33, 1)), 3, 4, rs,
                             plte=rs.randint(0, 256, (16, 3)))
        else:
            data = PAGE.read_bytes()
        p = tmp_path / f"img_{i:02d}.png"
        p.write_bytes(data)
        paths.append(p)
    (tmp_path / "bad.png").write_bytes(PAGE.read_bytes()[:5000])
    paths.append(tmp_path / "bad.png")
    got = tdataset.decode_images(paths, 48, n_threads=8)
    want = np.stack([tdataset.decode_image(p, 48) for p in paths])
    np.testing.assert_array_equal(got, want)
    assert not want[-1].any()
    np.testing.assert_array_equal(tdataset.decode_images(paths, 48, n_threads=1), want)



@pytest.mark.parametrize("kind", ["small", "page"])
def test_pool_size_follows_the_files_pixels(kind, tmp_path, monkeypatch):
    """By default the PNG pool is one thread on small files (210 x 80, where
    one thread was measured faster than 8) and the decoder's thread count on
    scan-size pages; the images are the same either way."""
    if kind == "small":
        data = png_bytes(np.random.RandomState(4).randint(0, 256, (80, 210, 1)), 0, 8,
                         np.random.RandomState(5))
    else:
        data = PAGE.read_bytes()
    paths = []
    for i in range(3):
        paths.append(tmp_path / f"{i}.png")
        paths[-1].write_bytes(data)
    sizes = []
    real = tdataset.ThreadPoolExecutor
    monkeypatch.setattr(tdataset, "ThreadPoolExecutor",
                        lambda n: sizes.append(n) or real(n))
    got = tdataset.decode_images(paths, 32)
    threads = min(8, os.cpu_count() or 1)
    assert sizes == [1 if kind == "small" else threads]
    np.testing.assert_array_equal(got, tdataset.decode_images(paths, 32, n_threads=1))

# -- the committed page --------------------------------------------------------

def scan_page(seed: int = 0, h: int = 500, w: int = 1200) -> np.ndarray:
    """A grey signature scan: eight soft pen strokes (7 % ink) on paper lit
    unevenly (a horizontal gradient), with dark specks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ink = np.zeros((h, w), np.float32)
    for _ in range(8):
        t = np.linspace(0, 1, 4000)
        x0, x1 = rng.uniform(80, 400), rng.uniform(700, 1120)
        xs = x0 + (x1 - x0) * t + 30 * np.sin(2 * np.pi * rng.uniform(2, 6) * t
                                             + rng.uniform(0, 6))
        ys = (250 + rng.uniform(-120, 120) * np.sin(2 * np.pi * rng.uniform(1, 4) * t
                                                    + rng.uniform(0, 6))
              + rng.uniform(-60, 60))
        r = rng.uniform(2.0, 4.0)
        for x, y in zip(xs[::4], ys[::4]):
            ya, yb = max(int(y) - 6, 0), min(int(y) + 7, h)
            xa, xb = max(int(x) - 6, 0), min(int(x) + 7, w)
            d = np.hypot(xx[ya:yb, xa:xb] - x, yy[ya:yb, xa:xb] - y)
            ink[ya:yb, xa:xb] = np.maximum(ink[ya:yb, xa:xb], np.clip(r + 0.5 - d, 0, 1))
    paper = 236 + 14 * (xx / w) * (1 - 0.3 * yy / h)
    sy, sx = rng.integers(0, h, 400), rng.integers(0, w, 400)
    paper[sy, sx] -= rng.uniform(20, 90, 400)
    img = paper * (1 - ink) + (30 + rng.normal(0, 6, (h, w))) * ink
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def write_fixtures() -> None:
    PAGE_DIR.mkdir(parents=True, exist_ok=True)
    Image.fromarray(scan_page()).save(PAGE, "PNG")
    np.savez_compressed(PAGE_GREY, grey=pil_gray(PAGE))


def time_page(reps: int = 20) -> None:
    data = PAGE.read_bytes()
    raw = zlib.decompress(b"".join(_chunks(data, b"IDAT")))
    decode_png(data)
    t0 = time.perf_counter()
    for _ in range(reps):
        decode_png(data)
    port = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    reference_unfilter(raw, 0, 500, 1200, 1)
    ref = time.perf_counter() - t0
    with Image.open(PAGE) as im:
        im.convert("L")
    t0 = time.perf_counter()
    for _ in range(reps):
        with Image.open(PAGE) as im:
            im.convert("L")
    pil = (time.perf_counter() - t0) / reps
    print(f"page {PAGE.name} ({len(data)} bytes, 1200 x 500): decode_png {1e3 * port:.2f} ms "
          f"(C++ unfilter); the Python reference unfilter alone {1e3 * ref:.1f} ms; "
          f"PIL convert('L') {1e3 * pil:.2f} ms")


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--write-fixtures"]:
        write_fixtures()
    elif sys.argv[1:] == ["--time"]:
        time_page()
