"""The port's image decoders against PIL, through the JAX package.

PNG (``infer/export.py::decode_png``, in Python) and JPEG, BMP and TIFF
(``data/native/decode.cpp``, built with g++ at first use) against
``siggan_tpu/cli/preprocess.py::load_canvas`` (PIL's ``convert("L")`` at
the file's own size) and ``siggan_tpu.data.dataset.decode_image`` (with
PIL's bilinear resize): bit-equal, on images drawn by hypothesis and
written by PIL, or, for the kinds PIL does not write (PNG at 1/2/4/16
bits and Adam7, JPEG at 1x2 and 4x1 sampling, BMP at 16 bits, with
bitfields, RLE or an OS/2 header, TIFF tiles, big-endian and 16-bit files),
by small writers here, with PIL's reading as the reference. The datasets of
both packages agree on a mixed tree (the JAX native decoder switched off:
it differs from PIL by design, which ``tests/test_native_decoder.py``
bounds, and this file holds the port within that bound of it). A file PIL
reads, of a kind not read yet, raises ``NotImplementedError`` naming ROADMAP
A.6; a corrupt or unreadable file, or one PIL itself refuses
(``tests/test_torch_port_refusals.py``), becomes a zero image, with a
warning."""

import hashlib
import io
import logging
import math
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image, ImageFile

from siggan_tpu.cli.preprocess import load_canvas as j_load_canvas
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu.verify import pairs as jpairs
from siggan_tpu_torch.cli.preprocess import load_canvas as t_load_canvas
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative
from siggan_tpu_torch.ops.kernels import build
from siggan_tpu_torch.verify import pairs as tpairs

ImageFile.MAXBLOCK = 1 << 24     # PIL's optimize=True JPEG writer into memory
SETTINGS = dict(deadline=None, derandomize=True, database=None,
                suppress_health_check=[HealthCheck.function_scoped_fixture,
                                       HealthCheck.too_slow])


def pil_gray(path) -> np.ndarray:
    """The JAX package's grey at the file's own size (``load_canvas``)."""
    with Image.open(path) as im:
        w, h = im.size
    canvas, (hh, ww) = j_load_canvas(path, max(w, h))
    return canvas[:hh, :ww].astype(np.uint8)


def assert_port_reads_as_pil(path, size=24):
    want = pil_gray(path)
    got = tdataset.decode_gray(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    h, w = want.shape
    canvas = max(h, w)
    np.testing.assert_array_equal(t_load_canvas(path, canvas)[0], j_load_canvas(path, canvas)[0])
    np.testing.assert_array_equal(tdataset.decode_image(path, size),
                                  jdataset.decode_image(path, size))


def pixels(rs: np.random.RandomState, shape, levels=256) -> np.ndarray:
    """Stroke-like content: a smooth ramp, a few dark lines and noise."""
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = 200 + 40 * np.sin(x / 5.0) * np.cos(y / 3.0)
    base = base[..., None] if len(shape) == 3 else base
    img = base + rs.randn(*shape) * 40
    img[rs.rand(h) < 0.2] -= 150
    return np.clip(img * levels / 256.0, 0, levels - 1).astype(np.uint16)


# -- PNG ---------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _filter_rows(rows: np.ndarray, bpp: int, rs) -> bytes:
    """PNG filtering of (h, stride) uint8 rows, a random filter per row."""
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        f = rs.randint(5)
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) uint8 rows, big-endian, MSB first."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, rs, interlace=False,
              plte=None, trns=None) -> bytes:
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(_filter_rows(_pack(samples[y0::dy, x0::dx], depth), bpp, rs)
                       for x0, y0, dx, dy in _ADAM7 if w > x0 and h > y0)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, rs)
    body = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                             0, 0, int(interlace)))
    if plte is not None:
        body += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns)
    return body + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


PNG_KINDS = {
    # kind: (colour type, bit depth, interlace)
    "palette8": (3, 8, False), "palette4": (3, 4, False), "palette1": (3, 1, False),
    "grey_alpha8": (4, 8, False), "grey_alpha16": (4, 16, False),
    "grey1": (0, 1, False), "grey2": (0, 2, False), "grey4": (0, 4, False),
    "grey16": (0, 16, False), "rgb16": (2, 16, False), "rgba16": (6, 16, False),
    "adam7_grey8": (0, 8, True), "adam7_rgb8": (2, 8, True), "adam7_palette2": (3, 2, True),
    "adam7_grey16": (0, 16, True), "adam7_rgba8": (6, 8, True),
}


@pytest.mark.parametrize("kind", sorted(PNG_KINDS))
@settings(max_examples=6, **SETTINGS)
@given(h=st.integers(1, 21), w=st.integers(1, 21), seed=st.integers(0, 2 ** 16))
def test_png_kind_matches_pil(tmp_path, kind, h, w, seed):
    """Every PNG kind, bit-equal with PIL (the C.7 repair: palette and
    grey + alpha files were zero images before)."""
    ctype, depth, interlace = PNG_KINDS[kind]
    rs = np.random.RandomState(seed)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    plte = trns = None
    if ctype == 3:
        n = rs.randint(1, (1 << depth) + 1)
        plte = rs.randint(0, 256, (n, 3))
        samples = rs.randint(0, min(1 << depth, n + 2), (h, w, 1))   # past PLTE too
        trns = bytes(rs.randint(0, 256, min(n, 3)).astype(np.uint8))
    elif depth == 16:
        # Spread over the whole range, so that grey clamps and colour keeps its high byte.
        samples = rs.randint(0, 65536, (h, w, c)) // rs.choice([1, 200], (h, w, c))
    else:
        samples = pixels(rs, (h, w, c), 1 << depth)
    path = tmp_path / f"{kind}_{seed}.png"
    path.write_bytes(png_bytes(samples, ctype, depth, rs, interlace, plte, trns))
    assert_port_reads_as_pil(path)


# -- JPEG --------------------------------------------------------------------

_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                    48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                    22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                    47, 55, 62, 63])
_STD_BITS = {("dc", 0): [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
             ("ac", 0): [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]}
_STD_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778"
    "797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_STD_VALS = {("dc", 0): bytes(range(12)), ("ac", 0): _STD_AC_VALS}


def _codes(bits, vals):
    code, k, out = 0, 0, {}
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


def quantized_blocks(img: np.ndarray, sampling, quality: int, rgb_ids: bool = False):
    """The quantization table (natural order) and, per component, its
    quantized DCT blocks (block rows, block columns, 64 in natural order)
    over the MCU-padded plane, as a baseline or progressive encoder codes
    them. Three channels are RGB, coded as YCbCr unless ``rgb_ids``; four
    are coded as they are."""
    h, w = img.shape[:2]
    planes = [img.astype(np.float64)] if img.ndim == 2 else [img[..., i].astype(np.float64)
                                                            for i in range(img.shape[2])]
    if len(planes) == 3 and not rgb_ids:
        r, g, b = planes
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = math.ceil(w / (8 * hmax)), math.ceil(h / (8 * vmax))
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    base = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16,
                     24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109,
                     103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120,
                     101, 72, 92, 95, 98, 112, 100, 103, 99])
    q = np.clip((base * scale + 50) // 100, 1, 255)
    k = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    blocks = []
    for plane, (sh, sv) in zip(planes, sampling):
        fx, fy = hmax // sh, vmax // sv
        ph, pw = mcuy * sv * 8, mcux * sh * 8
        small = plane[::fy, ::fx]
        small = np.pad(small, ((0, max(0, ph - small.shape[0])), (0, max(0, pw - small.shape[1]))),
                       mode="edge")[:ph, :pw]
        b = (small - 128).reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = dct @ b @ dct.T
        blocks.append(np.round(coef.reshape(*coef.shape[:2], 64) / q).astype(np.int64))
    return q, blocks, (mcux, mcuy)


def jpeg_bytes(img: np.ndarray, sampling, quality: int, restart: int = 0,
               rgb_ids: bool = False) -> bytes:
    """A baseline JPEG of uint8 (H, W) or (H, W, 3) with any sampling
    factors (PIL writes only 1x1, 2x1 and 2x2): one quantization table, the
    standard luminance Huffman tables (K.3) for every component, and no DHT
    (libjpeg then installs those same tables). ``rgb_ids`` names the
    components 'R', 'G', 'B' and codes RGB as it is."""
    h, w = img.shape[:2]
    q, blocks, (mcux, mcuy) = quantized_blocks(img, sampling, quality, rgb_ids)
    dc_codes = _codes(_STD_BITS[("dc", 0)], _STD_VALS[("dc", 0)])
    ac_codes = _codes(_STD_BITS[("ac", 0)], _STD_VALS[("ac", 0)])
    out, acc, nacc = bytearray(), 0, 0

    def put(v, n):
        nonlocal acc, nacc
        acc, nacc = (acc << n) | (v & ((1 << n) - 1)), nacc + n
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nacc -= 8

    def flush():
        nonlocal nacc
        if nacc:
            put((1 << (8 - nacc)) - 1, 8 - nacc)

    def code(table, sym):
        put(*table[sym])

    def magnitude(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    preds = [0] * len(blocks)
    n_mcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n_mcu and n_mcu % restart == 0:
                flush()
                out += bytes([0xFF, 0xD0 + (n_mcu // restart - 1) % 8])
                preds = [0] * len(blocks)
            n_mcu += 1
            for ci, (sh, sv) in enumerate(sampling):
                for v in range(sv):
                    for hh in range(sh):
                        blk = blocks[ci][my * sv + v, mx * sh + hh][_ZIGZAG]
                        s, bits = magnitude(blk[0] - preds[ci])
                        preds[ci] = blk[0]
                        code(dc_codes, s)
                        if s:
                            put(bits, s)
                        run = 0
                        for a in blk[1:]:
                            if a == 0:
                                run += 1
                                continue
                            while run > 15:
                                code(ac_codes, 0xF0)
                                run -= 16
                            s, bits = magnitude(a)
                            code(ac_codes, (run << 4) | s)
                            put(bits, s)
                            run = 0
                        if run:
                            code(ac_codes, 0)
    flush()
    ids = [ord("R"), ord("G"), ord("B")] if rgb_ids else [1, 2, 3, 4]
    sof = struct.pack(">BHHB", 8, h, w, len(blocks)) + b"".join(
        bytes([ids[i], (sh << 4) | sv, 0]) for i, (sh, sv) in enumerate(sampling))
    sos = bytes([len(blocks)]) + b"".join(bytes([ids[i], 0]) for i in range(len(blocks))) \
        + bytes([0, 63, 0])

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body
    head = (b"\xff\xd8" + seg(0xDB, bytes([0]) + q[_ZIGZAG].astype(np.uint8).tobytes())
            + seg(0xC0, sof))
    if restart:
        head += seg(0xDD, struct.pack(">H", restart))
    return head + seg(0xDA, sos) + bytes(out) + b"\xff\xd9"


@settings(max_examples=40, **SETTINGS)
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(30, 100),
       sub=st.sampled_from(["grey", 0, 1, 2]), restart=st.sampled_from([0, 1, 3]),
       optimize=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_pil_jpeg_matches_pil(tmp_path, h, w, quality, sub, restart, optimize, seed):
    """PIL-written JPEGs: grey, 4:4:4, 4:2:2 and 4:2:0, quality 30-100, with
    and without restart intervals and optimised Huffman tables, odd sizes."""
    rs = np.random.RandomState(seed)
    img = pixels(rs, (h, w) if sub == "grey" else (h, w, 3)).astype(np.uint8)
    kw = dict(quality=quality, optimize=optimize, restart_marker_blocks=restart)
    if sub != "grey":
        kw["subsampling"] = sub
    path = tmp_path / "a.jpg"
    Image.fromarray(img).save(path, "JPEG", **kw)
    assert_port_reads_as_pil(path)


@settings(max_examples=30, **SETTINGS)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(30, 100),
       sampling=st.sampled_from([((1, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1)),
                                 ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)),
                                 ((1, 1), (1, 1), (1, 1)), ((2, 2), (2, 1), (1, 2)),
                                 ((1, 1),)]),
       restart=st.sampled_from([0, 2]), rgb_ids=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_written_jpeg_samplings_match_pil(tmp_path, h, w, quality, sampling, restart,
                                          rgb_ids, seed):
    """Every sampling of libjpeg's upsampler (h1v2 fancy, box replication
    for 4x1 and mixed factors, h2v1/h2v2 at widths of 1-2 pixels), the
    default Huffman tables (no DHT segment), RGB by component ids."""
    rs = np.random.RandomState(seed)
    img = pixels(rs, (h, w) if len(sampling) == 1 else (h, w, 3)).astype(np.uint8)
    path = tmp_path / "b.jpeg"
    path.write_bytes(jpeg_bytes(img, sampling, quality, restart, rgb_ids and len(sampling) == 3))
    assert_port_reads_as_pil(path)


def test_scan_sized_jpegs_match_pil(tmp_path):
    """A 1200 x 500 scan at each PIL sampling."""
    rs = np.random.RandomState(0)
    img = pixels(rs, (500, 1200, 3)).astype(np.uint8)
    for sub in (0, 1, 2):
        path = tmp_path / f"scan{sub}.jpg"
        Image.fromarray(img).save(path, quality=90, subsampling=sub)
        np.testing.assert_array_equal(tdataset.decode_gray(path), pil_gray(path))


# -- BMP ---------------------------------------------------------------------

def bmp_bytes(rows: list, w: int, h: int, bits: int, *, palette=None, compression=0,
              masks=None, header=40, top_down=False, raw=None) -> bytes:
    """A BMP of ``rows`` (top row first, each already packed to ``bits``),
    or of ``raw`` pixel data as it is (RLE)."""
    if raw is None:
        stride = ((w * bits + 31) >> 3) & ~3
        stored = rows if top_down else rows[::-1]
        raw = b"".join(r + b"\0" * (stride - len(r)) for r in stored)
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if header == 12 else b"\0")
                       for r, g, b in palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(raw), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        extra = b""
        if masks is not None:
            extra = struct.pack("<" + "I" * len(masks), *masks)
        if header == 40:
            info += extra
        else:
            info += (extra + b"\0" * header)[:header - 40]
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(raw), 0, 0, offset) + info + pal + raw)


def _pack_row(vals, bits):
    return _pack(np.asarray(vals)[None, :, None], bits)[0].tobytes()


def _rle(index_rows, rle4, rs) -> bytes:
    """RLE8/RLE4 data of ``index_rows`` (stored bottom-up): encoded runs and
    absolute runs (even lengths for RLE4, as PIL reads them), an
    end-of-line per row and the end-of-bitmap."""
    out = bytearray()
    for row in index_rows[::-1]:
        x = 0
        while x < len(row):
            n = min(len(row) - x, rs.randint(1, 9))
            if rs.rand() < 0.4 and n >= 4 and (not rle4 or n % 2 == 0):
                seg = row[x:x + n]
                out += bytes([0, n])
                data = (bytes((seg[i] << 4) | seg[i + 1] for i in range(0, n, 2)) if rle4
                        else bytes(seg))
                out += data
                if len(data) % 2:
                    out.append(0)
            else:
                n = 1 if rle4 else n
                out += bytes([n, (row[x] << 4) | row[x] if rle4 else row[x]])
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


BMP_KINDS = ["pil_1", "pil_8", "pil_24", "pil_32", "pal4", "pal8_short", "rgb555", "rgb565",
             "bitfields555", "bitfields32_bgra", "bitfields32_rgba", "rle8", "rle4", "os2_8",
             "top_down_24", "v5_bitfields565"]


@pytest.mark.parametrize("kind", BMP_KINDS)
@settings(max_examples=5, **SETTINGS)
@given(h=st.integers(1, 19), w=st.integers(1, 19), seed=st.integers(0, 2 ** 16))
def test_bmp_kind_matches_pil(tmp_path, kind, h, w, seed):
    rs = np.random.RandomState(seed)
    path = tmp_path / f"{kind}.bmp"
    rgb = pixels(rs, (h, w, 3)).astype(np.uint8)
    if kind.startswith("pil_"):
        im = {"pil_1": Image.fromarray(rgb[..., 0] > 128), "pil_8": Image.fromarray(rgb).quantize(40),
              "pil_24": Image.fromarray(rgb),
              "pil_32": Image.fromarray(np.dstack([rgb, rgb[..., :1]]))}[kind]
        im.save(path, "BMP")
    elif kind in ("pal4", "pal8_short", "os2_8", "rle8", "rle4"):
        bits = 4 if kind in ("pal4", "rle4") else 8
        n = 16 if bits == 4 else (12 if kind == "pal8_short" else 256)
        palette = [tuple(rs.randint(0, 256, 3)) for _ in range(n)]
        idx = rs.randint(0, 16 if bits == 4 else 256, (h, w))    # past a short palette too
        if kind.startswith("rle"):
            data = bmp_bytes([], w, h, bits, palette=palette, compression=1 if bits == 8 else 2,
                             raw=_rle(idx.tolist(), bits == 4, rs))
        else:
            data = bmp_bytes([_pack_row(r, bits) for r in idx], w, h, bits, palette=palette,
                             header=12 if kind == "os2_8" else 40)
        path.write_bytes(data)
    elif kind in ("rgb555", "rgb565", "bitfields555", "v5_bitfields565"):
        v = rs.randint(0, 65536, (h, w)).astype("<u2")
        masks = {"rgb565": (0xF800, 0x7E0, 0x1F), "v5_bitfields565": (0xF800, 0x7E0, 0x1F, 0),
                 "bitfields555": (0x7C00, 0x3E0, 0x1F)}.get(kind)
        path.write_bytes(bmp_bytes([r.tobytes() for r in v], w, h, 16,
                                   compression=0 if kind == "rgb555" else 3, masks=masks,
                                   header=124 if kind.startswith("v5") else 40))
    elif kind.startswith("bitfields32"):
        px = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
        masks = ((0xFF0000, 0xFF00, 0xFF, 0xFF000000) if kind.endswith("bgra")
                 else (0xFF, 0xFF00, 0xFF0000, 0xFF000000))
        path.write_bytes(bmp_bytes([r.tobytes() for r in px], w, h, 32, compression=3,
                                   masks=masks, header=108))
    else:   # top_down_24
        path.write_bytes(bmp_bytes([r[:, ::-1].tobytes() for r in rgb], w, h, 24, top_down=True))
    assert_port_reads_as_pil(path)


# -- TIFF --------------------------------------------------------------------

def _packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = min(len(data), i + 128)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_file(w: int, h: int, blobs, tags, be: bool = False) -> bytes:
    """A one-page TIFF: ``blobs`` (strips or tiles) and IFD ``tags``, a list
    of (tag, type, values) where type 7 takes bytes; the offsets tag (273 or
    324) gets the blobs' positions and the byte-count tag (279 or 325) their
    sizes when its values are None."""
    o = ">" if be else "<"
    data = bytearray(struct.pack(o + "2sHI", b"MM" if be else b"II", 42, 0))
    offsets = []
    for b in blobs:
        offsets.append(len(data))
        data += b
    entries = [(256, 4, [w]), (257, 4, [h])]
    for tag, typ, vals in tags:
        if tag in (273, 324):
            vals = offsets
        elif tag in (279, 325) and vals is None:
            vals = [len(b) for b in blobs]
        entries.append((tag, typ, vals))
    entries.sort(key=lambda e: e[0])
    data += b"\0" * (len(data) & 1)
    ifd_at = len(data)
    struct.pack_into(o + "I", data, 4, ifd_at)
    base, tail = ifd_at + 2 + 12 * len(entries) + 4, bytearray()
    ifd = bytearray(struct.pack(o + "H", len(entries)))
    for tag, typ, vals in entries:
        raw = (bytes(vals) if typ == 7 else
               struct.pack(o + {3: "H", 4: "I"}[typ] * len(vals), *[int(v) for v in vals]))
        if len(raw) <= 4:
            ifd += struct.pack(o + "HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(o + "HHII", tag, typ, len(vals), base + len(tail))
            tail += raw + b"\0" * (len(raw) & 1)
    return bytes(data + ifd + struct.pack(o + "I", 0) + tail)


def chunks_of(samples: np.ndarray, tile=None, rows_per_strip=None):
    """Strips (cut at the image's foot) or tiles (padded with zeros)."""
    h, w = samples.shape[:2]
    if tile:
        tw, th = tile
        padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw) + samples.shape[2:], samples.dtype)
        padded[:h, :w] = samples
        return [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    rps = rows_per_strip or h
    return [samples[y:y + rps] for y in range(0, h, rps)]


def layout_tags(tile=None, rows_per_strip=None, h=0):
    if tile:
        return [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, None), (325, 4, None)]
    return [(273, 4, None), (278, 4, [rows_per_strip or h]), (279, 4, None)]


def tiff_bytes(samples: np.ndarray, bits: int, photometric: int, *, be=False, tile=None,
               rows_per_strip=None, packbits=False, colormap=None, extra=None) -> bytes:
    """A one-page TIFF of (h, w, spp) samples, in strips or (padded) tiles."""
    h, w, spp = samples.shape

    def pack(c):
        if bits == 16:
            return c.reshape(c.shape[0], -1).astype((">" if be else "<") + "u2").tobytes()
        return _pack(c, bits).tobytes()
    blobs = [pack(c) for c in chunks_of(samples, tile, rows_per_strip)]
    if packbits:
        blobs = [_packbits(b) for b in blobs]
    tags = [(258, 3, [bits] * spp), (259, 3, [32773 if packbits else 1]),
            (262, 3, [photometric]), (277, 3, [spp])] + layout_tags(tile, rows_per_strip, h)
    if colormap is not None:
        tags.append((320, 3, list(colormap.T.reshape(-1))))
    if extra is not None:
        tags.append((338, 3, extra))
    return tiff_file(w, h, blobs, tags, be)


TIFF_KINDS = ["pil_raw_L", "pil_packbits_RGB", "pil_lzw_L", "pil_lzw_pred2_RGB",
              "pil_lzw_pred2_L", "pil_raw_1", "pil_raw_RGBA", "pil_lzw_LA", "pil_P",
              "pil_I16", "white_is_zero_1", "white_is_zero_8", "grey4_be", "palette4_tiles",
              "grey16_be", "rgb16_tiles", "rgb_tiles_packbits", "rgbx_strips"]


@pytest.mark.parametrize("kind", TIFF_KINDS)
@settings(max_examples=4, **SETTINGS)
@given(h=st.integers(1, 37), w=st.integers(1, 37), seed=st.integers(0, 2 ** 16))
def test_tiff_kind_matches_pil(tmp_path, kind, h, w, seed):
    rs = np.random.RandomState(seed)
    path = tmp_path / f"{kind}.tif"
    rgb = pixels(rs, (h, w, 3)).astype(np.uint8)
    grey = rgb[..., 0]
    if kind.startswith("pil_"):
        comp = {"raw": None, "packbits": "packbits", "lzw": "tiff_lzw"}.get(kind.split("_")[1])
        kw = {} if comp is None else {"compression": comp}
        if "pred2" in kind:
            kw["tiffinfo"] = {317: 2}
        mode = kind.rsplit("_", 1)[1]
        im = {"L": Image.fromarray(grey), "RGB": Image.fromarray(rgb),
              "RGBA": Image.fromarray(np.dstack([rgb, grey])), "1": Image.fromarray(grey > 128),
              "LA": Image.fromarray(np.dstack([grey, rgb[..., 1]])),
              "P": Image.fromarray(rgb).quantize(60),
              "I16": Image.fromarray(rs.randint(0, 700, (h, w)).astype(np.uint16))}[mode]
        im.save(path, "TIFF", **kw)
    elif kind.startswith("white_is_zero"):
        bits = int(kind.rsplit("_", 1)[1])
        s = rs.randint(0, 1 << bits, (h, w, 1))
        path.write_bytes(tiff_bytes(s, bits, 0, rows_per_strip=max(1, h // 3)))
    elif kind == "grey4_be":
        path.write_bytes(tiff_bytes(rs.randint(0, 16, (h, w, 1)), 4, 1, be=True,
                                    rows_per_strip=2, packbits=True))
    elif kind == "palette4_tiles":
        cmap = rs.randint(0, 65536, (16, 3))
        path.write_bytes(tiff_bytes(rs.randint(0, 16, (h, w, 1)), 4, 3, tile=(16, 16),
                                    colormap=cmap))
    elif kind == "grey16_be":
        s = rs.randint(0, 65536, (h, w, 1)) // rs.choice([1, 300], (h, w, 1))
        path.write_bytes(tiff_bytes(s, 16, 1, be=True, rows_per_strip=3))
    elif kind == "rgb16_tiles":
        path.write_bytes(tiff_bytes(rs.randint(0, 65536, (h, w, 3)), 16, 2, tile=(16, 32)))
    elif kind == "rgb_tiles_packbits":
        path.write_bytes(tiff_bytes(rgb, 8, 2, tile=(32, 16), packbits=True, be=True))
    else:   # rgbx_strips
        path.write_bytes(tiff_bytes(np.dstack([rgb, grey]), 8, 2, rows_per_strip=5, extra=[0]))
    assert_port_reads_as_pil(path)


# -- dispatch, faults, datasets ------------------------------------------------

def test_format_comes_from_content_not_suffix(tmp_path):
    rs = np.random.RandomState(3)
    img = pixels(rs, (20, 30, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "png_inside.jpg", "PNG")
    Image.fromarray(img).save(tmp_path / "jpeg_inside.png", "JPEG", quality=85)
    Image.fromarray(img).save(tmp_path / "bmp_inside.tif", "BMP")
    Image.fromarray(img).save(tmp_path / "tiff_inside.bmp", "TIFF")
    for name in ("png_inside.jpg", "jpeg_inside.png", "bmp_inside.tif", "tiff_inside.bmp"):
        assert_port_reads_as_pil(tmp_path / name)


def webp_bytes(seed: int = 3) -> bytes:
    """PIL's WebP of a small grey scan, which the port reads since
    A.6.30-A.6.32 whatever the file's name."""
    buf = io.BytesIO()
    Image.fromarray(pixels(np.random.RandomState(seed), (24, 40)).astype(np.uint8)).save(buf, "WEBP")
    return buf.getvalue()


def unread_bytes() -> bytes:
    """An AVIF (``chip_smoke.c21_files``): a format PIL reads and the port
    does not yet (ROADMAP A.6), whatever the file's name."""
    import chip_smoke
    return chip_smoke.c21_files()["AVIF"]


def _unsupported_files(tmp_path):
    avif = unread_bytes()
    (tmp_path / "avif_named.tif").write_bytes(avif)
    (tmp_path / "avif_named.png").write_bytes(avif)
    return {"avif_named.tif": "AVIF", "avif_named.png": "AVIF"}


def _now_read_files(root):
    """The kinds this test held as unread before A.6.7-A.6.10: CCITT with
    FillOrder 2, BigTIFF, planar RGB; before A.6.13-A.6.14: LZMA and ZSTD;
    before A.6.15-A.6.16: CCITT in uncompressed mode (T.4, T.6) and in
    tiles; before A.6.25: LZMA with the ARM64 and RISC-V BCJ filters;
    before A.6.30-A.6.32: WebP under a .tif and a .png name; before
    A.6.37: an ICO under a .tif and a .png name."""
    (root / "webp_named.tif").write_bytes(webp_bytes(3))
    (root / "webp_named.png").write_bytes(webp_bytes(4))
    import chip_smoke
    (root / "ico_named.tif").write_bytes(chip_smoke.c21_files()["ICO"])
    (root / "ico_named.png").write_bytes(chip_smoke.c21_files()["ICO"])
    from test_torch_port_tiff_lzma_zstd import bcj_filter_tiff
    (root / "arm64_bcj.tif").write_bytes(bcj_filter_tiff(0x0A))
    (root / "riscv_bcj.tif").write_bytes(bcj_filter_tiff(0x0B))
    rs = np.random.RandomState(4)
    img = pixels(rs, (24, 40, 3)).astype(np.uint8)
    from test_torch_port_ccitt import refused_files
    refused = refused_files()[0]
    for name in ("t4_uncompressed", "t6_uncompressed", "tiles"):
        (root / f"ccitt_{name}.tif").write_bytes(refused[name][0])
    Image.fromarray(img).save(root / "lzma.tif", compression="lzma")
    Image.fromarray(img).save(root / "zstd.tif", compression="zstd")
    from test_torch_port_ccitt import ccitt_bytes, strips, wrap
    # Group 4 with FillOrder 2: each byte's bits reversed.
    rev = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
    (strip,) = strips(ccitt_bytes(img[..., 0] > 128, "t6"))
    (root / "fill_order_2.tif").write_bytes(
        wrap(40, 24, [strip.translate(rev)], 4, extra=[(266, 3, 2)]))
    Image.fromarray(img).save(root / "big.tiff", big_tiff=True)
    (root / "planar.tif").write_bytes(tiff_file(
        40, 24, [img.transpose(2, 0, 1).tobytes()],
        [(258, 3, [8] * 3), (259, 3, [1]), (262, 3, [2]), (277, 3, [3]), (284, 3, [2]),
         (273, 4, None), (278, 4, [24]), (279, 4, None)]))


def test_unsupported_file_raises_instead_of_a_zero_image(tmp_path):
    """PIL reads these, so a zero image would be wrong: the port raises
    NotImplementedError naming the feature and ROADMAP A.6 (an AVIF, under a
    .tif and a .png name). The kinds this test named before the port read
    them (a cut progressive scan script, CMYK TIFF and JPEG; since
    A.6.7-A.6.10 CCITT with FillOrder 2, BigTIFF, planar RGB; since
    A.6.13-A.6.14 LZMA and ZSTD TIFF; since A.6.15-A.6.16 CCITT in
    uncompressed mode and in tiles; since A.6.25 LZMA TIFF of the ARM64
    and RISC-V BCJ filters; since A.6.30-A.6.32 WebP; since A.6.37 ICO,
    this test's unread kind before) now read bit-equal with PIL."""
    for name, feature in _unsupported_files(tmp_path).items():
        assert jdataset.decode_image(tmp_path / name, 16).std() > 0     # PIL reads it
        with pytest.raises(NotImplementedError, match=f"{feature}.*ROADMAP A.6"):
            tdataset.decode_image(tmp_path / name, 16)
        with pytest.raises(NotImplementedError, match="A.6"):
            tdataset.SignatureDataset(tmp_path, 16, use_cache=False)
    img = pixels(np.random.RandomState(4), (24, 40, 3)).astype(np.uint8)
    from test_torch_port_progressive import cut_scans, pil_jpeg
    read = tmp_path / "read"
    read.mkdir()
    (read / "cut_script.jpg").write_bytes(
        cut_scans(pil_jpeg(img, quality=80, progressive=True), 6))
    Image.fromarray(img).convert("CMYK").save(read / "cmyk.tiff", compression="tiff_deflate")
    Image.fromarray(img).convert("CMYK").save(read / "cmyk.jpg")
    _now_read_files(read)
    for name in ("cut_script.jpg", "cmyk.tiff", "cmyk.jpg", "fill_order_2.tif", "big.tiff",
                 "planar.tif", "lzma.tif", "zstd.tif", "ccitt_t4_uncompressed.tif",
                 "ccitt_t6_uncompressed.tif", "ccitt_tiles.tif", "arm64_bcj.tif", "riscv_bcj.tif",
                 "webp_named.tif", "webp_named.png", "ico_named.tif", "ico_named.png"):
        assert_port_reads_as_pil(read / name)


@pytest.mark.parametrize("name,keep", [("cut.jpg", 300), ("cut.png", 60), ("cut.bmp", 70),
                                       ("cut.tif", 40), ("empty.jpg", 0), ("junk.png", None),
                                       ("cut_progressive.jpg", 900)])
def test_corrupt_file_becomes_a_zero_image_with_a_warning(tmp_path, caplog, name, keep):
    rs = np.random.RandomState(5)
    img = pixels(rs, (30, 30, 3)).astype(np.uint8)
    fmt = {"jpg": "JPEG", "png": "PNG", "bmp": "BMP", "tif": "TIFF"}[name.split(".")[1]]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **({"progressive": True} if "progressive" in name else {}))
    data = buf.getvalue()[:keep] if keep is not None else b"not an image at all"
    (tmp_path / name).write_bytes(data)
    assert not jdataset.decode_image(tmp_path / name, 16).any()
    with caplog.at_level(logging.WARNING):
        out = tdataset.decode_image(tmp_path / name, 16)
    assert out.shape == (16, 16, 1) and not out.any()
    assert "using zero image" in caplog.text
    with pytest.raises(ValueError):
        tdataset.decode_gray(tmp_path / name)


def mixed_tree(root, rs):
    """Two writers' folders of PNG, JPEG, BMP and TIFF scans of mixed sizes."""
    for wi in range(2):
        d = root / f"writer{wi}"
        d.mkdir(parents=True)
        for k, (ext, fmt) in enumerate([(".png", "PNG"), (".jpg", "JPEG"), (".bmp", "BMP"),
                                        (".tif", "TIFF"), (".jpeg", "JPEG"), (".TIFF", "TIFF")]):
            img = pixels(rs, (30 + 7 * k, 50 - 3 * k, 3)).astype(np.uint8)
            im = Image.fromarray(img if k % 2 else img[..., 0])
            kw = {"quality": 90} if fmt == "JPEG" else ({"compression": "tiff_lzw"} if k == 3
                                                       else {})
            im.save(d / f"w{wi}_{k}{ext}", fmt, **kw)


def test_datasets_match_jax_on_a_mixed_tree(tmp_path, monkeypatch):
    """SignatureDataset and the verifier's PairDataset, bit-equal with the
    JAX package's PIL path (its native decoder off: see the module doc)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    mixed_tree(tmp_path / "raw", np.random.RandomState(6))
    j = jdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 12
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.writer_labels()[0], j.writer_labels()[0])
    jp = jpairs.PairDataset(tmp_path / "raw", pairs_per_user=4, image_size=32, seed=1)
    tp = tpairs.PairDataset(tmp_path / "raw", pairs_per_user=4, image_size=32, seed=1)
    assert [(a.name, b.name, l) for a, b, l in tp.pairs] == \
        [(a.name, b.name, l) for a, b, l in jp.pairs]
    np.testing.assert_array_equal(tp.img1, jp.img1)
    np.testing.assert_array_equal(tp.img2, jp.img2)


def test_within_the_jax_native_decoders_bound(tmp_path):
    """On 8-bit files the port (PIL-exact) stays within the bound
    ``tests/test_native_decoder.py`` gives the JAX native decoder against
    PIL: 1 level for PNG, 2 for JPEG, mean under 0.5."""
    if not jnative.available():
        pytest.skip("the JAX package's native decoder needs libpng and libjpeg")
    rs = np.random.RandomState(7)
    for i, (ext, size) in enumerate([(".png", (80, 120)), (".jpg", (90, 110)),
                                     (".png", (200, 150)), (".jpg", (64, 64))]):
        path = tmp_path / f"x{i}{ext}"
        Image.fromarray(pixels(rs, size + ((3,) if i % 2 else ())).astype(np.uint8)).save(
            path, quality=95) if ext == ".jpg" else Image.fromarray(
            pixels(rs, size).astype(np.uint8)).save(path)
        ours = np.round((tdataset.decode_image(path, 64)[..., 0] + 1) * 127.5).astype(int)
        theirs = jnative.decode_one(path, 64).astype(int)
        diff = np.abs(ours - theirs)
        assert diff.max() <= (2 if ext == ".jpg" else 1) and diff.mean() < 0.5, (path, diff.max())


def test_threaded_batch_equals_single_decodes(tmp_path):
    mixed_tree(tmp_path, np.random.RandomState(8))
    paths = sorted(tdataset.list_images(tmp_path))
    (tmp_path / "corrupt.jpg").write_bytes(b"\xff\xd8\xff\xe0 too short")
    paths += [tmp_path / "corrupt.jpg", tmp_path / "missing.bmp"]
    for threads in (1, 4):
        grays, status, msgs, _ = tnative.decode_files(paths, threads)
        for p, g, s in zip(paths[:-2], grays, status):
            if p.suffix == ".png":
                assert s == tnative.PNG and g is None
            else:
                assert s == tnative.OK
                np.testing.assert_array_equal(g, tdataset.decode_gray(p))
        assert list(status[-2:]) == [tnative.CORRUPT, tnative.UNREADABLE]
        assert "JPEG" in msgs[-2] and "open" in msgs[-1]
    out = tdataset.decode_images(paths[:-2], 20)
    np.testing.assert_array_equal(out, np.stack([tdataset.decode_image(p, 20)
                                                 for p in paths[:-2]]))


def test_host_build_names_a_missing_compiler(tmp_path, monkeypatch):
    """No g++, no decoder: the build raises naming the compiler (there is
    no Python decoder to fall back on)."""
    src = tmp_path / "decode_copy.cpp"
    src.write_bytes(tnative.SOURCE.read_bytes() + b"\n// copy\n")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.load_host([src], {})
    assert build.host_library_path([src]).name.startswith("libdecode_copy_")


# -- the card's fixtures -------------------------------------------------------

FIXTURES = Path(__file__).parent / "data" / "torch_port"


def scan_page(rs, h: int, w: int, rgb: bool = False) -> np.ndarray:
    """A signature-like scan: paper with light specks and dark pen strokes."""
    page = np.full((h, w), 245.0)
    k = h * w // 400
    page[rs.randint(0, h, k), rs.randint(0, w, k)] = rs.uniform(180, 235, k)
    for _ in range(6):
        y, x = rs.uniform(0.2, 0.8) * h, rs.uniform(0.1, 0.3) * w
        for _ in range(int(w * 0.6)):
            y = np.clip(y + rs.randn() * 1.5, 3, h - 4)
            x = min(x + rs.uniform(0.2, 1.2), w - 4)
            r = rs.randint(1, 3)
            page[int(y) - r:int(y) + r, int(x) - r:int(x) + r] = rs.uniform(10, 60)
    page = np.clip(page, 0, 255).astype(np.uint8)
    if rgb:
        tint = np.array([1.0, 0.97, 1.02])
        return np.clip(page[..., None] * tint, 0, 255).astype(np.uint8)
    return page


def write_fixtures(out: Path = FIXTURES) -> dict:
    """The decoder fixtures ``chip_smoke.py`` holds the card's build to
    (written with PIL, and by this file's writers where PIL writes no such
    file), and ``golden.npz``: PIL's grey of each. Regenerate with
    ``python tests/test_torch_port_decode.py --write-fixtures``."""
    rs = np.random.RandomState(2024)
    out.mkdir(parents=True, exist_ok=True)
    for old in out.iterdir():
        if old.is_file():        # png_page/ and jax_run/ have writers of their own
            old.unlink()
    scan = scan_page(rs, 500, 1200, rgb=True)
    small = scan_page(rs, 80, 210, rgb=True)
    files = {}

    def save(name, im, fmt, **kw):
        im.save(out / name, fmt, **kw)
        files[name] = out / name
    for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
        save(f"scan_{tag}.jpg", Image.fromarray(scan), "JPEG", quality=90, subsampling=sub)
    save("grey.jpg", Image.fromarray(small[..., 0]), "JPEG", quality=85)
    save("restart_420.jpg", Image.fromarray(small), "JPEG", quality=75, subsampling=2,
         restart_marker_blocks=2)
    save("optimized_422.jpg", Image.fromarray(small), "JPEG", quality=95, subsampling=1,
         optimize=True)
    save("bmp1.bmp", Image.fromarray(small[..., 0] > 128), "BMP")
    save("bmp8.bmp", Image.fromarray(small).quantize(64), "BMP")
    save("bmp24.bmp", Image.fromarray(small), "BMP")
    save("bmp32.bmp", Image.fromarray(np.dstack([small, small[..., :1]])), "BMP")
    save("raw.tif", Image.fromarray(small[..., 0]), "TIFF")
    save("packbits.tif", Image.fromarray(small[..., 0]), "TIFF", compression="packbits")
    save("lzw_pred2.tif", Image.fromarray(small), "TIFF", compression="tiff_lzw",
         tiffinfo={317: 2})
    save("rgb.tif", Image.fromarray(small), "TIFF")
    (out / "white_is_zero.tif").write_bytes(tiff_bytes(
        (small[..., :1] < 128).astype(np.uint16), 1, 0, rows_per_strip=16))
    files["white_is_zero.tif"] = out / "white_is_zero.tif"
    save("palette.png", Image.fromarray(small).quantize(32), "PNG")
    g16 = small[..., 0].astype(np.uint16) * 3
    (out / "grey16.png").write_bytes(png_bytes(g16[..., None], 0, 16, rs))
    (out / "interlaced.png").write_bytes(png_bytes(small, 2, 8, rs, interlace=True))
    files["grey16.png"], files["interlaced.png"] = out / "grey16.png", out / "interlaced.png"
    # Bilevel scans in the CCITT codings (their own draws, so the files
    # above stay as they were): Group 4, 2-D T.4 with EOL fill bits and
    # Modified Huffman in strips of 32 rows, and a Group 4 page.
    from test_torch_port_ccitt import ccitt_bytes
    rs = np.random.RandomState(2025)
    bilevel = scan_page(rs, 80, 210) < 128
    for name, coding in (("ccitt_g4.tif", "t6"), ("ccitt_g3_2d.tif", "t4_2d_fill"),
                         ("ccitt_mh.tif", "mh")):
        (out / name).write_bytes(ccitt_bytes(~bilevel, coding, rows_per_strip=32))
        files[name] = out / name
    (out / "ccitt_g4_page.tif").write_bytes(
        ccitt_bytes(scan_page(rs, 500, 1200) >= 128, "t6"))
    files["ccitt_g4_page.tif"] = out / "ccitt_g4_page.tif"
    # PIL's ZSTD TIFF of the Group 4 page's grey: the card's machine has no
    # Zstandard encoder, so phase 12's ZSTD page is this file.
    save("zstd_g4_page.tif", Image.fromarray(pil_gray(out / "ccitt_g4_page.tif")), "TIFF",
         compression="zstd")
    # Progressive JPEG, Deflate and JPEG-in-TIFF, from the pages above (no
    # new draws). The progressive page holds scan_420.jpg's pixels at its
    # quality and subsampling, so it reads as that file does: golden.npz
    # holds no array of its own for it (``load_golden``).
    save("progressive_page.jpg", Image.fromarray(scan), "JPEG", quality=90, subsampling=2,
         progressive=True)
    save("progressive_grey.jpg", Image.fromarray(small[..., 0]), "JPEG", quality=85,
         progressive=True)
    save("progressive_420.jpg", Image.fromarray(small), "JPEG", quality=75, subsampling=2,
         optimize=True, restart_marker_blocks=2, progressive=True)
    save("deflate_pred2.tif", Image.fromarray(small), "TIFF", compression="tiff_adobe_deflate",
         tiffinfo={317: 2})
    save("jpeg_grey.tif", Image.fromarray(small[..., 0]), "TIFF", compression="jpeg", quality=85)
    from test_torch_port_tiff_codecs import jpeg_tiff
    (out / "jpeg_ycbcr.tif").write_bytes(jpeg_tiff(small, 6, rows_per_strip=16, sub=2, quality=85,
                                                   abbreviate=True))
    files["jpeg_ycbcr.tif"] = out / "jpeg_ycbcr.tif"
    # Damaged JPEG data, CMYK and YCCK, a cut progressive script, from the
    # small page (no new draws; 200 wide where a file is cut into MCU rows
    # of 25 MCUs, one restart interval each, from which chip_smoke.py
    # tiles its page-sized files, ``chip_smoke.tile_jpeg``).
    page = small[:, :200]
    save("restart_444.jpg", Image.fromarray(page), "JPEG", quality=85, subsampling=0,
         restart_marker_blocks=25)
    data = (out / "restart_444.jpg").read_bytes()
    rst = [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    (out / "restart_damaged.jpg").write_bytes(data[:rst[4]] + data[rst[4] + 2:])
    buf = io.BytesIO()
    Image.fromarray(small).save(buf, "JPEG", quality=75, subsampling=2)
    data = buf.getvalue()
    at = data.index(b"\xff\xda") + 2000
    (out / "bad_code.jpg").write_bytes(data[:at] + b"\xff\x00" * 3 + data[at:])
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(2026).randint(0, 256, (32, 32)).astype(np.uint8)).save(
        buf, "JPEG", quality=100)
    (out / "dqt_q64.jpg").write_bytes(with_quantizers(buf.getvalue(), 64))
    cmyk = np.asarray(Image.fromarray(page).convert("CMYK"))
    save("cmyk.jpg", Image.fromarray(cmyk, "CMYK"), "JPEG", quality=85, restart_marker_blocks=25)
    from test_torch_port_cmyk import ycck_bytes
    (out / "ycck.jpg").write_bytes(ycck_bytes(cmyk, ((2, 2), (1, 1), (1, 1), (2, 2)), 85))
    save("cmyk.tif", Image.fromarray(cmyk, "CMYK"), "TIFF", compression="tiff_adobe_deflate")
    from test_torch_port_progressive import cut_scans
    buf = io.BytesIO()
    Image.fromarray(small).save(buf, "JPEG", quality=85, subsampling=2, progressive=True)
    (out / "progressive_cut.jpg").write_bytes(cut_scans(buf.getvalue(), 4))
    for name in ("restart_damaged.jpg", "bad_code.jpg", "dqt_q64.jpg", "ycck.jpg",
                 "progressive_cut.jpg"):
        files[name] = out / name
    # Old-style JPEG-in-TIFF, number TIFFs, lossless and arithmetic-coded
    # JPEG, 32 x 48 from draws of their own; and two files from which
    # chip_smoke.py builds pages, whose greys other fixtures hold: the
    # restart intervals of restart_444.jpg arithmetic-coded, and the first 8
    # rows of scan_420.jpg's grey, lossless, a restart a row.
    import chip_smoke
    from test_torch_port_ojpeg import ojpeg_jif, ojpeg_tables
    from torch_port_jpeg_writers import SCRIPT3, arith_jpeg, lossless_jpeg

    def put(name, data):
        (out / name).write_bytes(data)
        files[name] = out / name

    def jpeg(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **kw)
        return buf.getvalue()
    rs = np.random.RandomState(2027)
    tiny = scan_page(rs, 32, 48, rgb=True)
    grey = tiny[..., 0].astype(np.float64)
    put("ojpeg_grey.tif", ojpeg_jif(jpeg(tiny[..., 0], quality=85), 48, 32, 1, photometric=1))
    put("ojpeg_420.tif", ojpeg_jif(jpeg(tiny, quality=85, subsampling=2), 48, 32, 3))
    put("ojpeg_tables_420.tif", ojpeg_tables(jpeg(tiny, quality=85, subsampling=2,
                                                  restart_marker_rows=1), 48, 32, 3, sub=(2, 2),
                                             rows_per_strip=16))
    floats = (grey * 1.3 - 30 + rs.rand(32, 48)).astype(np.float32)
    floats[0, :6] = [np.nan, -3.5, 0.5, 254.9, 300, np.inf]
    put("float32_pred3.tif", chip_smoke.tiff_numbers(floats, "<f4", 3, rows_per_strip=8,
                                                     compression=8, predictor=3))
    put("int16_be.tif", chip_smoke.tiff_numbers(np.round(grey * 2 - 100).astype(np.int16), ">i2",
                                                2, compression=8, predictor=2))
    wide = (grey * 3).astype(np.uint32) | (rs.rand(32, 48) < 0.1).astype(np.uint32) << 31
    put("uint32.tif", chip_smoke.tiff_numbers(wide, "<u4", 1, compression=8, predictor=2))
    put("grey12.tif", chip_smoke.tiff_numbers((grey * 13).astype(np.uint16) % 4096, "12", 1,
                                              compression=8))
    save("int32_lzw.tif", Image.fromarray((grey * 2 - 80).astype(np.int32), "I"), "TIFF",
         compression="tiff_lzw", tiffinfo={317: 2})
    put("lossless_rgb.jpg", lossless_jpeg([tiny[..., 0], tiny[:, ::2, 1], tiny[:, ::2, 2]],
                                          [(2, 1), (1, 1), (1, 1)], psv=7, pt=1, restart_rows=4))
    put("arith_progressive.jpg", arith_jpeg(jpeg(tiny, quality=85, subsampling=2), scans=SCRIPT3,
                                            restart=2, dac=((0, 0x21), (16, 3))))
    put("arith_444.jpg", arith_jpeg((out / "restart_444.jpg").read_bytes(), restart=25,
                                    dac=((0, 0x31),)))
    put("lossless_stripe.jpg", lossless_jpeg([pil_gray(out / "scan_420.jpg")[:8]],
                                             restart_rows=1))
    # The TIFF layouts of A.6.7-A.6.12, 48 x 32 (46 x 30 where the image's
    # edge cuts 4 x 4 YCbCr tiles; 24 x 16 uncompressed) from draws of their own, by
    # chip_smoke's writers: BigTIFF, planar, YCbCr through libtiff and PIL's
    # raw route, FillOrder 2, associated alpha, a palette with alpha.
    rs = np.random.RandomState(2028)
    page = scan_page(rs, 32, 48, rgb=True).astype(np.int64)
    grey = page[..., :1]
    alpha = rs.randint(0, 256, (32, 48, 1))
    cmyk = np.dstack([255 - page, np.minimum(page[..., :1], 40)])
    block = page[..., 0].reshape(16, 2, 24, 2).sum(axis=(1, 3)) // 4
    put("bigtiff_lzw.tif", chip_smoke.tiff_layout(grey, 8, 1, compression=5, big=True,
                                                  rows_per_strip=8))
    put("planar_rgb.tif", chip_smoke.tiff_layout(page, 8, 2, compression=8, planar=2,
                                                 predictor=2, rows_per_strip=8))
    put("planar_cmyk_raw.tif", chip_smoke.tiff_layout(cmyk[:16, :24], 8, 5, planar=2,
                                                      tile=(16, 16)))
    put("ycbcr_22.tif", chip_smoke.tiff_ycbcr(page[..., 0], 128 + (block - 128) // 4,
                                              128 - (block - 128) // 8, (2, 2),
                                              rows_per_strip=8))
    edge = page[:30, :46, 0]
    put("ycbcr_44_tiles.tif", chip_smoke.tiff_ycbcr(
        edge, rs.randint(100, 156, (8, 12)), rs.randint(100, 156, (8, 12)), (4, 4),
        compression=5, tile=(16, 16)))
    # PIL's raw route reads RGBX, 4 bytes a pixel, on past each strip: a
    # private tag's 512 bytes after the directory keeps the last strip's read in
    # the file.
    put("ycbcr_raw.tif", chip_smoke.tiff_ycbcr(page[:16, :24, 0], page[:16, :24, 1],
                                               page[:16, :24, 2], (1, 1), compression=1,
                                               rows_per_strip=8,
                                               tags=[(65000, 7, bytes(range(256)) * 2)]))
    put("fill2_lzw_rgb.tif", chip_smoke.tiff_layout(page, 8, 2, compression=5, fill=2,
                                                    rows_per_strip=8))
    put("fill2_raw_grey.tif", chip_smoke.tiff_layout(grey, 8, 1, fill=2, rows_per_strip=8))
    put("rgba_assoc.tif", chip_smoke.tiff_layout(
        np.dstack([page * alpha // 255, alpha])[:16, :24], 8, 2, tags=[(338, 3, [1])]))
    ramp = np.arange(256)
    put("pa.tif", chip_smoke.tiff_layout(np.dstack([grey, alpha]), 8, 3, compression=8, tags=[
        (338, 3, [2]), (320, 3, list(ramp * 257) + list(ramp * 200 // 255 * 257)
                        + list(255 * 257 - ramp * 257))]))
    # PIL reads a file in blocks of its ImageFile.MAXBLOCK (64 KB), which
    # this module raises for PIL's JPEG writer: the goldens and digests are
    # PIL's at its own block size, as the JAX package reads.
    writer_block, ImageFile.MAXBLOCK = ImageFile.MAXBLOCK, 65536
    golden = {name: pil_gray(path) for name, path in files.items()}
    assert np.array_equal(golden.pop("progressive_page.jpg"), golden["scan_420.jpg"])
    assert np.array_equal(golden.pop("arith_444.jpg"), golden["restart_444.jpg"])
    assert np.array_equal(golden.pop("lossless_stripe.jpg"), golden["scan_420.jpg"][:8])
    assert np.array_equal(golden.pop("zstd_g4_page.tif"), golden["ccitt_g4_page.tif"])
    # chip_smoke.py's pages of these kinds, held to PIL's grey by digest
    # ("refused" where PIL refuses the page).
    lines = []
    pages = {**chip_smoke.a6_pages(golden), **chip_smoke.a6_layout_pages(golden),
             **chip_smoke.a6_codec_pages(golden), **chip_smoke.a6_ccitt_lzw_pages(golden),
             **chip_smoke.a6_kind_pages(golden), **chip_smoke.a6_gif_pnm_pages(golden),
             **chip_smoke.a6_raster_pages(golden), **chip_smoke.a6_text_pages(golden),
             **chip_smoke.a6_texture_pages(golden), **chip_smoke.a6_header_pages(golden)}
    for name, data in pages.items():
        try:
            with Image.open(io.BytesIO(data)) as im:
                digest = gray_digest(np.asarray(im.convert("L")))
        except OSError:
            digest = "refused"
        lines.append(f"{digest}  {name}\n")
    for name, data in write_webp_pages(out / "scan_420.jpg", chip_smoke.WEBP_PAGES).items():
        with Image.open(io.BytesIO(data)) as im:
            lines.append(f"{gray_digest(np.asarray(im.convert('L')))}  {name}\n")
    (out / "a6_pages.sha256").write_text("".join(lines))
    # The progressive page cut after 6 of its 10 scans, which chip_smoke.py
    # decodes: a page of golden array would pass the 1 MB, so its digest.
    cut = cut_scans((out / "progressive_page.jpg").read_bytes(), 6)
    with Image.open(io.BytesIO(cut)) as im:
        (out / "progressive_cut_page.sha256").write_text(
            gray_digest(np.asarray(im.convert("L"))) + "\n")
    ImageFile.MAXBLOCK = writer_block
    np.savez_compressed(out / "golden.npz", **golden)
    return load_golden(out)


def write_webp_pages(scan_jpg: Path, out: Path) -> dict:
    """Pillow's WebP pages of ``scan_jpg``'s pixels (1200 x 500), which
    phase 12 decodes on the card's host (it has no WebP encoder): lossy RGB
    ('VP8 '), lossless grey ('VP8L') and lossy RGBA (VP8X with ALPH: the
    page's white transparent, a half-transparent margin). They live in a
    directory of their own (``chip_smoke.WEBP_PAGES``): the fixtures here
    stay under 1 MB."""
    with Image.open(scan_jpg) as im:
        rgb, grey = np.asarray(im.convert("RGB")), np.asarray(im.convert("L"))
    alpha = np.where(grey > 230, 0, 255).astype(np.uint8)
    alpha[:, :40] = 128
    out.mkdir(parents=True, exist_ok=True)
    pages = {}
    for name, arr, kw in (("webp_lossy_page.webp", rgb, {"quality": 80}),
                          ("webp_lossless_page.webp", grey, {"lossless": True}),
                          ("webp_alpha_page.webp", np.dstack([rgb, alpha]), {"quality": 80})):
        Image.fromarray(arr).save(out / name, "WEBP", **kw)
        pages[name] = (out / name).read_bytes()
    return pages


def gray_digest(gray: np.ndarray) -> str:
    """SHA-256 of a grey image's shape and pixels, in hex."""
    return hashlib.sha256(repr(gray.shape).encode() + np.ascontiguousarray(gray).tobytes()).hexdigest()


def with_quantizers(data: bytes, q: int) -> bytes:
    """A JPEG with every entry of its 8-bit quantization tables set to
    ``q``: its coefficients, coded for other quantizers, then dequantize
    past the range of valid data."""
    d, i = bytearray(data), 2
    while d[i + 1] != 0xDA:
        n = (d[i + 2] << 8) | d[i + 3]
        if d[i + 1] == 0xDB:
            for j in range(i + 4, i + 2 + n, 65):
                d[j + 1:j + 65] = bytes([q]) * 64
        i += 2 + n
    return bytes(d)


def load_golden(root: Path = FIXTURES) -> dict:
    """PIL's grey of every fixture by name: ``golden.npz``, and for the
    four fixtures that hold another's pixels that array
    (``chip_smoke.golden_arrays``)."""
    with np.load(root / "golden.npz") as f:
        golden = dict(f)
    return {**golden, "progressive_page.jpg": golden["scan_420.jpg"],
            "arith_444.jpg": golden["restart_444.jpg"],
            "lossless_stripe.jpg": golden["scan_420.jpg"][:8],
            "zstd_g4_page.tif": golden["ccitt_g4_page.tif"]}


def test_fixtures_are_pil_exact_and_small():
    """The committed fixtures still read, with PIL and with the port, as
    their golden arrays (the progressive page as scan_420.jpg's); together
    they stay under 1 MB."""
    golden = load_golden()
    assert len(golden) == 59 and sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1 << 20
    assert golden["scan_420.jpg"].shape == golden["ccitt_g4_page.tif"].shape == (500, 1200)
    assert golden["progressive_page.jpg"] is golden["scan_420.jpg"]
    for name, want in golden.items():
        np.testing.assert_array_equal(pil_gray(FIXTURES / name), want, err_msg=name)
        np.testing.assert_array_equal(tdataset.decode_gray(FIXTURES / name), want, err_msg=name)


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--write-fixtures"]:
        print({k: v.shape for k, v in write_fixtures().items()})
