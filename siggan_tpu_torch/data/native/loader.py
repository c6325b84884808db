"""ctypes binding of the port's host image decoder, ``decode.cpp`` and
``webp.cpp`` (built together into one library).

The decoder reads JPEG, BMP, TIFF (BigTIFF, LZMA, ZSTD, CCITT in tiles and
old-style LZW among them), GIF, Netpbm, WebP (lossless, lossy, with an
ALPH chunk, an animation's first frame: libwebp's demuxer and decoders as
Pillow calls them), DIB, ICO, CUR, TGA, PCX, DCX, SGI, SUN raster, MSP,
QOI, IM, XBM, XPM, XV thumbnail and PSD files (old-style JPEG-in-TIFF in
planes and tiles among the TIFFs) to 8-bit grey, as PIL's
``Image.open(path).convert("L")`` gives
them, with no imaging library; PNG streams are recognised and left to
``infer/export.py::decode_png``, which inflates their rows with zlib and
undoes the row filters here (``png_unfilter``): a PNG file, and the PNG
icon an ICO file's largest entry holds, which comes back as its offset
(``decode_or_png``). The format comes from the file's bytes, not from its
name, by the rules PIL's ``Image.open`` tries its plugins by: a file PIL
opens as another format (DDS, BLP, FITS, ...) raises naming that format. The library
also resizes (``resize_bilinear``: Pillow's ``L``-mode bilinear, bit-equal
to ``data/resample.py``'s numpy version, which stays as the plain version);
a ctypes call releases the interpreter lock, so threads resize in parallel. The library is
built with ``g++`` at first use into ``build/siggan_tpu_torch/``
(``ops/kernels/build.py::load_host``); there is no other decoder to fall
back on.

Statuses: ``OK``; ``CORRUPT`` (truncated or malformed data, or a kind PIL
itself refuses, such as a 12-bit JPEG or a TIFF layout PIL has no mode
for: raised as ``ValueError``); ``UNSUPPORTED`` (a file PIL reads, of a
kind not read yet, raised as ``NotImplementedError`` naming ROADMAP A.6);
``UNREADABLE`` (the file could not be opened or read, ``OSError``); ``PNG``
(a PNG stream, at an offset the library hands back); ``INDICES`` (read, and
PIL's ``convert("L")`` leaves the image in mode P, whose indices are its
grey and which PIL resizes nearest: ``resize_nearest``).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from siggan_tpu_torch.ops.kernels import build

SOURCE = Path(__file__).with_name("decode.cpp")
# Every source of the library: decode.cpp and the WebP decoder it calls.
SOURCES = (SOURCE, Path(__file__).with_name("webp.cpp"))
# The version of what the dataset decodes: the decoders (this library and
# ``infer/export.py::decode_png``) and the resize (``sig_resize_bilinear``).
# It names the dataset cache (``data/dataset.py``), so a cache written by an
# older decoder is never read. Bump it in every change that alters a decoded
# or resized pixel. d1: the decoders of the PNG-in-Python port; d2: PNG rows
# unfiltered by ``sig_png_unfilter``; d3: damaged JPEG data read as
# libjpeg-turbo reads it (restart resync, bad Huffman codes, its SIMD IDCT
# on out-of-range coefficients), so files that were zero images decode;
# d4: a JPEG file whose data ends without EOI read where PIL reads it (its
# 64 KB blocks and libjpeg-turbo's bit-buffer fills; an arithmetic-coded
# scan past a block is refused), and libtiff's tag types in compressed TIFF
# (a tag of a type it cannot read is refused, a missing StripByteCounts
# estimated), so pixels become zero images and zero images pixels; d5:
# damaged CCITT data read as libtiff's fax decoder reads it (a bad code or
# a row of the wrong length cut or padded and decoding going on, T.4
# without EOLs, Group 4 strips that end early keeping their rows), so
# files that were zero images decode; d6: damaged 4-stream ZSTD literals
# read as libzstd's x86-64 decoders read them (its double-symbol table,
# its fast path's checks and its reader past a stream's start), and
# kinds PIL refuses made corrupt (SOF11 JPEG, a size or sample bits tag
# given twice, samples PIL's directory and libtiff's read otherwise), so
# pixels change and files that raised become zero images; d7: old-style
# JPEG-in-TIFF whose last strip or tile has no data read as libtiff reads
# it (no EOI: a stop where libjpeg runs out), and YCbCr tiles after a stop
# as PIL's RGBA reader takes them (C.17), so pixels change and files that
# decoded become zero images; d8: planar YCbCr old-style JPEG-in-TIFF read
# as PIL reads it (C.20), a JPEG Huffman table with an all-ones code
# corrupt (C.22), and every format PIL opens classified as PIL's Image.open
# does (C.21): zero images become pages, or a stop naming ROADMAP A.6; d9:
# a BMP whose file header gives a pixel offset of 0 read from where PIL's
# header reads stop (C.23), and BMP palettes PIL takes for grey ("L") or
# black and white ("1") unpacked at that mode's depth, a palette of more
# than 256 colours refused, rows whose last padding is missing read, as PIL
# reads them (C.24), so pixels change and files become zero images or pages;
# d10: old-style JPEG-in-TIFF whose header skips a segment's bytes (APPn,
# COM, the SOS's last three) no further than the end of their block, as
# libtiff skips them (C.26), so the scan starts where libtiff's does; d11:
# a JPEG scan header's components looked up as libjpeg-turbo's get_sos
# looks them up (C.27): a scan out of the frame's order or naming a
# component twice is corrupt, and a frame's repeated id is the first one
# free, so files become zero images and pixels change.
DECODE_VERSION = "d11"
OK, CORRUPT, UNSUPPORTED, UNREADABLE, PNG, INDICES = range(6)
_MSG = 160

_P = ctypes.POINTER
_SIGNATURES = {
    "sig_decode": ([ctypes.c_char_p, ctypes.c_int64, _P(ctypes.c_void_p), _P(ctypes.c_int),
                    _P(ctypes.c_int), ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "sig_free": ([ctypes.c_void_p], None),
    "sig_png_unfilter": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int],
                         ctypes.c_int),
    "sig_resize_bilinear": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "sig_decode_files": ([_P(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, _P(ctypes.c_void_p),
                          _P(ctypes.c_int), _P(ctypes.c_int), _P(ctypes.c_int),
                          ctypes.c_char_p, ctypes.c_int], None),
}


def library() -> ctypes.CDLL:
    """The decoder library, built on first use."""
    return build.load_host(SOURCES, _SIGNATURES)


def _take(lib: ctypes.CDLL, ptr: int, w: int, h: int) -> np.ndarray:
    """Copy a decoded image out of the library's buffer and free it."""
    try:
        return np.ctypeslib.as_array(ctypes.cast(ptr, _P(ctypes.c_uint8)),
                                     shape=(h, w)).copy()
    finally:
        lib.sig_free(ptr)


def error(status: int, message: str, what: str) -> Exception:
    """The exception a failed decode of ``what`` raises; a kind not read yet
    names the format PIL would open the file as (``message``), whatever the
    file's name."""
    if status == UNSUPPORTED:
        return NotImplementedError(
            f"{what}: {message} is not read by the port yet (ROADMAP A.6)")
    if status == UNREADABLE:
        return OSError(f"{what}: {message}")
    return ValueError(f"{what}: {message}")


class Decoded(NamedTuple):
    """What the library made of a file: its grey (None for a PNG stream),
    where its PNG stream starts, and whether PIL resizes it nearest."""
    gray: Optional[np.ndarray]
    png_at: int
    nearest: bool


def decode_or_png(data: bytes, what: str = "image") -> Decoded:
    """A file's bytes -> its uint8 (H, W) grey, or None and the offset a
    PNG stream starts at (0 for a PNG file, the icon's for an ICO file whose
    largest entry is a PNG), for ``decode_png``; raises as ``error`` says."""
    lib = library()
    ptr, w, h = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG)
    st = lib.sig_decode(data, len(data), ctypes.byref(ptr), ctypes.byref(w), ctypes.byref(h),
                        msg, _MSG)
    if st == PNG:
        return Decoded(None, w.value, False)
    if st not in (OK, INDICES):
        raise error(st, msg.value.decode(errors="replace"), what)
    return Decoded(_take(lib, ptr.value, w.value, h.value), 0, st == INDICES)


def decode(data: bytes, what: str = "image") -> np.ndarray:
    """A file's bytes -> uint8 (H, W) grey; raises as ``error`` says (a PNG
    stream raises ``ValueError``: it is not decoded here)."""
    gray = decode_or_png(data, what).gray
    if gray is None:
        raise ValueError(f"{what}: a PNG stream goes to decode_png")
    return gray


def png_unfilter(raw: np.ndarray, pos: int, h: int, stride: int, bpp: int) -> np.ndarray:
    """``h`` PNG rows of a filter byte and ``stride`` bytes at ``raw[pos:]``
    (uint8, as zlib inflates the image data) -> (h, stride) uint8 with the
    row filters undone (``bpp``: bytes of one complete pixel, at least 1).
    Raises ``ValueError`` on too little data or a bad filter type."""
    lib = library()
    raw = np.ascontiguousarray(raw, np.uint8)
    if not 0 <= pos <= raw.size:
        raise ValueError("PNG image data is too short")
    out = np.empty((h, stride), np.uint8)
    msg = ctypes.create_string_buffer(_MSG)
    st = lib.sig_png_unfilter(raw.ctypes.data + pos, raw.size - pos, h, stride, bpp,
                              out.ctypes.data, msg, _MSG)
    if st != OK:
        raise ValueError(msg.value.decode(errors="replace"))
    return out


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W) -> uint8 (height, width), PIL's ``Image.resize`` of a
    mode P image (NEAREST: ImagingTransform's affine map in 16.16 fixed
    point, each output pixel's centre)."""
    a = np.asarray(img, np.uint8)

    def source(n_in: int, n_out: int) -> np.ndarray:
        step = n_in / n_out
        fix = lambda v: int(np.floor(v * 65536.0 + 0.5))  # noqa: E731
        return (fix(step * 0.5) + np.arange(n_out, dtype=np.int64) * fix(step)) >> 16
    return a[np.ix_(source(a.shape[0], height), source(a.shape[1], width))]


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W) -> uint8 (height, width), equal to PIL's
    ``Image.fromarray(img).resize((width, height), Image.BILINEAR)`` and to
    ``data/resample.py::resize_bilinear``."""
    a = np.asarray(img, np.uint8)
    if a.ndim != 2:
        raise ValueError(f"resize_bilinear takes one (H, W) image, got {a.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"cannot resize to {width} x {height}")
    if a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"cannot resize an empty image {a.shape}")
    if a.strides[1] != 1:
        a = np.ascontiguousarray(a)
    out = np.empty((height, width), np.uint8)
    st = library().sig_resize_bilinear(a.ctypes.data, a.shape[0], a.shape[1], a.strides[0],
                                       out.ctypes.data, height, width)
    if st != OK:
        raise ValueError(f"cannot resize {a.shape} to {width} x {height}")
    return out


def decode_files(paths: Sequence[str | Path], n_threads: Optional[int] = None
                 ) -> Tuple[List[Optional[np.ndarray]], np.ndarray, List[str], np.ndarray]:
    """Decode files on ``n_threads`` threads (default: up to 8, one per
    core) -> (per file its uint8 (H, W) grey or None, (n,) int32 statuses,
    messages, (n,) offsets): a grey with status ``OK`` or ``INDICES``, a PNG
    stream as None with status ``PNG`` and the offset it starts at (0 for a
    PNG file and every other status)."""
    lib = library()
    n = len(paths)
    names = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    outs = (ctypes.c_void_p * n)()
    ws, hs, st = (ctypes.c_int * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)()
    msgs = ctypes.create_string_buffer(_MSG * n)
    threads = n_threads or min(8, os.cpu_count() or 1)
    lib.sig_decode_files(names, n, threads, outs, ws, hs, st, msgs, _MSG)
    images: List[Optional[np.ndarray]] = [
        _take(lib, outs[i], ws[i], hs[i]) if st[i] in (OK, INDICES) else None for i in range(n)]
    raw = msgs.raw
    messages = [raw[i * _MSG:(i + 1) * _MSG].split(b"\0", 1)[0].decode(errors="replace")
                for i in range(n)]
    status = np.frombuffer(st, np.int32).copy()
    return images, status, messages, np.where(status == PNG, np.frombuffer(ws, np.int32), 0)
