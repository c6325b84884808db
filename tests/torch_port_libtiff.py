"""PIL's own libtiff, called through ctypes, as the reference for damaged
CCITT data (ROADMAP C.14).

Where libtiff's fax decoder stops a Group 4 strip early, the rows it did
not reach keep whatever PIL's strip buffer held: the previous strip's rows,
or, in a strip PIL's buffer starts with, memory that ``malloc`` did not
clear. PIL's pixels there differ from run to run, so a test cannot hold the
port to them. ``libtiff_read`` decodes each strip into one buffer reused
from strip to strip, as PIL's ``_decodeStrip`` does, twice: once cleared to
0x00 and once filled with 0xFF. The bytes that agree are the ones libtiff
wrote; the port's reading is the 0x00 run (it starts from a cleared
buffer), and PIL is compared where libtiff wrote. A tiled file is read the
same way, tile after tile into one buffer, as PIL's ``_decodeTile`` does.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import io
import os
import struct
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image
from PIL import _imaging  # noqa: F401  (loads the libraries libtiff links)

from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative


def _libtiff() -> ctypes.CDLL:
    libs = os.path.join(os.path.dirname(Image.__file__), "..", "pillow.libs")
    found = glob.glob(os.path.join(libs, "libtiff*.so*")) or [ctypes.util.find_library("tiff")]
    lib = ctypes.CDLL(found[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                         ctypes.c_ssize_t]
    lib.TIFFNumberOfStrips.argtypes = [ctypes.c_void_p]
    lib.TIFFStripSize.restype = ctypes.c_ssize_t
    lib.TIFFStripSize.argtypes = [ctypes.c_void_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFReadEncodedTile.restype = ctypes.c_ssize_t
    lib.TIFFReadEncodedTile.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                        ctypes.c_ssize_t]
    lib.TIFFNumberOfTiles.argtypes = [ctypes.c_void_p]
    lib.TIFFTileSize.restype = ctypes.c_ssize_t
    lib.TIFFTileSize.argtypes = [ctypes.c_void_p]
    return lib


_LIB = _libtiff()


def _tags(data: bytes) -> dict:
    """{tag: values} of a little-endian TIFF's first IFD."""
    at = struct.unpack_from("<I", data, 4)[0]
    out = {}
    for i in range(struct.unpack_from("<H", data, at)[0]):
        e = at + 2 + 12 * i
        tag, typ, count = struct.unpack_from("<HHI", data, e)
        size = {3: 2, 4: 4}.get(typ, 1) * count
        where = e + 8 if size <= 4 else struct.unpack_from("<I", data, e + 8)[0]
        fmt = {3: "H", 4: "I"}.get(typ, "B")
        out[tag] = list(struct.unpack_from(f"<{count}{fmt}", data, where))
    return out


def _strips(data: bytes, fill: int, tiles: bool = False):
    """[(libtiff's return, the buffer after it)] a strip (or tile), one
    buffer reused."""
    fd, path = tempfile.mkstemp(suffix=".tif")
    try:
        os.write(fd, data)
        os.close(fd)
        tif = _LIB.TIFFOpen(path.encode(), b"r")
        if not tif:
            return None
        try:
            size = (_LIB.TIFFTileSize if tiles else _LIB.TIFFStripSize)(tif)
            buf = (ctypes.c_uint8 * size)(*([fill] * size))
            read = _LIB.TIFFReadEncodedTile if tiles else _LIB.TIFFReadEncodedStrip
            out = []
            for s in range((_LIB.TIFFNumberOfTiles if tiles else _LIB.TIFFNumberOfStrips)(tif)):
                out.append((read(tif, s, buf, size), bytes(buf)))
                if out[-1][0] < 0:
                    break
            return out
        finally:
            _LIB.TIFFClose(tif)
    finally:
        os.unlink(path)


def libtiff_read(data: bytes):
    """None where a strip fails (PIL then refuses the file); else (grey,
    written): the bilevel image's grey from a buffer cleared to 0 before the
    first strip, and which of its pixels libtiff wrote."""
    tags = _tags(data)
    w, h = tags[256][0], tags[257][0]
    tiles = 322 in tags
    cw, ch = (tags[322][0], tags[323][0]) if tiles else (w, min(tags.get(278, [h])[0], h))
    across = -(-w // cw)
    zero, ones = _strips(data, 0x00, tiles), _strips(data, 0xFF, tiles)
    if zero is None or any(r < 0 for r, _ in zero) or len(zero) < across * -(-h // ch):
        return None
    rb = (cw + 7) // 8
    bits, written = np.zeros((h, w), np.uint8), np.zeros((h, w), bool)
    for i, ((_, a), (_, b)) in enumerate(zip(zero, ones)):
        y0, x0 = i // across * ch, i % across * cw
        for y in range(min(ch, h - y0)):
            ra = np.unpackbits(np.frombuffer(a[y * rb:(y + 1) * rb], np.uint8))[:min(cw, w - x0)]
            rb_ = np.unpackbits(np.frombuffer(b[y * rb:(y + 1) * rb], np.uint8))[:len(ra)]
            bits[y0 + y, x0:x0 + len(ra)] = ra
            written[y0 + y, x0:x0 + len(ra)] = ra == rb_
    white = 0 if tags.get(262, [0])[0] == 0 else 1     # WhiteIsZero: a 0 bit is white
    grey = np.where(bits == white, 255, 0).astype(np.uint8)
    return grey, written


def pil_l(data: bytes):
    """PIL's convert("L"), or None where PIL refuses the file."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("L"))
    except Exception:
        return None


def assert_reads_as_libtiff(data: bytes, tmp_path: Path, reads: bool | None = None):
    """The port reads the file as PIL's libtiff decodes it: corrupt where a
    strip fails (PIL refuses), else libtiff's pixels from a cleared buffer,
    which PIL's equal wherever libtiff wrote. ``reads`` states which it is."""
    ref, pil = libtiff_read(data), pil_l(data)
    assert (ref is None) == (pil is None)
    if reads is not None:
        assert (ref is not None) == reads
    path = tmp_path / "damaged.tif"
    path.write_bytes(data)
    if ref is None:
        try:
            tnative.decode(data)
        except ValueError:
            pass
        else:
            raise AssertionError("the port reads a file PIL refuses")
        assert not tdataset.decode_image(path, 16).any()
        return None
    grey, written = ref
    got = tnative.decode(data)
    np.testing.assert_array_equal(got, grey)
    np.testing.assert_array_equal(got[written], pil[written])
    return grey, written
