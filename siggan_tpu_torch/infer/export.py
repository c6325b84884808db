"""Image export: PNG bytes, in-memory ZIPs, PNG batches, contact sheets.

The same functions as the JAX package's ``infer/export.py``. PNGs are
encoded with the standard library (zlib) so that serving needs no imaging
package: 8-bit grayscale, RGB or RGBA, one filter byte of 0 per row.
``decode_png`` reads 8-bit non-interlaced PNGs back (all five row filters).
"""

from __future__ import annotations

import io
import struct
import zipfile
import zlib
from pathlib import Path
from typing import List

import numpy as np

from siggan_tpu_torch.utils.visualizer import make_grid, to_uint8

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}   # channels -> PNG colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(u8: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 1|3|4) -> PNG bytes."""
    a = np.asarray(u8, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"cannot encode {c} channels as PNG")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(data: bytes) -> np.ndarray:
    """8-bit non-interlaced grayscale/RGB/RGBA PNG -> uint8 (H, W, C).
    Raises ``ValueError`` on a malformed file or a bad chunk CRC."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r} chunk")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError("PNG has no IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    chans = {v: k for k, v in _COLOR_TYPE.items()}.get(ctype)
    if depth != 8 or chans is None or interlace:
        raise ValueError(f"unsupported PNG (depth {depth}, type {ctype})")
    raw = zlib.decompress(idat)
    stride = w * chans
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    out = np.zeros((h, stride), np.uint8)
    prev = [0] * stride
    for r in range(h):
        f = raw[r * (stride + 1)]
        if f > 4:
            raise ValueError(f"bad PNG filter type {f}")
        line = list(raw[r * (stride + 1) + 1:(r + 1) * (stride + 1)])
        for i in range(stride if f else 0):
            left = line[i - chans] if i >= chans else 0
            up, ul = prev[i], (prev[i - chans] if i >= chans else 0)
            if f == 1:
                pred = left
            elif f == 2:
                pred = up
            elif f == 3:
                pred = (left + up) // 2
            else:
                pred = _paeth(left, up, ul)
            line[i] = (line[i] + pred) & 0xFF
        out[r] = line
        prev = line
    return out.reshape(h, w, chans)


def save_pngs(images: np.ndarray, output_dir: str | Path,
              prefix: str = "signature", start_index: int = 0,
              denormalize: bool = True) -> List[Path]:
    """Write images as ``{prefix}_{i:06d}.png``; returns the paths."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    u8 = to_uint8(images) if denormalize else np.asarray(images, np.uint8)
    paths = []
    for i, img in enumerate(u8):
        p = out / f"{prefix}_{start_index + i:06d}.png"
        p.write_bytes(encode_png(img))
        paths.append(p)
    return paths


def png_bytes(image: np.ndarray, denormalize: bool = True) -> bytes:
    u8 = to_uint8(image[None])[0] if denormalize else np.asarray(image, np.uint8)
    return encode_png(u8)


def zip_bytes(images: np.ndarray, prefix: str = "signature",
              denormalize: bool = True) -> bytes:
    """In-memory ZIP of PNGs (the API's format=zip response body)."""
    u8 = to_uint8(images) if denormalize else np.asarray(images, np.uint8)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for i, img in enumerate(u8):
            zf.writestr(f"{prefix}_{i:06d}.png", encode_png(img))
    return buf.getvalue()


def contact_sheet(images: np.ndarray, path: str | Path, nrow: int = 8,
                  denormalize: bool = True) -> Path:
    u8 = to_uint8(images) if denormalize else np.asarray(images, np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(make_grid(u8, nrow=nrow)))
    return path
