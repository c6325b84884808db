"""Image export: PNG bytes, in-memory ZIPs, PNG batches, contact sheets,
animated GIFs.

The same functions as the JAX package's ``infer/export.py``. PNGs are
encoded with the standard library (zlib) so that serving needs no imaging
package: 8-bit grayscale, RGB or RGBA, one filter byte of 0 per row.
``encode_gif`` writes grey frames as a GIF89a animation (what PIL's
``save(..., save_all=True)`` gives the JAX package's training GIF): a
256-grey global palette, LZW-coded frames, one graphics-control block per
frame with its delay, and the NETSCAPE2.0 loop block.
``decode_png`` reads every kind of PNG back to 8 bits as PIL does: zlib
inflates the rows, the port's host decoder (``data/native/decode.cpp``,
``sig_png_unfilter``) undoes the five row filters, numpy unpacks the
samples; Adam7 interlacing.
"""

from __future__ import annotations

import io
import re
import struct
import zipfile
import zlib
from pathlib import Path
from typing import List

import numpy as np

from siggan_tpu_torch.data.native.loader import png_unfilter
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


def _lzw(pixels: bytes) -> bytes:
    """GIF's variable-width LZW of 8-bit ``pixels`` (minimum code size 8),
    packed least significant bit first: a clear code first and whenever
    the table reaches 4096 codes, the end code last."""
    clear, end = 256, 257
    out = bytearray()
    acc = n_acc = 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, n_acc
        acc |= code << n_acc
        n_acc += size
        while n_acc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_acc -= 8

    table: dict = {}
    size, nxt = 9, 258
    emit(clear, size)
    it = iter(pixels)
    w = next(it, None)
    if w is not None:
        for c in it:
            key = (w << 8) | c
            code = table.get(key)
            if code is not None:
                w = code
                continue
            emit(w, size)
            table[key] = nxt
            nxt += 1
            # The decoder reads the next code one table entry behind.
            if nxt > 1 << size and size < 12:
                size += 1
            if nxt == 4096:
                emit(clear, size)
                table.clear()
                size, nxt = 9, 258
            w = c
        emit(w, size)
    emit(end, size)
    if n_acc:
        out.append(acc & 0xFF)
    return bytes(out)


def encode_gif(frames: List[np.ndarray], duration_ms: int = 300) -> bytes:
    """uint8 (H, W) grey frames -> GIF89a bytes: a 256-grey global palette,
    each frame LZW-coded behind a graphics-control block with a delay of
    ``duration_ms / 10`` centiseconds, and the NETSCAPE2.0 block with loop
    count 0 (forever, as the JAX package's GIF). The screen is the largest frame's size; each
    frame sits at its top-left corner."""
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    arrs = [np.ascontiguousarray(np.asarray(f, np.uint8)) for f in frames]
    if any(a.ndim != 2 for a in arrs):
        raise ValueError("encode_gif takes (H, W) grey frames")
    sw, sh = max(a.shape[1] for a in arrs), max(a.shape[0] for a in arrs)
    grey = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    head = [b"GIF89a", struct.pack("<HHBBB", sw, sh, 0xF7, 0, 0), grey,
            b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    delay = int(round(duration_ms / 10))
    body = []
    for a in arrs:
        data = _lzw(a.tobytes())
        blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                          for i in range(0, len(data), 255))
        body += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00",
                 b"\x2c" + struct.pack("<HHHHB", 0, 0, a.shape[1], a.shape[0], 0),
                 b"\x08", blocks, b"\x00"]
    return b"".join(head + body) + b"\x3b"


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}        # PNG colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(rows: np.ndarray, w: int, chans: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> (h, w, chans) sample values (uint16 at 16 bits)."""
    h = rows.shape[0]
    n = w * chans
    if depth == 8:
        return rows[:, :n].reshape(h, w, chans)
    if depth == 16:
        return rows[:, :2 * n].copy().view(">u2").astype(np.uint16).reshape(h, w, chans)
    bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, w, chans)


# PIL's Image.open refuses an image of more than 2 * Image.MAX_IMAGE_PIXELS
# pixels (DecompressionBombError); the C++ decoder holds the same limit.
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


_CID = re.compile(rb"\w\w\w\w")   # PngImagePlugin's is_cid
_PIECE = 1 << 16                    # PIL's reads of image data (ImageFile.MAXBLOCK)


def _idat_pieces(data: bytes, pos: int) -> List[tuple]:
    """(start, end) of the image data as PIL's ``load_read`` hands it to its
    decoder: the consecutive IDAT chunks from the one at ``pos`` (empty
    ones skipped, their CRCs unread), in 64 KB pieces, each cut at the
    file's end."""
    pieces, n = [], len(data)
    while pos + 8 <= n and data[pos + 4:pos + 8] == b"IDAT":
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        start = pos + 8
        pieces += [(a, min(a + _PIECE, start + length, n))
                   for a in range(start, min(start + length, n), _PIECE)]
        pos = start + length + 4
    return pieces


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file -> uint8 (H, W, C) as PIL opens it and takes it to 8 bits:
    grey (C=1), grey + alpha (C=2), RGB (C=3) or RGBA (C=4); a palette image
    comes back as RGB through its palette (``tRNS`` ignored, as
    ``convert("L")`` ignores it); 1-, 2- and 4-bit grey scaled to 0..255;
    16-bit grey clamped at 255 and 16-bit colour or alpha reduced to its
    high byte, as PIL's conversions do; Adam7 interlacing. Every colour
    type and bit depth of the standard is read. Damaged data reads as PIL
    reads it (C.25): the chunks before the image data whole, their CRCs
    checked; the image data the IDAT chunks that follow one another, CRCs
    unchecked, inflated only as far as the image needs (a stream that ends
    at a row's end in the piece that filled it leaves the later rows 0);
    after the image, the chunks PIL's ``load_end`` walks must be whole up
    to IEND or a header it cannot read. Raises ``ValueError`` where PIL
    refuses the file, and over ``MAX_PIXELS`` pixels."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    n, pos, hdr, plte = len(data), 8, None, None
    while True:
        if pos + 8 > n:
            raise ValueError("PNG file ends before its image data")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if not _CID.match(tag):
            raise ValueError(f"broken PNG file (chunk {tag!r})")
        if tag in (b"IDAT", b"IEND"):   # the image data, or none (refused after the size)
            break
        if pos + 12 + length > n:
            raise ValueError("PNG file ends inside a chunk")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r} chunk")
        if tag == b"IHDR":
            if length < 13:
                raise ValueError("truncated IHDR chunk")
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            plte = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        pos += 12 + length
    if hdr is None:
        raise ValueError("PNG has no IHDR")
    w, h, depth, ctype, method, filt, interlace = hdr
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or method or filt
            or interlace > 1 or not w or not h):
        raise ValueError(f"bad PNG header (depth {depth}, colour type {ctype})")
    if w * h > MAX_PIXELS:
        raise ValueError(f"image of {w * h} pixels (PIL's decompression-bomb limit is "
                         f"{MAX_PIXELS})")
    if data[pos + 4:pos + 8] == b"IEND":
        raise ValueError("PNG without image data")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without a PLTE chunk")
    if ctype == 3 and len(plte) > 256:
        raise ValueError("PNG palette of more than 256 colours (PIL refuses it)")
    chans = _CHANNELS[ctype]
    bpp = max(1, chans * depth // 8)
    stride = lambda width: (width * chans * depth + 7) // 8  # noqa: E731
    passes = [(0, 0, 1, 1, w, h)] if not interlace else [
        (x0, y0, dx, dy, -(-(w - x0) // dx), -(-(h - y0) // dy)) for x0, y0, dx, dy in _ADAM7]
    passes = [q for q in passes if q[4] > 0 and q[5] > 0]
    ends = np.cumsum([stride(q[4]) + 1 for q in passes for _ in range(q[5])])
    need = int(ends[-1])
    # ZipDecode.c: rows inflated one at a time; the image ends when its
    # last row is filled, or when the stream ends in the call that filled a
    # row; a data error before then, or the data running out, is refused.
    z, raw, end_at = zlib.decompressobj(), bytearray(), None
    for a, b in _idat_pieces(data, pos):
        had = len(raw)
        try:
            raw += z.decompress(data[a:b], need - len(raw))
        except zlib.error as e:
            raise ValueError(f"PNG image data: {e}") from None
        if len(raw) == need or (z.eof and len(raw) > had and len(raw) in ends):
            end_at = b
            break
        if z.eof:
            break
    if end_at is None:
        raise ValueError("PNG image data ends early")
    raw = np.frombuffer(bytes(raw), np.uint8)
    img = np.zeros((h, w, chans), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph in passes:
        rows = min(ph, (len(raw) - at) // (stride(pw) + 1))
        if rows:
            img[y0:y0 + rows * dy:dy, x0::dx] = _samples(
                png_unfilter(raw, at, rows, stride(pw), bpp), pw, chans, depth)
        at += rows * (stride(pw) + 1)
    # PIL's load_end: past the image, each chunk's CRC skipped and its data
    # read whole, until IEND or a header cut short or not a chunk's name.
    p = end_at
    while True:
        p = min(p + 4, n)
        if p + 8 > n or not _CID.match(data[p + 4:p + 8]) or data[p + 4:p + 8] == b"IEND":
            break
        (length,) = struct.unpack(">I", data[p:p + 4])
        if p + 8 + length > n:
            raise ValueError("PNG file ends inside a chunk after the image data")
        p += 8 + length
    if ctype == 3:
        # Indices past the palette are black, as in PIL.
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(plte)] = plte[:256]
        return lut[img[..., 0]]
    if depth == 16:
        return (np.minimum(img, 255) if ctype == 0 else img >> 8).astype(np.uint8)
    if depth < 8:
        return img * np.uint8(255 // ((1 << depth) - 1))
    return img


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


def postprocess_binarize(images: np.ndarray, threshold: int = 128,
                         transparent: bool = False) -> np.ndarray:
    """Binarize uint8 images (N, H, W) or (N, H, W, 1): 255 above
    ``threshold``, else 0; with ``transparent`` an (N, H, W, 4) RGBA batch
    whose ink is opaque black and whose background is transparent (the
    panel's export post-processing, as in the JAX package)."""
    u8 = np.asarray(images, np.uint8)
    binary = np.where(u8 > threshold, 255, 0).astype(np.uint8)
    if not transparent:
        return binary
    gray = binary[..., 0] if binary.ndim == 4 and binary.shape[-1] == 1 else binary
    n, h, w = gray.shape
    rgba = np.zeros((n, h, w, 4), np.uint8)
    rgba[..., 3] = 255 - gray
    return rgba
