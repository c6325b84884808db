"""Files of the formats of A.6.43-A.6.47 (IM, XBM, XPM, XV thumbnail, PSD)
for ``tests/test_torch_port_text_rasters.py``, ``tests/test_torch_port_psd.py``
and ``scripts/raster_probe.py``: Pillow's files where Pillow writes the
format (IM, XBM), else ``chip_smoke.py``'s writers (no PIL), each in the
modes and layouts PIL's plugin takes; the checks are
``tests/torch_port_raster_cases.py``'s (``holds``: the port's grey
bit-equal with PIL's ``Image.open(path).convert("L")``, corrupt where PIL
refuses the file)."""

import io
import struct

import numpy as np
from PIL import Image, ImImagePlugin
from torch_port_raster_cases import image, pillow

import chip_smoke as cs

# Pillow's IM writer: the modes it saves.
IM_SAVES = ("1", "L", "P", "LA", "PA", "I", "F", "I;16", "I;16L", "I;16B", "RGB", "RGBA", "RGBX",
            "CMYK", "YCbCr")

# The Lut palettes: a grey ramp (linear), an inverted ramp (grey, not
# linear: PIL keeps it and never applies it) and colours.
LUTS = {"linear": np.tile(np.arange(256, dtype=np.uint8), 3).tobytes(),
        "inverted": np.tile(np.arange(256, dtype=np.uint8)[::-1], 3).tobytes(),
        "colour": np.concatenate([np.arange(256), 255 - np.arange(256), np.arange(256) // 2 + 64])
        .astype(np.uint8).tobytes()}


def im_pillow(h: int, w: int, mode: str, seed: int = 5) -> bytes:
    """Pillow's IM file of a seeded image in ``mode`` (I and F of values
    below 0 and past 255)."""
    g = image(h, w, seed=seed).astype(np.int64)
    rgb = Image.fromarray(image(h, w, 3, seed))
    if mode in ("I", "F"):
        im = Image.fromarray((g * 3 - 100).astype(np.int32 if mode == "I" else np.float32))
    elif mode.startswith("I;16"):
        im = Image.fromarray((g * 2).astype(np.uint16))
        im = im if mode == "I;16" else im.convert(mode)
    elif mode in ("1", "L"):
        im = Image.fromarray(g.astype(np.uint8)).convert(mode)
    elif mode in ("LA", "RGBA"):
        im = Image.fromarray(image(h, w, len(mode), seed))
    elif mode == "PA":
        im = rgb.convert("P").convert("PA")
    else:
        im = rgb.convert(mode)
    b = io.BytesIO()
    im.save(b, "IM")
    return b.getvalue()


def im_sizes(name: str, w: int, h: int) -> int:
    """The bytes the pixels of an IM file of OPEN name ``name`` take."""
    mode, raw = ImImagePlugin.OPEN[name]
    bits = {"1": 1, "P;2": 2, "P;4": 4, "L": 8, "P": 8, "F;8": 8, "F;8S": 8}.get(raw)
    if raw.startswith("F;") and raw[2:].isdigit():
        bits = int(raw[2:])
    if bits is None:
        bits = {"RGB;T": 24, "RYB;T": 24, "RGB": 24, "RGB;L": 24, "YCbCr;L": 24, "LA;L": 16, "PA;L": 16,
                "I;16": 16, "I;16L": 16, "I;16B": 16, "F;16S": 16}.get(raw, 32)
    return (w * bits + 7) // 8 * h


def im_bases() -> list:
    """Pillow's IM in each mode it saves; by hand a file of every OPEN name
    of ImImagePlugin (its data exactly long enough), under each Lut, and of
    a mode given after an OPEN name (mode and raw mode apart)."""
    out = [im_pillow(h, w, mode) for mode in IM_SAVES for h, w in ((5, 7), (4, 13))]
    rs = np.random.RandomState(11)
    for i, name in enumerate(sorted(ImImagePlugin.OPEN)):
        w, h = 3 + i % 9, 2 + i % 4
        data = rs.randint(0, 256, im_sizes(name, w, h)).astype(np.uint8).tobytes()
        out.append(cs.im_file(name, data, w, h))
        if i % 3 == 0:
            out.append(cs.im_file(name, data, w, h, lut=list(LUTS.values())[i // 3 % 3]))
    for name, mode in (("L 16 image", "I"), ("RGB image", "RGBX"), ("Greyscale image", "P"),
                       ("RGBA image", "RGB"), ("B4 image", "P")):
        w, h = 6, 3
        data = rs.randint(0, 256, 4 * w * h).astype(np.uint8).tobytes()
        out.append(cs.im_file(name, data, w, h, lines=[f"Image type: {mode}"]))
    return out


def xbm_bases() -> list:
    """Pillow's XBM, with and without a hot spot, of widths on and off a
    byte; by hand upper-case hex, one token a line, CR LF lines."""
    out = []
    for h, w in ((5, 7), (4, 16), (3, 1)):
        a = image(h, w) > 120
        out.append(pillow(np.where(a, 255, 0).astype(np.uint8), "XBM", "1"))
        out.append(pillow(np.where(a, 255, 0).astype(np.uint8), "XBM", "1", hotspot=(1, 2)))
    a = image(6, 11) > 100
    out += [cs.xbm_file(a, upper=True), cs.xbm_file(a, per_line=1, hotspot=(3, 4)),
            cs.xbm_file(a, name="x").replace(b"\n", b"\r\n")]
    return out


def xpm_bases() -> list:
    """Hand-built pixmaps (Pillow writes none): mode P of 1- and 2-character
    keys, a None colour, a key given twice, no "/* pixels */" line; mode RGB
    (more than 256 colours)."""
    g = image(6, 9)
    idx = (g // 64).astype(np.int64)
    cols = [(v, 255 - v, v // 2) for v in (0, 90, 180, 255)]
    out = [cs.xpm_file(idx, cols), cs.xpm_file(idx, cols, chars=2),
           cs.xpm_file(idx, cols + [None], pixels_comment=False),
           cs.xpm_file(idx, cols + [(1, 2, 3)], keys=["a", "b", "c", "d", "a"])]
    big = (np.arange(20 * 15).reshape(15, 20) % 300).astype(np.int64)
    out.append(cs.xpm_file(big, [(k % 256, k * 7 % 256, k * 13 % 256) for k in range(300)], chars=2))
    return out


def xv_bases() -> list:
    """XV thumbnails (Pillow writes none), with and without comments."""
    return [cs.xv_thumb(cs.xv_index(image(5, 9))), cs.xv_thumb(image(4, 7, seed=2), comments=()),
            cs.xv_thumb(np.arange(256, dtype=np.uint8).reshape(8, 32))]


def psd_bases() -> list:
    """Photoshop files (Pillow writes none) of every MODES entry, raw and
    PackBits, RGB of 3 and 4 channels (RGBA) and 5, CMYK of 5, a palette
    of 768 bytes and of another size, image resources and a layer section
    before the composite."""
    g = image(5, 9)
    bits = np.packbits(g > 120, axis=1)
    out = []
    for comp in (0, 1):
        out += [cs.psd_file([bits], 0, bits=1, compression=comp),
                cs.psd_file([g], 0, compression=comp), cs.psd_file([g], 1, compression=comp),
                cs.psd_file([g // 4], 2, compression=comp, mode_data=LUTS["colour"]),
                cs.psd_file([g], 2, compression=comp, mode_data=bytes(30)),
                cs.psd_file([g, 255 - g, g // 2], 3, compression=comp),
                cs.psd_file([g, 255 - g, g // 2, g // 3], 3, compression=comp),
                cs.psd_file([g, 255 - g, g // 2, g // 3, g], 3, compression=comp),
                cs.psd_file([g, 255 - g, g // 2, g // 3], 4, compression=comp),
                cs.psd_file([g, 255 - g, g // 2, g // 3, g], 4, compression=comp),
                cs.psd_file([g, g // 2], 7, compression=comp), cs.psd_file([g], 8, compression=comp),
                cs.psd_file([g, g, g], 9, compression=comp)]
    res = b"8BIM" + struct.pack(">H", 1005) + b"\x03abc" + struct.pack(">I", 3) + b"xyz\0"
    layers = struct.pack(">I", 10) + bytes(10)
    out += [cs.psd_file([g], 1, resources=res, layers=layers),
            cs.psd_file([g, 255 - g, g // 2], 3, compression=1, resources=res, layers=layers)]
    return out


BASES = {"IM": im_bases, "XBM": xbm_bases, "XPM": xpm_bases, "XVThumb": xv_bases, "PSD": psd_bases}
