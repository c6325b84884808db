"""Files and checks of the formats of A.6.33-A.6.42 (DIB, ICO, CUR, TGA,
PCX, DCX, SGI, SUN, MSP, QOI) and of the damaged PNG data of C.25, for
``tests/test_torch_port_bmp_icons.py``, ``tests/test_torch_port_rle_rasters.py``
and ``scripts/raster_probe.py``: each kind from Pillow's writers where it
has one, else from ``chip_smoke.py``'s writers (no PIL); the damages of the
probe; the verdict of PIL's ``Image.open(path).convert("L")`` against the
port's ``decode_gray``."""

import io
import struct
import warnings

import numpy as np
from PIL import Image

import chip_smoke as cs
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.infer.export import _chunk, encode_png

# The formats the port reads, by PIL's name.
READ = {"BMP", "JPEG", "MPO", "PNG", "TIFF", "GIF", "PPM", "WEBP", "DIB", "TGA", "PCX", "DCX", "ICO",
        "CUR", "SGI", "SUN", "MSP", "QOI", "IM", "XBM", "XPM", "XVThumb", "PSD", "DDS", "FTEX", "BLP",
        "SPIDER"}


def image(h: int, w: int, bands: int = 0, seed: int = 5) -> np.ndarray:
    """Seeded uint8 stroke-like content: (h, w) grey, or (h, w, bands)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    g = (128 + 100 * np.sin(x / 3.0) * np.cos(y / 2.0) + rs.randn(h, w) * 20).clip(0, 255)
    g = g.astype(np.uint8)
    g[rs.rand(h, w) < 0.1] = 0
    if not bands:
        return g
    return np.dstack([g, 255 - g, g // 2, 200 - g // 3][:bands]).astype(np.uint8)


def pillow(a: np.ndarray, fmt: str, mode: str = None, **kw) -> bytes:
    """Pillow's ``fmt`` file of ``a`` (converted to ``mode``)."""
    b = io.BytesIO()
    im = Image.fromarray(a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (im.convert(mode) if mode else im).save(b, fmt, **kw)
    return b.getvalue()


def pil_verdict(path):
    """(format, grey) of PIL's ``Image.open(path).convert("L")``; grey None
    where PIL refuses the pixels, (None, None) where it opens nothing."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(path)
        except Exception:
            return None, None
        try:
            with im:
                return im.format, np.asarray(im.convert("L"))
        except Exception:
            return im.format, None


def holds(path, data: bytes):
    """The port reads ``data`` (written to ``path``) as PIL does: the same
    grey, or corrupt (``ValueError``) where PIL refuses it; a format the
    port does not read raises naming A.6. Returns PIL's (format, grey)."""
    path.write_bytes(data)
    fmt, want = pil_verdict(path)
    try:
        got = tdataset.decode_gray(path)
    except NotImplementedError as e:
        assert fmt is not None and fmt not in READ, f"{fmt}: {e}"
        return fmt, want
    except ValueError as e:
        assert want is None, f"PIL reads the {fmt} file, the port refuses it: {e}"
        return fmt, want
    assert want is not None, f"PIL refuses the {fmt} file, the port reads it"
    np.testing.assert_array_equal(got, want, err_msg=str(fmt))
    return fmt, want


def damage(rs, data: bytes) -> bytes:
    """One of six damages: bits flipped, bytes changed, the file cut, a
    header byte set to a telling value, bytes inserted, bytes deleted."""
    d, kind = bytearray(data), rs.randint(6)
    if kind == 0:
        for _ in range(rs.randint(1, 4)):
            d[rs.randint(len(d))] ^= 1 << rs.randint(8)
    elif kind == 1:
        for _ in range(rs.randint(1, 4)):
            d[rs.randint(len(d))] = rs.randint(256)
    elif kind == 2:
        d = d[:rs.randint(1, len(d))]
    elif kind == 3:
        d[rs.randint(min(len(d), 40))] = rs.choice([0, 1, 2, 3, 8, 16, 24, 32, 0x20, 0x80, 0xFF,
                                                    rs.randint(256)])
    elif kind == 4:
        i = rs.randint(len(d))
        d[i:i] = rs.randint(0, 256, rs.randint(1, 9)).astype(np.uint8).tobytes()
    else:
        i = rs.randint(len(d))
        del d[i:i + rs.randint(1, 9)]
    return bytes(d)


def probe(path, bases, seed: int, n: int) -> dict:
    """``n`` damaged files of ``bases`` in turns, each held to PIL's verdict
    (``holds``) -> {PIL's format or None: [read, refused]}."""
    rs, counts = np.random.RandomState(seed), {}
    for i in range(n):
        data = damage(rs, bases[i % len(bases)])
        try:
            fmt, want = holds(path, data)
        except AssertionError as e:
            raise AssertionError(f"damaged file {i} of seed {seed}: {e}") from None
        counts.setdefault(fmt, [0, 0])[want is None] += 1
    return counts


# -- bases: genuine files of each kind ----------------------------------------

def dib_bases() -> list:
    """Pillow's DIB in modes 1, L, P, RGB and RGBA; by hand a 4-bit palette,
    an OS/2 header, 16-bit 555 bitfields, 24-bit and RLE8."""
    out = []
    for h, w in ((5, 7), (8, 33), (3, 1)):
        for mode, bands in (("1", 0), ("L", 0), ("P", 3), ("RGB", 3), ("RGBA", 4)):
            out.append(pillow(image(h, w, bands), "DIB", mode))
    g = image(4, 9)
    pal = np.repeat(np.arange(16, dtype=np.uint8) * 17, 4).reshape(16, 4)
    pal[:, 3] = 0
    out.append(cs.dib_bytes(cs.dib_rows(g >> 4, 4), 9, 4, 4, pal.tobytes()))
    out.append(cs.dib_bytes(cs.dib_rows(g, 8), 9, 4, 8,
                            np.repeat(np.arange(256, dtype=np.uint8)[::-1], 3).tobytes(), header=12))
    g16 = g.astype(np.uint16)
    px16 = ((g16 >> 3) << 10 | (g16 >> 2 & 31) << 5 | (g16 >> 4)).astype("<u2")
    rows16 = b"".join(np.pad(r.view(np.uint8), (0, -r.nbytes % 4)).tobytes() for r in px16[::-1])
    out.append(cs.dib_bytes(rows16, 9, 4, 16, compression=3,
                            masks=struct.pack("<III", 0x7C00, 0x3E0, 0x1F)))
    out.append(cs.dib_bytes(cs.dib_rows(np.repeat(g[..., None], 3, 2), 24), 9, 4, 24))
    rle = b"".join(bytes([2, v, 0, 3, a, 5 + v, 9, 0, 0, 0]) for v, a in zip(range(4), (1, 2, 3, 4)))
    out.append(cs.dib_bytes(rle + b"\x00\x01", 5, 4, 8,
                            np.repeat((np.arange(256) * 7 % 256).astype(np.uint8), 4).tobytes(),
                            compression=1))
    return out


def bmp_bases() -> list:
    """Pillow's BMP in modes 1, L, P, RGB and RGBA, and hand-built DIBs
    behind a file header whose pixel offset is 0 (C.23)."""
    out = [pillow(image(h, w, bands), "BMP", mode) for h, w in ((5, 7), (8, 33))
           for mode, bands in (("1", 0), ("L", 0), ("P", 3), ("RGB", 3), ("RGBA", 4))]
    return out + [b"BM" + struct.pack("<IHHI", 14 + len(d), 0, 0, 0) + d for d in dib_bases()[-5:]]


def ico_bases() -> list:
    """Pillow's ICO (PNG icons, and ``bitmap_format="bmp"``: 1, 8, 24 and
    32 bits) of two sizes, and hand-built directories of bitmaps at 1, 4, 8
    and 24 bits in either order, by colour count, and of PNG icons."""
    out = []
    for mode, bands in (("RGBA", 4), ("RGB", 3), ("P", 3), ("L", 0), ("1", 0)):
        a = image(20, 20, bands)
        out.append(pillow(a, "ICO", mode, sizes=[(16, 16), (8, 8)], bitmap_format="bmp"))
        out.append(pillow(a, "ICO", mode, sizes=[(16, 16)]))
    g = image(6, 9)
    icons = [(9, 6, 0, 1, bits, cs.icon_dib(g, bits)) for bits in (1, 4, 8, 24)]
    out += [cs.ico_file(icons), cs.ico_file(icons[::-1]),
            cs.ico_file([(9, 6, 16, 1, 0, cs.icon_dib(g, 4)), (9, 6, 2, 1, 0, cs.icon_dib(g, 1)),
                         (5, 5, 0, 1, 8, cs.icon_dib(g[:5, :5], 8))]),
            cs.ico_file([(9, 6, 0, 1, 32, encode_png(g)), (4, 4, 0, 1, 8, cs.icon_dib(g[:4, :4], 8))]),
            cs.ico_file([(0, 0, 0, 1, 32, encode_png(image(12, 15)))])]
    return out


def cur_bases() -> list:
    """Hand-built cursors (Pillow writes none) at 1, 4, 8 and 24 bits, and
    a directory whose second and third entries PIL's choice weighs."""
    g = image(6, 9)
    out = [cs.ico_file([(9, 6, 0, 1, 0, cs.icon_dib(g, bits))], b"\0\0\2\0") for bits in (1, 4, 8, 24)]
    return out + [cs.ico_file([(4, 4, 0, 1, 0, cs.icon_dib(g[:4, :4], 8)),
                               (9, 6, 0, 1, 0, cs.icon_dib(g, 8)),
                               (9, 7, 0, 1, 0, cs.icon_dib(image(7, 9, seed=2), 4))], b"\0\0\2\0")]


def tga_16(g) -> np.ndarray:
    """(h, w, 2) little-endian 5-5-5 pixel bytes of a grey."""
    g16 = g.astype(np.uint16)
    px = (g16 >> 3) << 10 | (g16 >> 3) << 5 | (255 - g16) >> 3
    return px.astype("<u2").view(np.uint8).reshape(*g.shape, 2)


def tga_bases() -> list:
    """Pillow's TGA in modes L, P, RGB, RGBA, LA and 1, raw and RLE, both
    orientations; by hand 16-bit pixels, colour maps from an index past 0
    and of 16-bit entries, right-to-left rows, RLE packets kept to a row."""
    out = []
    for mode, bands in (("L", 0), ("P", 3), ("RGB", 3), ("RGBA", 4), ("LA", 2), ("1", 0)):
        for rle in (False, True):
            for orientation in (1, -1):
                if mode == "1" and rle:
                    continue
                out.append(pillow(image(7, 11, bands), "TGA", mode, rle=rle, orientation=orientation))
    g = image(6, 10)
    cmap = (np.arange(60) * 4).astype(np.uint8).tobytes()
    out += [cs.tga_file(tga_16(g), 2, 16), cs.tga_file(tga_16(g), 10, 16, flags=0x10),
            cs.tga_file(g // 20 + 3, 1, 8, colormap=cmap, start=3, flags=0x30, image_id=b"hello"),
            cs.tga_file(g // 20 + 3, 9, 8, colormap=cmap, start=3, flags=0, cross_rows=False),
            cs.tga_file(g // 20, 9, 8, colormap=(np.arange(40) * 6).astype(np.uint8).tobytes(),
                        map_depth=16),
            cs.tga_file(np.dstack([g, g // 3, 255 - g]), 10, 24, flags=0x10)]
    return out


def pcx_planes(g, planes: int, stride: int = None, version: int = 5) -> bytes:
    """A PCX of 1-bit ``planes`` (2 or 4) of a grey's levels, a 16-colour
    header palette."""
    h, w = g.shape
    idx = g.astype(int) * (1 << planes) // 256
    rows = [[np.packbits((r >> k) & 1).tobytes() for k in range(planes)] for r in idx]
    return cs.pcx_file(rows, w, h, 1, planes, version=version,
                       header_palette=(np.arange(48) * 5).astype(np.uint8).tobytes(), stride=stride)


def pcx_bases() -> list:
    """Pillow's PCX in modes 1, L, P and RGB (an odd width among them); by
    hand 2 and 4 planes of 1 bit (even and odd header strides), a grey
    ramp and a palette at 8 bits."""
    out = [pillow(image(h, w, bands), "PCX", mode) for mode, bands in (("1", 0), ("L", 0), ("P", 3), ("RGB", 3))
           for h, w in ((5, 7), (6, 16))]
    g = image(6, 13)
    for planes in (2, 4):
        out += [pcx_planes(g, planes), pcx_planes(g, planes, stride=2, version=2)]
    return out + [cs.pcx_grey(g), cs.pcx_grey(g, palette=(np.arange(768) * 7 % 256).astype(np.uint8).tobytes())]


def dcx_bases() -> list:
    """DCX files of two PCX pages each, and of one."""
    p = pcx_bases()
    return [cs.dcx_file([p[i], p[i + 1]]) for i in range(0, len(p) - 1, 2)] + [cs.dcx_file([p[3]])]


def sgi_bases() -> list:
    """Pillow's SGI in modes L, RGB and RGBA at 8 and 16 bits a channel; by
    hand RLE at 8 and 16 bits for 1, 3 and 4 channels, raw 16-bit, and a
    one-dimensional grey image."""
    out = []
    for mode, bands in (("L", 0), ("RGB", 3), ("RGBA", 4)):
        for bpc in (1, 2):
            out.append(pillow(image(5, 9, bands), "SGI", mode, bpc=bpc))
    g = image(5, 9).astype(np.int64)
    for z in (1, 3, 4):
        ch = np.stack([g, 255 - g, g // 2, g // 3][:z])
        out += [cs.sgi_file(ch, 1, rle=True), cs.sgi_file((ch * 257) ^ 5, 2, rle=True),
                cs.sgi_file(ch * 257, 2)]
    return out + [cs.sgi_file(g[None], 1, dimension=1)]


def sun_nibbles(g) -> list:
    """Rows of 4-bit samples (a grey's high nibbles), two a byte."""
    n4 = np.pad(g >> 4, ((0, 0), (0, g.shape[1] % 2)))
    return [((r[0::2] << 4) | r[1::2]).astype(np.uint8).tobytes() for r in n4]


def sun_bases() -> list:
    """Hand-built Sun rasters (Pillow writes none), raw (types 1 and 3) and
    RLE (type 2), at 1, 4, 8, 24 and 32 bits, 4 and 8 bits with a palette."""
    g, out = image(5, 11), []
    for ft in (1, 2, 3):
        out += [cs.sun_file([r.tobytes() for r in g], 11, 5, 8, file_type=ft),
                cs.sun_file([np.packbits(r > 128).tobytes() for r in g], 11, 5, 1, file_type=ft),
                cs.sun_file(sun_nibbles(g), 11, 5, 4, file_type=ft),
                cs.sun_file([r.tobytes() for r in image(5, 11, 3)], 11, 5, 24, file_type=ft),
                cs.sun_file([r.tobytes() for r in image(5, 11, 4)], 11, 5, 32, file_type=ft),
                cs.sun_file([r.tobytes() for r in g], 11, 5, 8, file_type=ft,
                            palette=(np.arange(768) * 3 % 256).astype(np.uint8).tobytes()),
                cs.sun_file(sun_nibbles(g), 11, 5, 4, file_type=ft, palette=bytes(range(48)))]
    return out


def msp_bases() -> list:
    """Pillow's MSP (version 1) and hand-built version 1 and 2 files, one of
    a single inked row."""
    ink = image(7, 21) < 100
    line = np.zeros((5, 30), bool)
    line[2] = True
    return [pillow(np.where(ink, 0, 255).astype(np.uint8), "MSP", "1"), cs.msp_file(ink, 1),
            cs.msp_file(ink, 2), cs.msp_file(line, 2)]


def qoi_bases() -> list:
    """Pillow's QOI and the writer's, of RGB and RGBA with a run."""
    out = []
    for bands in (3, 4):
        a = image(6, 10, bands)
        a[:, 3:6] = a[0, 0]
        out += [pillow(a, "QOI"), cs.qoi_file(a)]
    return out


def png_bases() -> list:
    """Pillow's PNG in modes L, RGB, RGBA, P, 1, LA and 16-bit grey, a page
    of several IDAT chunks, and by hand chunks after the image data and
    the data split over IDAT chunks (one empty)."""
    import zlib
    out = [pillow(image(12, 17, bands), "PNG", mode) for mode, bands in
           (("L", 0), ("RGB", 3), ("RGBA", 4), ("P", 3), ("1", 0), ("LA", 0))]
    out += [pillow(image(12, 17).astype(np.uint16) * 200, "PNG"), pillow(image(300, 400, 3), "PNG")]
    b = pillow(image(20, 30, 3), "PNG")
    i = b.index(b"IEND") - 4
    out.append(b[:i] + _chunk(b"tEXt", b"Comment\0scan") + _chunk(b"zzIp", bytes(9)) + b[i:])
    raw = zlib.compress(b"".join(b"\0" + r.tobytes() for r in image(20, 30)))
    head = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", 30, 20, 8, 0, 0, 0, 0))
    out.append(head + _chunk(b"IDAT", raw[:10]) + _chunk(b"IDAT", b"") + _chunk(b"IDAT", raw[10:])
               + _chunk(b"IEND", b""))
    return out


BASES = {"DIB": dib_bases, "BMP": bmp_bases, "ICO": ico_bases, "CUR": cur_bases, "TGA": tga_bases,
         "PCX": pcx_bases, "DCX": dcx_bases, "SGI": sgi_bases, "SUN": sun_bases, "MSP": msp_bases,
         "QOI": qoi_bases, "PNG": png_bases}
