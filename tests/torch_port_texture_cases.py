"""Files of the formats of A.6.49-A.6.55 (DDS, FTEX, BLP, SPIDER) for
``tests/test_torch_port_textures.py``, ``tests/test_torch_port_spider.py``
and ``scripts/raster_probe.py``: Pillow's files where Pillow writes the
format (DDS uncompressed and DXT1/3/5, BC2/3/5; BLP palettes), else
``chip_smoke.py``'s writers (no PIL), each in the routes PIL's plugins
take; the checks are ``tests/torch_port_raster_cases.py``'s (``holds``:
the port's grey bit-equal with PIL's ``Image.open(path).convert("L")``,
corrupt where PIL refuses the file). DDS is split by route: DDS-RGB
(``DdsRgbDecoder``), DDS-LP (luminance, luminance + alpha, a palette,
DX10's RGBA), DDS-BC1-5, DDS-BC6H and DDS-BC7 (Pillow's bcn decoder)."""

import io
import struct

import numpy as np
from PIL import Image
from test_torch_port_cmyk import ycck_bytes
from torch_port_raster_cases import image

import chip_smoke as cs


def blocks(seed: int, w: int, h: int, size: int) -> bytes:
    """Seeded random block data for a ``w`` x ``h`` image, ``size`` bytes a
    4 x 4 block (every BC4, BC5, BC6H and BC7 block decodes)."""
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (-(-w // 4)) * (-(-h // 4)) * size).astype(np.uint8).tobytes()


def bc6h_blocks(seed: int, w: int, h: int) -> bytes:
    """Random BC6H blocks, their modes in turns over the 14 valid ones and
    the four reserved (mode bits 10011, 10111, 11011, 11111)."""
    modes = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31]
    b = np.frombuffer(blocks(seed, w, h, 16), np.uint8).reshape(-1, 16).copy()
    m = np.array([modes[i % len(modes)] for i in range(len(b))])
    b[:, 0] = np.where(m < 2, b[:, 0] & 0xFC | m, b[:, 0] & 0xE0 | m)
    return b.tobytes()


def bc7_blocks(seed: int, w: int, h: int) -> bytes:
    """Random BC7 blocks, their modes in turns over 0 .. 7 and the reserved
    first byte of 0."""
    b = np.frombuffer(blocks(seed, w, h, 16), np.uint8).reshape(-1, 16).copy()
    for i in range(len(b)):
        mode = i % 9
        b[i, 0] = 0 if mode == 8 else (b[i, 0] >> (mode + 1) << (mode + 1)) | 1 << mode
    return b.tobytes()


def dds_pillow(a: np.ndarray, pixel_format: str = None) -> bytes:
    """Pillow's DDS of ``a`` (uncompressed, or through its bcn encoder)."""
    b = io.BytesIO()
    Image.fromarray(a).save(b, "DDS", **({"pixel_format": pixel_format} if pixel_format else {}))
    return b.getvalue()


def rgb_masked(a: np.ndarray, masks, bits: int) -> bytes:
    """(h, w, 3 or 4) uint8 channels packed into ``bits``-bit little-endian
    pixels under ``masks``, each value scaled to its mask's width."""
    out = np.zeros(a.shape[:2], np.int64)
    for c, m in enumerate(masks):
        if not m:
            continue
        shift = (m & -m).bit_length() - 1
        total = m >> shift
        out |= ((a[..., c].astype(np.int64) * total // 255) << shift) & m
    return out.astype("<u8").view(np.uint8).reshape(*out.shape, 8)[..., :bits // 8].tobytes()


def dds_rgb_bases() -> list:
    """DdsRgbDecoder's files: Pillow's RGB and RGBA, by hand 16-bit 565
    and 4444, 24-bit, 32-bit masks off byte boundaries (R 0b11 << 3 ...), a
    zero mask, masks that overlap, and a file cut short (read on as 0)."""
    out = [dds_pillow(image(5, 7, 3)), dds_pillow(image(6, 9, 4))]
    a3, a4 = image(6, 9, 3), image(5, 7, 4)
    for bits, masks in ((16, (0xF800, 0x7E0, 0x1F)), (16, (0xF00, 0xF0, 0xF, 0xF000)),
                        (24, (0xFF0000, 0xFF00, 0xFF)), (32, (0x18, 0x7E00, 0x3F00000, 0xC0000000)),
                        (32, (0xFF, 0, 0xFF0000)), (32, (0xFFF0, 0xFF00, 0x0FF0)), (8, (0xE0, 0x1C, 0x3))):
        a = a4 if len(masks) == 4 else a3
        h, w = a.shape[:2]
        out.append(cs.dds_file(w, h, rgb_masked(a, masks, bits), flags=0x40 | (len(masks) == 4),
                               bits=bits, masks=(*masks, 0)[:4]))
    out.append(out[3][:-17])
    return out


def dds_lp_bases() -> list:
    """Luminance (Pillow's L and LA), a palette of 1024 RGBA bytes, and
    DX10's R8G8B8A8 (UNORM, and SRGB, which only sets a gamma)."""
    g = image(6, 9)
    pal = np.concatenate([np.arange(256)[:, None], 255 - np.arange(256)[:, None], (np.arange(256) // 2)[:, None],
                          np.full((256, 1), 255)], 1).astype(np.uint8).tobytes()
    rgba = image(5, 7, 4)
    return [dds_pillow(g), dds_pillow(image(6, 9, 2)),
            cs.dds_file(9, 6, g.tobytes(), flags=0x20, palette=pal),
            cs.dds_file(7, 5, rgba.tobytes(), fourcc=b"DX10", dx10=28),
            cs.dds_file(7, 5, rgba.tobytes(), fourcc=b"DX10", dx10=29)]


def dds_bc_bases() -> list:
    """Pillow's bcn encoder (DXT1, DXT3, DXT5, BC2, BC3, BC5) at sizes on
    and off a multiple of 4, and random blocks of each FourCC and DX10
    name of BC1-BC5 (BC4U, ATI1, BC5U, ATI2, BC5S, BC5_SNORM)."""
    out = []
    for h, w in ((8, 12), (6, 9)):
        out += [dds_pillow(image(h, w, 4), f) for f in ("DXT1", "DXT3", "DXT5", "BC2", "BC3")]
        out.append(dds_pillow(image(h, w, 3), "BC5"))
    for i, (cc, dx, size) in enumerate(((b"DXT1", None, 8), (b"DXT3", None, 16), (b"DXT5", None, 16),
                                        (b"BC4U", None, 8), (b"ATI1", None, 8), (b"BC5U", None, 16),
                                        (b"ATI2", None, 16), (b"BC5S", None, 16), (b"DX10", 80, 8),
                                        (b"DX10", 84, 16), (b"DX10", 71, 8), (b"DX10", 77, 16))):
        w, h = 5 + i % 4, 3 + i % 6
        out.append(cs.dds_file(w, h, blocks(i, w, h, size), fourcc=cc, dx10=dx))
    return out


def dds_bc6h_bases() -> list:
    """Random BC6H blocks, unsigned (UF16) and signed (SF16), every mode."""
    return [cs.dds_file(w, h, bc6h_blocks(10 * s + w, w, h), fourcc=b"DX10", dx10=95 + s)
            for s in (0, 1) for w, h in ((8, 8), (7, 5), (12, 9))]


def dds_bc7_bases() -> list:
    """Random BC7 blocks of every mode and the reserved one (UNORM, SRGB,
    TYPELESS), and ``chip_smoke.bc7_grey``'s mode 6 encoding."""
    out = [cs.dds_file(w, h, bc7_blocks(w * h + dx, w, h), fourcc=b"DX10", dx10=dx)
           for dx, (w, h) in ((98, (12, 12)), (99, (7, 5)), (97, (9, 10)))]
    g = image(10, 13)
    return out + [cs.dds_file(13, 10, cs.bc7_grey(g)[0], fourcc=b"DX10", dx10=98)]


def ftex_bases() -> list:
    """FTEX: raw RGB and DXT1 (Pillow's encoder's blocks and
    ``chip_smoke.bc1_grey``'s), a mipmap of a negative size (the rest of the
    file) and one longer than its data."""
    rgb = image(5, 7, 3)
    dxt1 = dds_pillow(image(6, 9, 4), "DXT1")[128:]
    return [cs.ftex_file(7, 5, rgb.tobytes(), 1), cs.ftex_file(9, 6, dxt1, 0),
            cs.ftex_file(13, 10, cs.bc1_grey(image(10, 13))[0], 0),
            cs.ftex_file(7, 5, rgb.tobytes(), 1, size=-1), cs.ftex_file(9, 6, dxt1, 0, size=len(dxt1) + 9)]


def blp_pillow(a: np.ndarray, version: str, alpha: bool = False) -> bytes:
    """Pillow's BLP (mode P: an adaptive palette, RGBA where ``alpha``)."""
    im = Image.fromarray(a)
    im = im.convert("P", palette=Image.Palette.ADAPTIVE) if not alpha else im.convert("P")
    if alpha:
        im.palette.mode = "RGBA"
        im.putpalette(bytes(range(256)) * 4, "RGBA")
    b = io.BytesIO()
    im.save(b, "BLP", blp_version=version)
    return b.getvalue()


def jpeg_parts(data: bytes) -> tuple:
    """A JPEG split before its first SOS segment: (header, the rest)."""
    at = data.index(b"\xff\xda")
    return data[:at], data[at:]


def pil_jpeg(a: np.ndarray, mode: str = None, **kw) -> bytes:
    b = io.BytesIO()
    im = Image.fromarray(a)
    (im.convert(mode) if mode else im).save(b, "JPEG", quality=85, **kw)
    return b.getvalue()


def blp1_jpeg(jpeg: bytes, w: int, h: int, **kw) -> bytes:
    """BLP1 of a JPEG: its header before the mipmap table's first entry."""
    head, rest = jpeg_parts(jpeg)
    return cs.blp_file(w, h, rest, version=1, compression=0, jpeg_header=head, **kw)


def blp_bases() -> list:
    """Pillow's BLP1 and BLP2 (palettes, RGB and RGBA); by hand BLP2 DXT1
    (with and without alpha), DXT3 and DXT5 at widths on and off a
    multiple of 4, BLP1 encoding 4, and BLP1 JPEGs: grey, YCbCr, CMYK,
    YCCK, with alpha, a gap before the mipmap, an offset
    behind the header (no skip back) and a JPEG wider than the image."""
    rgb = image(6, 9, 3)
    out = [blp_pillow(rgb, "BLP1"), blp_pillow(rgb, "BLP2"), blp_pillow(image(5, 7, 4), "BLP2", alpha=True)]
    for i, (enc, a) in enumerate(((0, 0), (0, 8), (1, 0), (1, 8), (7, 0), (7, 8))):
        w, h = (9, 6) if i % 2 else (8, 5)
        out.append(cs.blp_file(w, h, blocks(40 + i, w, h, 8 if enc == 0 else 16), encoding=2, alpha=a,
                               alpha_encoding=enc))
    g = image(6, 9)
    out.append(cs.blp_file(9, 6, g.tobytes(), version=1, encoding=4))
    grey, ycc, cmyk = pil_jpeg(g), pil_jpeg(rgb), pil_jpeg(rgb, "CMYK")
    out += [blp1_jpeg(grey, 9, 6), blp1_jpeg(ycc, 9, 6), blp1_jpeg(cmyk, 9, 6),
            blp1_jpeg(ycck_bytes(image(8, 16, 4), ((2, 2), (1, 1), (1, 1), (2, 2)), 85), 16, 8),
            blp1_jpeg(ycc, 9, 6, alpha=8),
            blp1_jpeg(ycc, 9, 6, gap=b"junk"), blp1_jpeg(ycc, 9, 6, offset=3), blp1_jpeg(ycc, 7, 6)]
    return out


def spider_values(h: int, w: int, seed: int = 5) -> np.ndarray:
    """Floats past 0 .. 255 both ways, fractions, NaN, +-inf and values
    past int32's range."""
    v = image(h, w, seed=seed).astype(np.float32) * 1.3 - 30.7
    v.flat[::7] = np.nan
    v.flat[1::11] = np.inf
    v.flat[2::13] = -np.inf
    v.flat[3::17] = 3e9
    v.flat[4::19] = -3e9
    return v


def spider_bases() -> list:
    """SPIDER 2D images big- and little-endian, a stack's first image, and
    header fields that PIL passes on, refuses or reads."""
    v = spider_values(6, 9)
    return [cs.spider_file(v), cs.spider_file(v, False), cs.spider_file(v, stack=2),
            cs.spider_file(v, False, stack=1), cs.spider_file(image(5, 7).astype(np.float32)),
            cs.spider_file(v, fields={13: 3, 22: 3 * 36})]


# PIL's DdsRgbDecoder is Python, about 3 us a pixel: a damaged size can
# make it loop for hours over a file of 100 bytes.
PIL_SLOW_PIXELS = 1 << 22


def pil_slow(data: bytes) -> bool:
    """Whether ``data`` is a DDS of the RGB route that PIL's Python decoder
    would read over more than ``PIL_SLOW_PIXELS`` pixels (within the bomb
    limit): the probe counts such files apart and does not hold them."""
    if len(data) < 128 or data[:4] != b"DDS " or not struct.unpack_from("<I", data, 80)[0] & 0x40:
        return False
    h, w = struct.unpack_from("<II", data, 12)
    return PIL_SLOW_PIXELS < w * h <= 2 * (1024 * 1024 * 1024 // 4 // 3)


BASES = {"DDS-RGB": dds_rgb_bases, "DDS-LP": dds_lp_bases, "DDS-BC1-5": dds_bc_bases,
         "DDS-BC6H": dds_bc6h_bases, "DDS-BC7": dds_bc7_bases, "FTEX": ftex_bases, "BLP": blp_bases,
         "SPIDER": spider_bases}
