"""Files of the formats of A.6.56-A.6.63 (PIXAR, GBR, McIdas, IMT, FITS,
IPTC, FLI, PCD) for ``tests/test_torch_port_plain_headers.py``,
``tests/test_torch_port_fits.py``, ``tests/test_torch_port_fli.py``,
``tests/test_torch_port_iptc_pcd.py`` and ``scripts/raster_probe.py``:
``chip_smoke.py``'s writers (no PIL; Pillow writes none of these formats)
and Pillow's JPEG writer for what an IPTC file holds, each in the
routes PIL's plugins take; the checks are
``tests/torch_port_raster_cases.py``'s (``holds``: the port's grey
bit-equal with PIL's ``Image.open(path).convert("L")``, corrupt where PIL
refuses the file). FITS is split by route (FITS-RAW, FITS-GZIP), and so
is IPTC (IPTC-RAW, IPTC-JPEG)."""

import io

import numpy as np
from PIL import Image
from torch_port_raster_cases import image

import chip_smoke as cs


def pixar_bases() -> list:
    """PIXAR RGB at a few sizes, one with bytes past its pixels, one whose
    channel / depth pair is not PIL's RGB (passed on)."""
    return [cs.pixar_file(image(5, 7, 3)), cs.pixar_file(image(9, 6, 3)),
            cs.pixar_file(image(4, 11, 3)) + b"tail", cs.pixar_file(image(5, 7, 3), mode=(14, 1))]


def gbr_bases() -> list:
    """GIMP brushes: versions 1 and 2, depth 1 (L) and 4 (RGBA), an empty
    comment, and version 2 with a header size below 28 (the comment reads
    the rest of the file)."""
    return [cs.gbr_file(image(5, 7), 1), cs.gbr_file(image(5, 7)), cs.gbr_file(image(6, 4, 4), 1),
            cs.gbr_file(image(6, 4, 4), comment=b""), cs.gbr_file(image(3, 9), header_size=24)]


def mcidas_values(h: int, w: int, size: int) -> np.ndarray:
    """Samples of 1, 2 or 4 bytes: grey levels, and for 2 and 4 bytes
    values past 255 (and, for 4, negative ones) too."""
    g = image(h, w).astype(np.int64)
    if size == 1:
        return g.astype(np.uint8)
    if size == 2:
        return np.where(g % 3 == 0, g * 200, g).astype(np.uint16)
    return np.where(g % 3 == 0, g * 70000, np.where(g % 3 == 1, -g, g)).astype(np.int32)


def mcidas_bases() -> list:
    """McIdas areas of 1, 2 and 4 bytes an element, with a line prefix and
    with a second band."""
    return [cs.mcidas_file(mcidas_values(5, 7, 1)), cs.mcidas_file(mcidas_values(5, 7, 2), prefix=4),
            cs.mcidas_file(mcidas_values(6, 5, 4), prefix=3), cs.mcidas_file(mcidas_values(4, 6, 1), bands=2),
            cs.mcidas_file(mcidas_values(4, 6, 2), bands=2, prefix=1)]


def imt_bases() -> list:
    """IM Tools files: the default lines, the size after the mode with CR
    line ends, and a header past the first 100 bytes."""
    g = image(5, 7)
    return [cs.imt_file(g), cs.imt_file(g, ["pixel n8\r", "height 5", "width 7"]),
            cs.imt_file(image(4, 9), ["* " + "x" * 70, "* " + "y" * 60, "width 9", "height 4", "pixel n8"])]


def fits_values(h: int, w: int, bitpix: int) -> np.ndarray:
    """Samples of a BITPIX: grey levels, with values past 0 .. 255 for
    the wider ones, NaN and infinities for floats."""
    g = image(h, w).astype(np.float64)
    if bitpix == 8:
        return g.astype(np.uint8)
    v = g * {16: 97.0, 32: 70001.0, -32: 1.37, -64: 1.37}[bitpix] - {16: 9000, 32: 10 ** 6, -32: 30.5,
                                                                      -64: 30.5}[bitpix]
    if bitpix < 0:
        v.flat[::7] = np.nan
        v.flat[1::11] = np.inf
        return v
    return v.astype(np.int64)


def fits_raw_bases() -> list:
    """FITS images of BITPIX 8, 16, 32, -32 and -64, big-endian (as the
    format is) and little-endian (as PIL reads them), NAXIS 1, and an
    image extension after the primary image (read past)."""
    out = [cs.fits_file(fits_values(5, 7, b), b, be) for b in (8, 16, 32, -32, -64) for be in (True, False)]
    one = cs.fits_cards([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 1), ("NAXIS1", 9)])
    out.append(one + image(1, 9).tobytes() + bytes(2871))
    ext = cs.fits_cards([("XTENSION", "'IMAGE   '"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 3), ("NAXIS2", 2)])
    out.append(cs.fits_file(fits_values(4, 6, 8), 8)[:2880] + ext + cs.fits_file(fits_values(4, 6, 8), 8)[2880:])
    return out


def fits_gzip_bases() -> list:
    """Tile-compressed FITS (GZIP_1) of ZBITPIX 8, 16, 32 and -32 (PIL
    takes no sample of a negative ZBITPIX: refused)."""
    return [cs.fits_gzip_file(fits_values(5, 7, b).astype(np.int64) if b > 0 else fits_values(5, 7, 16), b)
            for b in (8, 16, 32, -32)]


def jpeg(a, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", quality=85, **kw)
    return b.getvalue()


def iptc_raw_bases() -> list:
    """IPTC files of raw grey (3:120 1): in one and in several 8:10
    records, with a band of RGB and of CMYK, and a field after the image."""
    g = image(5, 7)
    return [cs.iptc_file(7, 5, g.tobytes()), cs.iptc_file(7, 5, g.tobytes(), piece=9),
            cs.iptc_file(7, 5, g.tobytes(), layers=3, component=1, band=2),
            cs.iptc_file(7, 5, g.tobytes(), layers=4, component=1, band=4),
            cs.iptc_file(7, 5, g.tobytes(), fields=[(2, 5, b"title")]) + cs.iptc_record(2, 120, b"caption")]


def iptc_jpeg_bases() -> list:
    """IPTC files of a JPEG (3:120 5): grey, split over records, as a band
    of RGB, of CMYK, and the last band by a 3:65 of 0."""
    j = jpeg(image(8, 12))
    return [cs.iptc_file(12, 8, j, compression=5), cs.iptc_file(12, 8, j, compression=5, piece=100),
            cs.iptc_file(12, 8, j, compression=5, layers=3, component=1, band=1),
            cs.iptc_file(12, 8, j, compression=5, layers=4, component=1, band=3),
            cs.iptc_file(12, 8, j, compression=5, layers=3, component=1, band=0)]


def fli_palette_colours(n: int = 256, seed: int = 3) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (n, 3)).astype(np.uint8)


def fli_bases() -> list:
    """FLI and FLC frames of each chunk kind: BRUN, COPY, LC, SS2 (after
    BRUN), BLACK, PSTAMP, with COLOR_256 and COLOR_64 palettes (a skip,
    a partial one), a grey palette, and a prefix chunk; and two frames of
    40 x 60, whose chunk data most damage lands in."""
    g = image(6, 10)
    pal = fli_palette_colours()
    ss2 = image(6, 10, seed=9)
    big, big2 = image(40, 60), image(40, 60, seed=9)
    return [cs.fli_file(10, 6, [cs.fli_palette(pal), cs.fli_brun(g)]),
            cs.fli_file(10, 6, [cs.fli_palette(pal >> 2, 11), cs.fli_chunk(16, g.tobytes())], magic=0xAF11),
            cs.fli_file(10, 6, [cs.fli_brun(g), cs.fli_lc(ss2[2:5], 2)]),
            cs.fli_file(10, 6, [cs.fli_palette(pal[:40], 4, skip=7), cs.fli_brun(g), cs.fli_ss2(ss2)]),
            cs.fli_file(10, 6, [cs.fli_chunk(18, bytes(20)), cs.fli_brun(g), cs.fli_chunk(13, b"")]),
            cs.fli_file(10, 6, [cs.fli_brun(g)], prefix=bytes(10)),
            cs.fli_file(60, 40, [cs.fli_palette(pal), cs.fli_brun(big)]),
            cs.fli_file(60, 40, [cs.fli_brun(big), cs.fli_lc(big2[5:30], 5), cs.fli_ss2(big2)])]


def pcd_bases() -> list:
    """Photo CD base images of orientations 0, 1, 2 and 3 from seeded luma
    and chroma."""
    rs = np.random.RandomState(4)
    y = rs.randint(0, 256, (512, 768)).astype(np.uint8)
    cb, cr = (rs.randint(0, 256, (256, 384)).astype(np.uint8) for _ in range(2))
    return [cs.pcd_file(y, cb, cr, o) for o in (0, 1, 2, 3)]


BASES = {"PIXAR": pixar_bases, "GBR": gbr_bases, "MCIDAS": mcidas_bases, "IMT": imt_bases,
         "FITS-RAW": fits_raw_bases, "FITS-GZIP": fits_gzip_bases, "IPTC-RAW": iptc_raw_bases,
         "IPTC-JPEG": iptc_jpeg_bases, "FLI": fli_bases, "PCD": pcd_bases}


def verdict(path, data: bytes) -> str:
    """What PIL does with ``data`` (written to ``path``), held against the
    port (``holds``): "read" (the greys equal), "refused" (Image.open or
    the load raises; the port: corrupt) or "passed" (no plugin takes the
    file: UnidentifiedImageError; the port: "not a recognised image
    file")."""
    from siggan_tpu_torch.data import dataset as tdataset
    from torch_port_raster_cases import holds
    fmt, want = holds(path, data)
    if want is not None:
        return "read"
    try:
        Image.open(path).close()
        passed = False
    except Image.UnidentifiedImageError:
        passed = True
    except Exception:
        passed = False
    try:
        tdataset.decode_gray(path)
    except ValueError as e:
        assert passed == ("not a recognised image file" in str(e)), f"PIL passed on: {passed}; port: {e}"
    return "passed" if passed else "refused"
