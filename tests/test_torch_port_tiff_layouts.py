"""TIFF layouts PIL reads (ROADMAP A.6.7-A.6.12) against PIL, through the
JAX package: BigTIFF, planar TIFF, YCbCr outside JPEG, FillOrder 2,
associated alpha and a palette with an extra sample; and libtiff's directory
rules in the files it decodes (C.13).

PIL reads a TIFF by one of two routes: its own raw decoder for an
uncompressed file, libtiff for a compressed one, and the same layout can
read otherwise on each (a planar file's raw layers take one letter of the
raw mode each, YCbCr is raw RGBX on one and libtiff's RGBA reader on the
other). So every kind is built uncompressed and compressed (Deflate or LZW,
some PackBits), in strips and tiles, in both byte orders, by the writers of
``chip_smoke`` (no PIL). Each case first states what PIL does with the file
(it reads it, or refuses it), then holds the port to that: bit-equal with
PIL's ``convert("L")`` (``assert_port_reads_as_pil``), or a zero image in
``decode_image`` and ``ValueError`` in ``decode_gray`` where PIL refuses."""

import io

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu.verify import pairs as jpairs
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.verify import pairs as tpairs

H, W = 13, 19
RS = np.random.RandomState(18)
RGB = pixels(RS, (H, W, 3)).astype(np.int64)
ALPHA = pixels(RS, (H, W, 1)).astype(np.int64)
ALPHA[0, :4, 0] = [0, 255, 1, 128]
PAL = list(RS.randint(0, 65536, 768))
LAYOUTS = {"strips": dict(rows_per_strip=5), "one_strip": dict(), "tiles": dict(tile=(16, 16))}


def pil_reads(data: bytes) -> bool:
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.convert("L")
        return True
    except Exception:
        return False


def holds(tmp_path, data: bytes, reads: bool, what: str = ""):
    """PIL reads the file or refuses it, as ``reads`` says; the port does
    the same: bit-equal with PIL, or corrupt (a zero image, ValueError)."""
    assert pil_reads(data) == reads
    path = tmp_path / "f.tif"
    path.write_bytes(data)
    if reads:
        assert_port_reads_as_pil(path)
        return
    assert not jdataset.decode_image(path, 16).any()
    assert not tdataset.decode_image(path, 16).any()
    with pytest.raises(ValueError, match=what):
        tdataset.decode_gray(path)


def pil_tiff(mode_img, **kw) -> bytes:
    buf = io.BytesIO()
    mode_img.save(buf, "TIFF", **kw)
    return buf.getvalue()


# -- A.6.7: BigTIFF -------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("kind", ["grey", "rgb", "bilevel"])
def test_bigtiff_reads_as_pil(tmp_path, kind, compression, layout):
    """Version 43, 8-byte offsets, 20-byte entries, LONG8 offsets and
    counts, in every codec and layout the classic reader reads."""
    smp, bits, photo = {"grey": (RGB[..., :1], 8, 1), "rgb": (RGB, 8, 2),
                        "bilevel": (RGB[..., :1] & 1, 1, 0)}[kind]
    data = chip_smoke.tiff_layout(smp, bits, photo, compression=compression, big=True,
                                  **LAYOUTS[layout])
    assert data[2] == 43
    holds(tmp_path, data, True)


@pytest.mark.parametrize("mode,compression", [("L", "jpeg"), ("RGB", "jpeg"), ("1", "group4"),
                                              ("1", "group3"), ("1", "tiff_ccitt"),
                                              ("RGB", "tiff_lzw"), ("CMYK", "tiff_adobe_deflate"),
                                              ("P", "packbits"), ("RGBA", None), ("I;16", None),
                                              ("F", None)])
def test_pil_written_bigtiff_reads_as_pil(tmp_path, mode, compression):
    """PIL's own big_tiff=True files, JPEG and CCITT among them, in strips
    (one strip for JPEG, whose strips are whole MCU rows)."""
    img = Image.fromarray(RGB.astype(np.uint8)).convert(mode) if mode != "I;16" else \
        Image.fromarray((RGB[..., 0] * 200).astype(np.uint16))
    kw = {"compression": compression} if compression else {}
    rps = 16 if compression == "jpeg" else 4
    holds(tmp_path, pil_tiff(img, big_tiff=True, tiffinfo={278: rps}, **kw), True)


@pytest.mark.parametrize("offset_type", [3, 4])
@pytest.mark.parametrize("compression", [1, 8])
def test_bigtiff_with_classic_offset_types_reads_as_pil(tmp_path, offset_type, compression):
    """StripOffsets and StripByteCounts as SHORT or LONG in a BigTIFF."""
    import zlib
    grey = RGB[..., 0].astype(np.uint8)
    blobs = [grey[y:y + 4].tobytes() for y in range(0, H, 4)]
    if compression == 8:
        blobs = [zlib.compress(b) for b in blobs]
    data = chip_smoke.tiff_pack(W, H, blobs, [
        (258, 3, [8]), (259, 3, [compression]), (262, 3, [1]), (277, 3, [1]),
        (273, offset_type, lambda o: o), (278, 3, [4]),
        (279, offset_type, [len(b) for b in blobs])], big=True)
    holds(tmp_path, data, True)


def test_big_endian_bigtiff_is_corrupt(tmp_path):
    """PIL takes the header's third byte for the version: a big-endian
    BigTIFF's is 0, and PIL cannot parse it; libtiff's 8-byte-offset rule
    on a compressed file refuses a BigTIFF header of other offsets."""
    data = chip_smoke.tiff_layout(RGB[..., :1], 8, 1, compression=8, big=True, be=True)
    holds(tmp_path, data, False, "big-endian BigTIFF")
    data = bytearray(chip_smoke.tiff_layout(RGB[..., :1], 8, 1, compression=8, big=True))
    data[4] = 4
    holds(tmp_path, bytes(data), False, "offsets not of 8 bytes")


# -- A.6.8: planar TIFF ---------------------------------------------------------

PLANAR = {  # name -> (samples, bits, photometric, tags)
    "rgb": (RGB, 8, 2, []),
    "rgba": (np.dstack([RGB, ALPHA]), 8, 2, [(338, 3, [2])]),
    "rgba_no_extra": (np.dstack([RGB, ALPHA]), 8, 2, []),
    "rgbx": (np.dstack([RGB, ALPHA]), 8, 2, [(338, 3, [0])]),
    "rgba_associated": (np.dstack([RGB, ALPHA]), 8, 2, [(338, 3, [1])]),
    "rgb16": (RGB * 257 + 3, 16, 2, []),
    "rgba16": (np.dstack([RGB, ALPHA]) * 257, 16, 2, [(338, 3, [2])]),
    "cmyk": (np.dstack([RGB, ALPHA]), 8, 5, []),
    "cmyk16": (np.dstack([RGB, ALPHA]) * 257, 16, 5, []),
    "cmykx": (np.dstack([RGB, ALPHA, ALPHA]), 8, 5, [(338, 3, [0])]),
    "grey_alpha": (np.dstack([RGB[..., :1], ALPHA]), 8, 1, [(338, 3, [2])]),
    "pa": (np.dstack([RGB[..., :1], ALPHA]), 8, 3, [(338, 3, [2]), (320, 3, PAL)]),
    "px": (np.dstack([RGB[..., :1], ALPHA]), 8, 3, [(338, 3, [0]), (320, 3, PAL)]),
}
# PIL's raw decoder reads layer p with raw mode letter p: R, G, B, A and
# C, M, Y, K (as 8 bits, so a 16-bit plane reads otherwise), not X, a, L or
# P; libtiff's route reads the mode's bands of planes, a strip only where
# the raw mode's bits a pixel over the bands make a plane's row.
PLANAR_REFUSED = {("rgbx", 1), ("rgba_associated", 1), ("cmykx", 1), ("grey_alpha", 1),
                  ("pa", 1), ("px", 1), ("rgbx", 8, "strips"), ("rgbx", 8, "one_strip"),
                  ("cmykx", 8, "strips"), ("cmykx", 8, "one_strip"), ("px", 8, "strips"),
                  ("px", 8, "one_strip")}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("compression", [1, 8])
@pytest.mark.parametrize("name", sorted(PLANAR))
def test_planar_reads_as_pil(tmp_path, name, compression, layout):
    smp, bits, photo, tags = PLANAR[name]
    data = chip_smoke.tiff_layout(smp, bits, photo, compression=compression, planar=2,
                                  tags=tags, **LAYOUTS[layout])
    refused = (name, compression) in PLANAR_REFUSED or (name, compression, layout) in PLANAR_REFUSED
    holds(tmp_path, data, not refused)


@pytest.mark.parametrize("name", ["rgb", "rgb16", "cmyk", "rgba"])
@pytest.mark.parametrize("be", [False, True])
def test_planar_lzw_predictor_and_byte_order_read_as_pil(tmp_path, name, be):
    """Predictor 2 within a plane (one sample a pixel), either byte order."""
    smp, bits, photo, tags = PLANAR[name]
    data = chip_smoke.tiff_layout(smp, bits, photo, compression=5, planar=2, predictor=2, be=be,
                                  rows_per_strip=4, tags=tags)
    holds(tmp_path, data, True)


@pytest.mark.parametrize("kind", ["bilevel", "grey2", "grey8_inverted", "palette4", "int32",
                                  "float32", "grey16"])
def test_planar_of_one_sample_reads_as_pil(tmp_path, kind):
    """PIL's raw route takes PlanarConfiguration 2 for one sample too: the
    layer's raw mode is the first letter of the mode's (1, L, P, I or F),
    so packed samples are read as bytes, WhiteIsZero is not inverted, and
    I;16's I has no unpacker (refused)."""
    smp, bits, photo, fmt = {"bilevel": (RGB[..., :1] & 1, 1, 0, 1),
                             "grey2": (RGB[..., :1] & 3, 2, 1, 1),
                             "grey8_inverted": (RGB[..., :1], 8, 0, 1),
                             "palette4": (RGB[..., :1] & 15, 4, 3, 1),
                             "int32": (RGB[..., :1] * 3 - 100, 32, 1, 2),
                             "float32": (RGB[..., :1], 32, 1, 3),
                             "grey16": (RGB[..., :1] * 200, 16, 1, 1)}[kind]
    tags = [(339, 3, [fmt])] + ([(320, 3, PAL[:16] + PAL[256:272] + PAL[512:528])]
                                if photo == 3 else [])
    if fmt == 1:
        data = chip_smoke.tiff_layout(smp, bits, photo, planar=2, rows_per_strip=4, tags=tags)
    else:
        values = smp[..., 0].astype("<i4" if fmt == 2 else "<f4")
        data = chip_smoke.tiff_pack(W, H, [values[y:y + 4].tobytes() for y in range(0, H, 4)], [
            (258, 3, [32]), (259, 3, [1]), (262, 3, [1]), (277, 3, [1]), (284, 3, [2]),
            (273, 4, lambda o: o), (278, 4, [4]), (279, 4, [4 * W * 4] * 3 + [4 * W]),
            (339, 3, [fmt])])
    holds(tmp_path, data, kind != "grey16")


# -- A.6.9: YCbCr outside JPEG --------------------------------------------------

def ycbcr(sub, seed=0, shape=(H, W)):
    rs = np.random.RandomState(seed)
    h, w = shape
    bh, bw = -(-h // sub[1]), -(-w // sub[0])
    return rs.randint(0, 256, (h, w)), rs.randint(0, 256, (bh, bw)), rs.randint(0, 256, (bh, bw))


# libtiff's RGBA reader has routines for 4x4, 4x2, 4x1, 2x2, 2x1, 1x2, 1x1.
@pytest.mark.parametrize("layout", ["strips", "one_strip", "tiles"])
@pytest.mark.parametrize("compression", [5, 8, 32773])
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4), (2, 4)])
def test_ycbcr_through_libtiff_reads_as_pil(tmp_path, sub, compression, layout):
    """Blocks of h x v luma samples and one Cb, Cr each, the chroma given
    to the block's pixels as they are, through libtiff's YCbCr tables;
    edge blocks where 13 x 19 is no multiple of the block; a 4 x 4 strip of
    5 blocks a row, whose last 8 bytes libtiff does not read; 4 x 4 tiles
    cut by the image's edge, whose skip libtiff counts 10 bytes a block.
    2 x 4 has no routine: refused."""
    kw = {"strips": dict(rows_per_strip=4 * sub[1]), "one_strip": dict(),
          "tiles": dict(tile=(16, 16))}[layout]
    data = chip_smoke.tiff_ycbcr(*ycbcr(sub, sum(sub) + compression), sub,
                                 compression=compression, **kw)
    holds(tmp_path, data, sub != (2, 4), "subsampling libtiff's RGBA reader has no reader for")


@pytest.mark.parametrize("tags", ["reference_black_white", "coefficients", "no_subsampling_tag",
                                  "big_endian"])
def test_ycbcr_tags_read_as_pil(tmp_path, tags):
    """ReferenceBlackWhite and YCbCrCoefficients as libtiff's TIFFYCbCrToRGB
    tables take them; no YCbCrSubsampling tag is libtiff's 2 x 2."""
    extra = {"reference_black_white": [(532, 5, [(10, 1), (230, 1), (128, 1), (250, 1),
                                                  (120, 1), (240, 1)])],
             "coefficients": [(529, 5, [(2990, 10000), (5870, 10000), (1140, 10000)])],
             "no_subsampling_tag": [], "big_endian": []}[tags]
    y, cb, cr = ycbcr((2, 2), 7)
    data = chip_smoke.tiff_ycbcr(y, cb, cr, (2, 2), rows_per_strip=4, tags=extra,
                                 be=tags == "big_endian")
    if tags == "no_subsampling_tag":  # the entry renamed to a private tag
        entry = bytes([0x12, 0x02, 3, 0, 2, 0, 0, 0, 2, 0, 2, 0])
        assert entry in data
        data = data.replace(entry, bytes([0xE8, 0xFD]) + entry[2:])
    holds(tmp_path, data, True)


@pytest.mark.parametrize("sub", [(1, 1), (2, 2)])
@pytest.mark.parametrize("compression", [1, 8])
def test_planar_ycbcr_reads_as_pil(tmp_path, sub, compression):
    """Three planes: libtiff's RGBA reader has a routine for 1 x 1 alone;
    PIL's raw route reads the planes as R, G and B."""
    data = chip_smoke.tiff_ycbcr(*ycbcr(sub, 3), sub, compression=compression, planar=2,
                                 rows_per_strip=4)
    holds(tmp_path, data, compression == 1 or sub == (1, 1))


@pytest.mark.parametrize("layout", ["strips", "one_strip", "tiles"])
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2)])
def test_uncompressed_ycbcr_reads_as_pils_raw_route(tmp_path, sub, layout):
    """PIL's raw decoder reads chunky YCbCr with raw mode RGBX: 4 bytes a
    pixel over 3-byte samples, on from each strip's offset into whatever
    follows in the file, truncated where the file ends first."""
    kw = {"strips": dict(rows_per_strip=4 * sub[1]), "one_strip": dict(),
          "tiles": dict(tile=(16, 16))}[layout]
    data = chip_smoke.tiff_ycbcr(*ycbcr(sub, 5), sub, compression=1, **kw)
    holds(tmp_path, data, pil_reads(data))


def test_one_sample_ycbcr(tmp_path):
    """One YCbCr sample: PIL's mode L. Its raw route reads the samples; its
    libtiff route's RGBA reader refuses them."""
    grey = RGB[..., :1]
    holds(tmp_path, chip_smoke.tiff_layout(grey, 8, 6), True)
    holds(tmp_path, chip_smoke.tiff_layout(grey, 8, 6, compression=8), False, "not of 3 samples")


@pytest.mark.parametrize("sub", [(1, 1), (2, 2), (4, 2)])
def test_ycbcr_predictor_reads_as_pil(tmp_path, sub):
    """Predictor 2 over YCbCr blocks: libtiff adds within rows of its
    scanline's bytes (a block row's over v), three bytes apart."""
    import zlib
    y, cb, cr = (a.astype(np.uint8) for a in ycbcr(sub, 9, (16, 24)))
    hh, vv = sub
    bh, bw = cb.shape
    units = np.concatenate([y.reshape(bh, vv, bw, hh).transpose(0, 2, 1, 3).reshape(bh, bw, -1),
                            cb[..., None], cr[..., None]], axis=2)
    blobs = []
    for r in range(0, bh, 4 // vv):
        raw = np.frombuffer(units[r:r + 4 // vv].tobytes(), np.uint8).astype(np.int64)
        rows = raw.reshape(-1, bw * (hh * vv + 2) // vv)
        rows[:, 3:] -= rows[:, :-3].copy()
        blobs.append(zlib.compress((rows & 255).astype(np.uint8).tobytes()))
    data = chip_smoke.tiff_pack(24, 16, blobs, [
        (258, 3, [8] * 3), (259, 3, [8]), (262, 3, [6]), (277, 3, [3]), (284, 3, [1]),
        (530, 3, [hh, vv]), (317, 3, [2]), (273, 4, lambda o: o), (278, 4, [4]),
        (279, 4, [len(b) for b in blobs])])
    holds(tmp_path, data, True)


# -- A.6.10: FillOrder 2 ----------------------------------------------------------

FILL2 = {  # name -> (samples, bits, photometric, tags)
    "bilevel": (RGB[..., :1] & 1, 1, 1, []), "bilevel_inverted": (RGB[..., :1] & 1, 1, 0, []),
    "grey2": (RGB[..., :1] & 3, 2, 1, []), "grey4_inverted": (RGB[..., :1] & 15, 4, 0, []),
    "grey8": (RGB[..., :1], 8, 1, []), "grey8_inverted": (RGB[..., :1], 8, 0, []),
    "grey16": (RGB[..., :1] * 200, 16, 1, []), "rgb": (RGB, 8, 2, []),
    "palette4": (RGB[..., :1] & 15, 4, 3, [(320, 3, PAL[:16] + PAL[256:272] + PAL[512:528])]),
    "palette8": (RGB[..., :1], 8, 3, [(320, 3, PAL)]),
}


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("name", sorted(FILL2))
def test_fill_order_2_reads_as_pil(tmp_path, name, compression, be):
    """Every stored byte's bits reversed. PIL's raw route reads it with its
    ;R raw modes (none for 8-bit WhiteIsZero or palettes below 8 bits:
    refused); libtiff reverses the bytes before its codec. 16-bit grey with
    FillOrder 2 has a PIL mode in little-endian files alone."""
    smp, bits, photo, tags = FILL2[name]
    data = chip_smoke.tiff_layout(smp, bits, photo, compression=compression, fill=2, be=be,
                                  rows_per_strip=5, tags=tags)
    refused = (compression == 1 and name in ("grey8_inverted", "palette4")) or \
        (name == "grey16" and be)
    holds(tmp_path, data, not refused)


@pytest.mark.parametrize("coding", ["t6", "t4_2d_fill", "mh", "t4_1d"])
def test_ccitt_fill_order_2_reads_as_pil(tmp_path, coding):
    """Group 4, T.4 and Modified Huffman with FillOrder 2 (ROADMAP A.6's
    audit case): libtiff's fax decoder reads the bits LSB first."""
    from test_torch_port_ccitt import ccitt_bytes, ifd_entries
    from test_torch_port_decode import layout_tags, tiff_file
    img = np.random.RandomState(6).rand(40, 70) < 0.3
    src = ccitt_bytes(img, coding, rows_per_strip=16)
    tags = ifd_entries(src)
    blobs = [src[o:o + n].translate(chip_smoke.REVERSED_BITS)
             for o, n in zip(tags[273][3], tags[279][3])]
    extra = [(266, 3, [2])] + ([(292, 4, tags[292][3])] if 292 in tags else [])
    data = tiff_file(70, 40, blobs, [(258, 3, [1]), (259, 3, tags[259][3]), (262, 3, [1]),
                                     (277, 3, [1])] + layout_tags(None, 16, 40) + extra)
    holds(tmp_path, data, True)


# -- A.6.11: associated alpha -----------------------------------------------------

@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("compression", [1, 8])
@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("kind", ["rgba8", "rgbax8", "rgba16"])
def test_associated_alpha_reads_as_pil(tmp_path, kind, be, compression, layout):
    """PIL's RGBa unpackers: each colour times 255 over the alpha (0 where
    the alpha is 0; at 16 bits the high bytes), then RGBA -> L."""
    smp, bits, extra = {"rgba8": (np.dstack([RGB, ALPHA]), 8, [1]),
                        "rgbax8": (np.dstack([RGB, ALPHA, ALPHA]), 8, [1, 0]),
                        "rgba16": (np.dstack([RGB, ALPHA]) * 257 + 5, 16, [1])}[kind]
    data = chip_smoke.tiff_layout(smp, bits, 2, compression=compression, be=be,
                                  tags=[(338, 3, extra)], **LAYOUTS[layout])
    holds(tmp_path, data, True)


def test_associated_alpha_is_unpremultiplied():
    """PIL's grey of RGBa is the luma of the colours over the alpha."""
    px = np.array([[[100, 50, 20, 128], [255, 255, 255, 0], [10, 20, 30, 255]]])
    data = chip_smoke.tiff_layout(px, 8, 2, tags=[(338, 3, [1])])
    un = lambda c, a: 0 if a == 0 else c if a == 255 else min(c * 255 // a, 255)  # noqa: E731
    luma = lambda r, g, b: (19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16  # noqa: E731
    want = [luma(*(un(c, p[3]) for c in p[:3])) if p[3] else 0 for p in px[0]]
    with Image.open(io.BytesIO(data)) as im:
        assert np.asarray(im.convert("L"))[0].tolist() == want
    from siggan_tpu_torch.data.native import loader
    assert loader.decode(data)[0].tolist() == want


# -- A.6.12: a palette with an extra sample ----------------------------------------

@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("compression", [1, 5, 8])
@pytest.mark.parametrize("extra", [0, 2])
def test_palette_with_an_extra_sample_reads_as_pil(tmp_path, extra, compression, layout):
    """PA (ExtraSamples 2) and PX (0): the palette's luma of the first
    sample, the second dropped."""
    data = chip_smoke.tiff_layout(np.dstack([RGB[..., :1], ALPHA]), 8, 3,
                                  compression=compression,
                                  tags=[(338, 3, [extra]), (320, 3, PAL)], **LAYOUTS[layout])
    holds(tmp_path, data, True)


def test_planar_px_tiles_read_as_pil(tmp_path):
    """Planar PX through libtiff in tiles: PIL's decoder reads the first
    plane's tile with the chunky raw mode PX, a tile row's pixel c from its
    byte 2c, on into the next row."""
    smp, bits, photo, tags = PLANAR["px"]
    data = chip_smoke.tiff_layout(smp, bits, photo, compression=5, planar=2, tile=(16, 16),
                                  tags=tags)
    holds(tmp_path, data, True)


# -- C.13: libtiff's directory rules, PIL's own -------------------------------------

GREY = RGB[..., :1]
# (tag, type) -> whether PIL reads the file on (raw route, libtiff route).
# PIL drops SLONG8 and unknown types, takes BYTE and UNDEFINED as bytes and
# ASCII as a string, RATIONAL, FLOAT and DOUBLE as numbers; libtiff needs
# the size, layout and sample tags as integers (not IFD), and drops the rest.
TAG_TYPES = {
    (256, 1): (False, False), (256, 6): (True, True), (256, 13): (True, False),
    (256, 16): (True, True), (256, 5): (False, False), (258, 5): (True, False),
    (258, 11): (True, False), (258, 7): (False, False), (259, 12): (True, False),
    (262, 11): (True, True), (273, 9): (True, True), (273, 5): (False, False),
    (273, 13): (True, False), (277, 5): (True, False), (278, 1): (False, True),
    (278, 13): (True, False), (278, 96): (True, False), (279, 13): (True, False),
    (279, 2): (True, False), (284, 5): (True, False), (284, 96): (True, False),
    (317, 11): (True, True), (317, 96): (True, True), (278, 17): (True, True),
}
# A RowsPerStrip PIL drops (96, 17) makes its raw route read one strip of
# the image's height from the last offset on (TiffImageFile._setup), into
# the directory after it: read, as the port reads it.


@pytest.mark.parametrize("compression", [1, 8])
@pytest.mark.parametrize("tag,typ", sorted(TAG_TYPES))
def test_tag_types_are_read_as_pil_and_libtiff_read_them(tmp_path, tag, typ, compression):
    """A grey file of two strips whose entry ``tag`` carries field type
    ``typ`` (its values packed as that type where TIFF defines it)."""
    layout = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8]), (259, 3, [compression]),
              (262, 3, [1]), (277, 3, [1]), (284, 3, [1]), (317, 3, [1])]
    import zlib
    raw = [GREY[:7].astype(np.uint8).tobytes(), GREY[7:].astype(np.uint8).tobytes()]
    blobs = [zlib.compress(b) if compression == 8 else b for b in raw]
    entries = layout + [(273, 4, lambda o: o), (278, 4, [7]), (279, 4, [len(b) for b in blobs])]
    out = []
    for t, ty, v in entries:
        if t == tag:
            if typ in chip_smoke.TIFF_TYPES and typ not in (2, 5, 7):
                ty = typ
            elif typ == 5:
                v = (lambda o, f=v: [(x, 1) for x in f(o)]) if callable(v) else [(x, 1) for x in v]
                ty = 5
            elif typ == 2:
                v, ty = b"7\0", 2
            else:
                ty = (typ, ty)  # an undefined type over the values as they were
        out.append((t, ty, v))
    data = chip_smoke.tiff_pack(W, H, blobs, out)
    holds(tmp_path, data, TAG_TYPES[tag, typ][compression == 8])


@pytest.mark.parametrize("strips", [1, 3])
@pytest.mark.parametrize("compression", [1, 8])
def test_missing_strip_byte_counts(tmp_path, strips, compression):
    """No StripByteCounts: PIL's raw route does not need it; libtiff
    estimates it for one strip (the file less its header and directory)
    and refuses several."""
    rps = H if strips == 1 else 5
    data = chip_smoke.tiff_layout(GREY, 8, 1, compression=compression, rows_per_strip=rps)
    data = data.replace(bytes([0x17, 0x01, 4, 0]), bytes([0xE8, 0xFD, 4, 0]))  # 279 -> 65000
    holds(tmp_path, data, compression == 1 or strips == 1, "byte counts missing")


# -- chip_smoke.py's pages and mixed tree ------------------------------------------

def test_phase_12_pages_read_as_their_digests():
    """``chip_smoke.a6_layout_pages`` (1200 x 500, no PIL) decode to the
    digests of PIL's grey that the fixtures keep, as phase 12 holds them on
    the card's host; and PIL gives those digests."""
    from siggan_tpu_torch.data.native import loader
    digests = dict(reversed(line.split()) for line in
                   (chip_smoke.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    for name, data in chip_smoke.a6_layout_pages(chip_smoke.golden_arrays()).items():
        with Image.open(io.BytesIO(data)) as im:
            assert chip_smoke.gray_digest(np.asarray(im.convert("L"))) == digests[name], name
        assert chip_smoke.gray_digest(loader.decode(data)) == digests[name], name


@pytest.mark.parametrize("turn", range(6))
def test_mixed_tree_tiffs_read_as_pil(tmp_path, turn):
    """Each of ``chip_smoke.mixed_tiff``'s layouts, at an odd scan size."""
    grey = pixels(np.random.RandomState(turn), (57, 83)).astype(np.uint8)
    holds(tmp_path, chip_smoke.mixed_tiff(grey, turn)[1], True)


# -- the datasets on a tree of the new kinds --------------------------------------

def new_kinds_tree(root):
    """Two writers' folders of every kind this slice reads, and one file
    PIL refuses each."""
    for wi in range(2):
        d = root / f"w{wi}"
        d.mkdir(parents=True)
        rgb = pixels(np.random.RandomState(60 + wi), (24 + 4 * wi, 36, 3)).astype(np.int64)
        a = pixels(np.random.RandomState(70 + wi), rgb.shape[:2] + (1,)).astype(np.int64)
        grey = rgb[..., :1]
        files = {
            "big.tif": chip_smoke.tiff_layout(grey, 8, 1, compression=5, big=True,
                                              rows_per_strip=8),
            "planar.tif": chip_smoke.tiff_layout(rgb, 8, 2, compression=8, planar=2,
                                                 predictor=2),
            "ycbcr.tif": chip_smoke.tiff_ycbcr(*ycbcr((2, 2), wi, rgb.shape[:2]), (2, 2)),
            "fill2.tif": chip_smoke.tiff_layout(grey, 8, 1, compression=8, fill=2),
            "rgba.tif": chip_smoke.tiff_layout(np.dstack([rgb, a]), 8, 2,
                                               tags=[(338, 3, [1])]),
            "pa.tif": chip_smoke.tiff_layout(np.dstack([grey, a]), 8, 3,
                                             tags=[(338, 3, [2]), (320, 3, PAL)]),
            "refused.tif": chip_smoke.tiff_layout(np.dstack([rgb, a]), 8, 2, planar=2,
                                                  tags=[(338, 3, [0])]),
        }
        for name, data in files.items():
            (d / f"w{wi}_{name}").write_bytes(data)


def test_datasets_read_the_new_kinds_as_jax(tmp_path, monkeypatch):
    """SignatureDataset and PairDataset over the tree equal the JAX
    package's (its PIL path): the kinds read bit-equal, the refused file a
    zero image."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    new_kinds_tree(tmp_path / "raw")
    j = jdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    assert len(t) == 14 and sum(not x.any() for x in t.images) == 2
    np.testing.assert_array_equal(t.images, j.images)
    jp = jpairs.PairDataset(tmp_path / "raw", pairs_per_user=4, image_size=32, seed=5)
    tp = tpairs.PairDataset(tmp_path / "raw", pairs_per_user=4, image_size=32, seed=5)
    np.testing.assert_array_equal(tp.img1, jp.img1)
    np.testing.assert_array_equal(tp.img2, jp.img2)


def test_preprocess_refuses_what_pil_refuses(tmp_path):
    """``cli.preprocess``'s decode takes the refused file for corrupt
    (ValueError), the new kinds for scans."""
    from siggan_tpu_torch.cli import preprocess as tcli
    new_kinds_tree(tmp_path / "raw")
    for path in sorted((tmp_path / "raw").rglob("*.tif")):
        if path.name.endswith("refused.tif"):
            with pytest.raises(ValueError):
                tcli.load_canvas(path, 64)
        else:
            assert tcli.load_canvas(path, 64)[0].shape == (64, 64)


# -- damaged directories and data: PIL's reading and libtiff's, as they meet ------

def entry_at(data: bytes, tag: int) -> int:
    """The position of a little-endian classic TIFF's first entry of ``tag``."""
    import struct
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        if struct.unpack_from("<H", data, ifd + 2 + 12 * i)[0] == tag:
            return ifd + 2 + 12 * i
    raise KeyError(tag)


def patched(data: bytes, tag: int, field: str, value: int) -> bytes:
    """``data`` with entry ``tag``'s count or 4-byte value field set."""
    import struct
    out = bytearray(data)
    struct.pack_into("<I", out, entry_at(data, tag) + (4 if field == "count" else 8), value)
    return bytes(out)


def zlib_past_whole(raw: bytes) -> bytes:
    """A zlib stream of ``raw`` as fixed-Huffman literals, then, before the
    end of its block, a match whose distance is past everything before it:
    zlib stops once the output it was asked for is whole, before it checks
    that distance."""
    import zlib
    bits = []

    def put(v, n, rev=False):  # Deflate's codes MSB first, other fields LSB first
        bits.extend(((v >> (n - 1 - i)) & 1) if rev else ((v >> i) & 1) for i in range(n))
    put(1, 1)
    put(1, 2)
    for b in raw:
        if b < 144:
            put(0x30 + b, 8, True)
        else:
            put(0x190 + b - 144, 9, True)
    put(1, 7, True)        # length 3 (symbol 257)
    put(29, 5, True)       # distance code 29: 24577 and up
    put(100, 13)
    put(0, 7, True)        # end of block
    bits.extend([0] * (-len(bits) % 8))
    body = bytes(int("".join(map(str, bits[i:i + 8][::-1])), 2) for i in range(0, len(bits), 8))
    return b"\x78\x9c" + body + zlib.adler32(raw).to_bytes(4, "big")


def damaged(name: str) -> bytes:
    rgba = np.dstack([RGB, ALPHA])
    y, cb, cr = ycbcr((2, 2), 11)
    strips = chip_smoke.tiff_ycbcr(y, cb, cr, (2, 2), compression=8, rows_per_strip=4)
    tiles = chip_smoke.tiff_ycbcr(y, cb, cr, (2, 2), compression=8, tile=(16, 16))
    if name == "entry_past_the_end_cuts_pils_directory":  # ExtraSamples is lost to PIL
        data = chip_smoke.tiff_layout(rgba, 8, 2, rows_per_strip=5, tags=[(338, 3, [1])])
        return patched(data, 279, "value", len(data) + 40)
    if name == "photometric_count_past_the_end":          # PIL's mode L over 3-sample tiles
        return patched(tiles, 262, "count", 1 << 30)
    if name == "strip_offsets_count_past_the_end":        # PIL: L over the RGBA rows; libtiff trims
        return patched(strips, 273, "count", 1 << 25)
    if name == "tile_past_the_end_in_the_rgba_reader":    # zeros
        import struct
        at = struct.unpack_from("<I", tiles, entry_at(tiles, 324) + 8)[0]
        out = bytearray(tiles)
        struct.pack_into("<I", out, at + 4, 10 ** 8)
        return bytes(out)
    if name == "first_strip_past_the_end_in_the_rgba_reader":
        import struct
        at = struct.unpack_from("<I", strips, entry_at(strips, 273) + 8)[0]
        out = bytearray(strips)
        struct.pack_into("<I", out, at, 10 ** 8)
        return bytes(out)
    if name == "deflate_match_past_the_output_once_whole":
        raw = GREY.astype(np.uint8).tobytes()
        return chip_smoke.tiff_pack(W, H, [zlib_past_whole(raw)], [
            (258, 3, [8]), (259, 3, [8]), (262, 3, [1]), (277, 3, [1]), (273, 4, lambda o: o),
            (278, 4, [H]), (279, 4, [len(zlib_past_whole(raw))])])
    if name == "packbits_literal_past_the_input_cut_to_the_output":
        raw = GREY[0].astype(np.uint8).tobytes()
        blob = bytes([127]) + raw  # 128 bytes claimed, 19 given and needed
        return chip_smoke.tiff_pack(W, 1, [blob], [
            (258, 3, [8]), (259, 3, [32773]), (262, 3, [1]), (277, 3, [1]),
            (273, 4, lambda o: o), (278, 4, [1]), (279, 4, [len(blob)])])
    if name == "bigtiff_offset_past_2_63":
        import struct
        data = bytearray(chip_smoke.tiff_layout(GREY, 8, 1, big=True, rows_per_strip=4))
        ifd = struct.unpack_from("<Q", data, 8)[0]
        for i in range(struct.unpack_from("<Q", data, ifd)[0]):
            e = ifd + 8 + 20 * i
            if struct.unpack_from("<H", data, e)[0] == 279:
                struct.pack_into("<Q", data, e + 12, 1 << 63)
        return bytes(data)
    if name == "rows_per_strip_near_2_32":
        return chip_smoke.tiff_layout(GREY, 8, 1, compression=8, tags=[(278, 4, [0xFFFFFFFE])])
    if name == "ycbcr_rows_per_strip_past_pils_buffer":
        return chip_smoke.tiff_ycbcr(y, cb, cr, (2, 2), tags=[(278, 4, [0x40000000])])
    if name == "tile_length_of_two_values":
        return patched(chip_smoke.tiff_layout(GREY, 8, 1, compression=8, tile=(16, 16)), 323,
                       "count", 2)
    if name == "directory_cut_by_the_end":
        data = chip_smoke.tiff_layout(GREY, 8, 1, compression=8, rows_per_strip=4)
        return data[:entry_at(data, 278) + 6]
    if name == "directory_cut_by_the_end_raw":
        data = chip_smoke.tiff_layout(GREY, 8, 1, rows_per_strip=4)
        return data[:entry_at(data, 284) + 6]
    raise KeyError(name)


DAMAGED = {  # name -> whether PIL reads the file
    "entry_past_the_end_cuts_pils_directory": True, "photometric_count_past_the_end": False,
    "strip_offsets_count_past_the_end": True, "tile_past_the_end_in_the_rgba_reader": True,
    "first_strip_past_the_end_in_the_rgba_reader": False,
    "deflate_match_past_the_output_once_whole": True,
    "packbits_literal_past_the_input_cut_to_the_output": True, "bigtiff_offset_past_2_63": False,
    "rows_per_strip_near_2_32": False, "ycbcr_rows_per_strip_past_pils_buffer": False,
    "tile_length_of_two_values": False, "directory_cut_by_the_end": False,
    "directory_cut_by_the_end_raw": False}


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged_files_read_as_pil(tmp_path, name):
    """The rules a damage probe over this slice's kinds found, one file
    each: PIL stops reading its directory at an entry whose values lie past
    the end of the file (and its seek overflows past 2^63), libtiff reads a
    strip array no further than it needs, the RGBA reader reads an
    unreadable tile after the first of its row as zeros and stops at an
    unreadable first one, zlib checks a match's distance only with room to
    copy, PackBits cuts a run to the output first, libtiff's and PIL's
    limits on RowsPerStrip and counts."""
    holds(tmp_path, damaged(name), DAMAGED[name])


def test_a_tag_given_twice_on_libtiffs_route_is_not_read_yet(tmp_path):
    """PIL keeps a duplicated tag's last entry and libtiff its first. Since
    A.6.26 the port follows the two apart, so a photometric given twice (1,
    then 0) reads as PIL reads it: PIL unpacks libtiff's grey inverted. An
    ImageWidth given twice, which makes libtiff's size not PIL's, PIL's
    decoder refuses (C.16): corrupt. (The name is from before A.6.26; the
    probe of every tag is in test_torch_port_tiff_corners.py.)"""
    data = chip_smoke.tiff_layout(GREY, 8, 1, compression=8,
                                  tags=[(256, 4, [W]), (256, 3, [W - 3])])
    holds(tmp_path, data, False, "size or sample bits libtiff reads otherwise")
    data = chip_smoke.tiff_layout(GREY, 8, 1, compression=8, tags=[(262, 3, [1]), (262, 3, [0])])
    holds(tmp_path, data, True)
