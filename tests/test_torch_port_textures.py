"""DDS (A.6.49-A.6.52), FTEX (A.6.53) and BLP (A.6.54) in the port's host
decoder (``decode.cpp``: ``dds_open`` and ``decode_dds``, ``bcn_grey``
with ``bc6_block`` and ``bc7_block``, ``ftex_open`` and ``decode_ftex``,
``blp_open`` and ``decode_blp``), each bit-equal with PIL's
``Image.open(path).convert("L")`` (Pillow 12.1.0) and with the JAX
package's ``decode_image``: Pillow's own files where it writes the format
(DDS uncompressed and through its bcn encoder, BLP palettes), random block
data of every block format (every BC4, BC5, BC6H and BC7 block decodes),
hand-built files (``chip_smoke.py``'s writers,
``tests/torch_port_texture_cases.py``) of the routes PIL's plugins take;
read where PIL reads, corrupt (``ValueError``) where PIL refuses."""

import io
import json
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil
from torch_port_raster_cases import holds, image, pil_verdict, probe
from test_torch_port_cmyk import ycck_bytes
from torch_port_texture_cases import (BASES, bc6h_blocks, bc7_blocks, blocks, blp1_jpeg,
                                      blp_pillow, dds_pillow, pil_jpeg, rgb_masked, spider_values)

import chip_smoke as cs
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset


def reads(tmp_path, data: bytes, fmt: str, names=("f.png",)):
    """PIL opens ``data`` as ``fmt`` and reads it; so does the port, as PIL
    and as the JAX package's ``load_canvas`` and ``decode_image`` (under
    each of ``names``)."""
    for name in names:
        (tmp_path / name).write_bytes(data)
        got, grey = pil_verdict(tmp_path / name)
        assert got == fmt and grey is not None
        assert_port_reads_as_pil(tmp_path / name)


def refused(tmp_path, data: bytes, fmt=None):
    """PIL refuses ``data`` (opened as ``fmt``, or not identified); the port
    calls it corrupt."""
    assert holds(tmp_path / "f.png", data) == (fmt, None)


SIZES = [(8, 12), (6, 9), (1, 1), (5, 3), (4, 17)]


# -- A.6.49 DDS container ------------------------------------------------------

@pytest.mark.parametrize("bands", [1, 2, 3, 4])
@pytest.mark.parametrize("size", SIZES)
def test_pillow_dds_uncompressed_reads_as_pil(tmp_path, bands, size):
    """Pillow's uncompressed DDS: L and LA (luminance), RGB and RGBA
    (DdsRgbDecoder over its masks), under a .dds and a .png name."""
    reads(tmp_path, dds_pillow(image(*size, bands if bands > 1 else 0)), "DDS", ("f.dds", "f.png"))


MASKS = {"565": (16, (0xF800, 0x7E0, 0x1F)), "4444": (16, (0xF00, 0xF0, 0xF, 0xF000)),
         "bgr24": (24, (0xFF, 0xFF00, 0xFF0000)), "off_bytes": (32, (0x18, 0x7E00, 0x3F00000, 0xC0000000)),
         "zero_green": (32, (0xFF, 0, 0xFF0000)), "overlapping": (32, (0xFFF0, 0xFF00, 0x0FF0)),
         "332": (8, (0xE0, 0x1C, 0x3)), "one_bit": (16, (0x8000, 0x1, 0x2, 0x4)),
         "whole_word": (32, (0xFFFFFFFF, 0xFF, 0xFF00))}


@pytest.mark.parametrize("case", sorted(MASKS))
def test_dds_rgb_masks_read_as_pil(tmp_path, case):
    """DdsRgbDecoder: bits / 8 little-endian bytes a pixel, each channel
    its mask's bits over the mask's (trailing zeros dropped) times 255,
    truncated in double; a zero mask 0, masks that overlap each their own."""
    bits, masks = MASKS[case]
    a = image(6, 9, len(masks))
    data = cs.dds_file(9, 6, rgb_masked(a, masks, bits), flags=0x40 | (len(masks) == 4), bits=bits,
                       masks=(*masks, 0)[:4])
    reads(tmp_path, data, "DDS")


@pytest.mark.parametrize("cut", [1, 5, 17, 53])
def test_dds_rgb_cut_short_reads_on_as_zeros(tmp_path, cut):
    """An uncompressed-RGB DDS cut short is read, not refused: the decoder's
    fd.read() gives what is left, then b"", which is 0."""
    data = cs.dds_file(9, 6, rgb_masked(image(6, 9, 3), (0xFF0000, 0xFF00, 0xFF), 24), flags=0x40, bits=24,
                       masks=(0xFF0000, 0xFF00, 0xFF, 0))
    reads(tmp_path, data[:-cut], "DDS")
    got = tdataset.decode_gray(tmp_path / "f.png").reshape(-1)
    assert not got[got.size - cut // 3:].any()


@pytest.mark.parametrize("bits", [0, 4, 7, 40, 64])
def test_dds_rgb_odd_bit_counts_as_pil(tmp_path, bits):
    """A bit count under 8 reads no byte a pixel (black); past 32 bits a
    pixel reads bits / 8 bytes of which the masks see the first four."""
    data = cs.dds_file(7, 5, image(5, 7 * 8, 0).tobytes(), flags=0x40, bits=bits,
                       masks=(0xFF0000, 0xFF00, 0xFF, 0))
    reads(tmp_path, data, "DDS")


def dds_palette(entries: int) -> bytes:
    return np.concatenate([np.arange(256)[:, None], 255 - np.arange(256)[:, None], (np.arange(256) // 3)[:, None],
                           np.full((256, 1), 9)], 1).astype(np.uint8).tobytes()[:4 * entries]


@pytest.mark.parametrize("case", ["l", "la", "palette", "rgba_typeless", "rgba_unorm", "rgba_srgb"])
@pytest.mark.parametrize("size", SIZES[:3])
def test_dds_luminance_palette_rgba_read_as_pil(tmp_path, case, size):
    """Luminance at 8 bits (L) and 16 with alpha (LA), an 8-bit palette
    of 1024 RGBA bytes (mode P), DX10's R8G8B8A8 (raw RGBA; SRGB only sets
    a gamma): each from where the header's reads stopped."""
    h, w = size
    g, la, rgba = image(h, w), image(h, w, 2), image(h, w, 4)
    data = {"l": lambda: cs.dds_file(w, h, g.tobytes(), bits=8),
            "la": lambda: cs.dds_file(w, h, la.tobytes(), flags=0x20001, bits=16),
            "palette": lambda: cs.dds_file(w, h, g.tobytes(), flags=0x20, palette=dds_palette(256)),
            "rgba_typeless": lambda: cs.dds_file(w, h, rgba.tobytes(), fourcc=b"DX10", dx10=27),
            "rgba_unorm": lambda: cs.dds_file(w, h, rgba.tobytes(), fourcc=b"DX10", dx10=28),
            "rgba_srgb": lambda: cs.dds_file(w, h, rgba.tobytes(), fourcc=b"DX10", dx10=29)}[case]()
    reads(tmp_path, data, "DDS", ("f.dds", "f.png"))


@pytest.mark.parametrize("entries", [0, 1, 100, 255])
def test_dds_palette_cut_short_is_refused(tmp_path, entries):
    """A palette file cut inside its 1024 bytes: the pixels start where the
    palette's read stopped, at the file's end, so none are there."""
    refused(tmp_path, cs.dds_file(9, 6, b"", flags=0x20, palette=dds_palette(entries)), "DDS")


@pytest.mark.parametrize("fmt", ["DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"])
@pytest.mark.parametrize("size", SIZES)
def test_pillow_bcn_encoder_reads_as_pil(tmp_path, fmt, size):
    """Pillow's bcn encoder's DXT1, DXT3, DXT5 (FourCC), BC2, BC3 and BC5
    (DX10) at sizes on and off a multiple of 4."""
    reads(tmp_path, dds_pillow(image(*size, 3 if fmt == "BC5" else 4), fmt), "DDS", ("f.dds", "f.png"))


BCN = {"DXT1": (b"DXT1", None, 8), "DXT3": (b"DXT3", None, 16), "DXT5": (b"DXT5", None, 16),
       "BC4U": (b"BC4U", None, 8), "ATI1": (b"ATI1", None, 8), "BC5U": (b"BC5U", None, 16),
       "ATI2": (b"ATI2", None, 16), "BC5S": (b"BC5S", None, 16), "BC1_TYPELESS": (b"DX10", 70, 8),
       "BC1_UNORM": (b"DX10", 71, 8), "BC2_TYPELESS": (b"DX10", 73, 16), "BC2_UNORM": (b"DX10", 74, 16),
       "BC3_TYPELESS": (b"DX10", 76, 16), "BC3_UNORM": (b"DX10", 77, 16), "BC4_TYPELESS": (b"DX10", 79, 8),
       "BC4_UNORM": (b"DX10", 80, 8), "BC5_TYPELESS": (b"DX10", 82, 16), "BC5_UNORM": (b"DX10", 83, 16),
       "BC5_SNORM": (b"DX10", 84, 16)}


@pytest.mark.parametrize("name", sorted(BCN))
@pytest.mark.parametrize("size", SIZES[:4])
def test_bc1_to_bc5_random_blocks_read_as_pil(tmp_path, name, size):
    """Random blocks of every FourCC and DX10 name of BC1-BC5: BC1's
    3-colour mode with transparent black, 565 widened by its high bits,
    C's truncating thirds and halves, BC2's nibbles, BC3/BC4/BC5's 8- and
    6-value ramps, BC5S's signed endpoints plus 128 and blue 128."""
    fourcc, dx, bs = BCN[name]
    h, w = size
    reads(tmp_path, cs.dds_file(w, h, blocks(len(name) * 7 + w, w, h, bs), fourcc=fourcc, dx10=dx), "DDS")


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_bc6h_random_blocks_read_as_pil(tmp_path, signed, seed):
    """BC6H (UF16 and SF16) of random blocks over all 14 modes and the
    reserved 4 (an all-zero block): the endpoints' bit layouts, signed
    values and deltas extended, a signed transform's sums not extended
    again (Pillow's rule, found by probing), unquantize, the weights
    without rounding, the half float's value * 255 truncated."""
    w, h = (12, 12) if seed % 2 else (9, 7)
    data = cs.dds_file(w, h, bc6h_blocks(seed * 2 + signed, w, h), fourcc=b"DX10", dx10=95 + signed)
    reads(tmp_path, data, "DDS")


@pytest.mark.parametrize("dxgi", [97, 98, 99])
@pytest.mark.parametrize("seed", range(3))
def test_bc7_random_blocks_read_as_pil(tmp_path, dxgi, seed):
    """BC7 of random blocks over its 8 modes and the reserved first byte
    of 0 (opaque black): partitions, anchors, p-bits, rotation and the
    index-selection bit; TYPELESS, UNORM and UNORM_SRGB alike."""
    w, h = (16, 12) if seed % 2 else (11, 9)
    reads(tmp_path, cs.dds_file(w, h, bc7_blocks(seed * 3 + dxgi, w, h), fourcc=b"DX10", dx10=dxgi), "DDS")


@pytest.mark.parametrize("encoder", ["bc1_grey", "bc4_grey", "bc7_grey"])
def test_chip_smoke_block_encoders_are_what_pil_reads(tmp_path, encoder):
    """``chip_smoke``'s min/max BC1 and BC4 encoders and its BC7 mode-6
    encoder (phase 12's pages): the grey each says it decodes to is PIL's."""
    g = image(21, 30)
    data, want = getattr(cs, encoder)(g)
    fourcc, dx = {"bc1_grey": (b"DXT1", None), "bc4_grey": (b"ATI1", None), "bc7_grey": (b"DX10", 98)}[encoder]
    reads(tmp_path, cs.dds_file(30, 21, data, fourcc=fourcc, dx10=dx), "DDS")
    np.testing.assert_array_equal(tdataset.decode_gray(tmp_path / "f.png"), want)


@pytest.mark.parametrize("name", ["DXT1", "DXT5", "BC4U", "BC5S", "BC6H", "BC7"])
def test_bcn_data_ending_early_is_refused(tmp_path, name):
    """Block data a byte short: PIL's bcn decoder waits for the block and
    ImageFile.load finds the file's end ("image file is truncated")."""
    fourcc, dx, bs = {"BC6H": (b"DX10", 95, 16), "BC7": (b"DX10", 98, 16)}.get(name, BCN.get(name))
    data = cs.dds_file(9, 6, blocks(3, 9, 6, bs), fourcc=fourcc, dx10=dx)
    reads(tmp_path, data, "DDS")
    refused(tmp_path, data[:-1], "DDS")


DDS_HEADERS = {
    "header_size_not_124": lambda d: d[:4] + struct.pack("<I", 120) + d[8:],
    "header_incomplete": lambda d: d[:100],
    "magic_only": lambda d: d[:6],
    "unknown_fourcc": lambda d: d[:84] + b"DXT2" + d[88:],
    "unknown_dxgi": lambda d: d[:84] + b"DX10" + d[88:128] + struct.pack("<I", 2) + bytes(16) + d[128:],
    "dx10_header_cut": lambda d: d[:84] + b"DX10" + d[88:128] + b"\x62\0",
    "luminance_16_without_alpha": lambda d: d[:80] + struct.pack("<II", 0x20000, 0) + struct.pack("<I", 16) + d[92:],
    "no_format_flags": lambda d: d[:80] + struct.pack("<I", 0) + d[84:],
    "zero_width": lambda d: d[:16] + struct.pack("<I", 0) + d[20:],
    "bomb": lambda d: d[:12] + struct.pack("<II", 0x10000, 0x10000) + d[20:],
}


@pytest.mark.parametrize("case", sorted(DDS_HEADERS))
def test_dds_header_rules_as_pil(tmp_path, case):
    """DdsImagePlugin's _open: a header size not 124, a header cut short,
    a FourCC, DXGI format or luminance bit count it does not read, no
    pixel format flag, or more pixels than the bomb limit: Image.open fails;
    the file cut inside its 8-byte preamble or DX10's format, or a size of
    0: it passes the file on and nothing else opens it. A zero image
    either way, in the port as in the JAX package."""
    base = cs.dds_file(12, 8, blocks(1, 12, 8, 8), fourcc=b"DXT1")
    assert holds(tmp_path / "f.png", DDS_HEADERS[case](base)) == (None, None)


# -- A.6.53 FTEX ----------------------------------------------------------------

@pytest.mark.parametrize("fmt", [0, 1])
@pytest.mark.parametrize("size", SIZES[:4])
def test_ftex_reads_as_pil(tmp_path, fmt, size):
    """FTEX of format 0 (bcn 1, RGBA) and 1 (raw RGB), under .ftc and .png
    names."""
    h, w = size
    data = blocks(w, w, h, 8) if fmt == 0 else image(h, w, 3).tobytes()
    reads(tmp_path, cs.ftex_file(w, h, data, fmt), "FTEX", ("f.ftc", "f.png"))


FTEX_CASES = {
    "two_formats": (lambda d: cs.ftex_file(9, 6, d, 0, formats=2), None),
    "format_2": (lambda d: cs.ftex_file(9, 6, d, 2), None),
    "negative_offset": (lambda d: cs.ftex_file(9, 6, d)[:28] + struct.pack("<i", -4) + cs.ftex_file(9, 6, d)[32:],
                        None),
    "size_minus_one": (lambda d: cs.ftex_file(9, 6, d, size=-1), "FTEX"),
    "size_minus_two": (lambda d: cs.ftex_file(9, 6, d, size=-2), None),
    "size_past_the_data": (lambda d: cs.ftex_file(9, 6, d, size=len(d) + 100), "FTEX"),
    "mipmap_short": (lambda d: cs.ftex_file(9, 6, d, size=len(d) - 1) + b"x", "FTEX"),
    "offset_past_the_file": (lambda d: cs.ftex_file(9, 6, d)[:28] + struct.pack("<i", 9999)
                             + cs.ftex_file(9, 6, d)[32:], None),
    "zero_width": (lambda d: cs.ftex_file(0, 6, d), None),
    "cut_in_the_header": (lambda d: cs.ftex_file(9, 6, d)[:27], None),
}


@pytest.mark.parametrize("case", sorted(FTEX_CASES))
def test_ftex_header_rules_as_pil(tmp_path, case):
    """FtexImagePlugin's _open: a format count not 1 (an AssertionError,
    which Image.open does not catch), a format not 0 or 1, a negative
    offset (seek raises), a mipmap byte count of -1 (the file's read(-1):
    the rest) and below (read raises), past the data (what is there), one
    byte short (the mipmap's BytesIO ends: refused), and a size of 0 (the
    plugin has closed the file: the next plugin's seek fails)."""
    build, fmt = FTEX_CASES[case]
    got, want = holds(tmp_path / "f.png", build(blocks(5, 9, 6, 8)))
    assert got == fmt and (want is not None) == (case in ("size_minus_one", "size_past_the_data"))


# -- A.6.54 BLP -----------------------------------------------------------------

@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("size", SIZES[:4])
def test_pillow_blp_reads_as_pil(tmp_path, version, alpha, size):
    """Pillow's BLP1 (encoding 5) and BLP2 (encoding 1): a palette of BGRA
    entries and the indices, mode RGB, or RGBA where the palette has
    alpha; under .blp and .png names."""
    reads(tmp_path, blp_pillow(image(*size, 4 if alpha else 3), version, alpha), "BLP", ("f.blp", "f.png"))


@pytest.mark.parametrize("enc", [0, 1, 7])
@pytest.mark.parametrize("alpha", [0, 8])
@pytest.mark.parametrize("width", [8, 9, 10, 11, 1])
def test_blp2_dxt_reads_sheared_as_pil(tmp_path, enc, alpha, width):
    """BLP2 DXT1, DXT3 and DXT5 through Pillow's Python decoders (565
    without its high bits copied down, Python's //): rows of ceil(w / 4) * 4
    pixels read w at a time by set_as_raw, so a width off a multiple of 4
    is read sheared, and DXT3/5 of no alpha (mode RGB) read 3 bytes of
    their RGBA a pixel."""
    h = 7
    data = cs.blp_file(width, h, blocks(enc * 10 + width + alpha, width, h, 8 if enc == 0 else 16), encoding=2,
                       alpha=alpha, alpha_encoding=enc)
    reads(tmp_path, data, "BLP")


def test_blp2_dxt_shear_is_real(tmp_path):
    """A DXT1 width of 5 reads rows of 8 pixels 5 at a time: not the
    image a decoder that crops each block row gives."""
    g = np.tile(np.arange(0, 256, 32, dtype=np.uint8), (8, 1))   # 8 x 8: each column's own grey
    blp = cs.blp_file(5, 8, cs.bc1_grey(g)[0], encoding=2, alpha_encoding=0)
    reads(tmp_path, blp, "BLP")
    got = tdataset.decode_gray(tmp_path / "f.png")
    assert not np.array_equal(got[1], got[0])


@pytest.mark.parametrize("kind", ["grey", "ycbcr_420", "ycbcr_444", "cmyk", "ycck", "progressive"])
def test_blp1_jpeg_reads_as_pil(tmp_path, kind):
    """BLP1's JPEG: the header and the first mipmap joined and read by the
    port's JPEG reader, PIL's RGB relabelled BGR (R and B swap before the
    luma); four components read as CMYK whatever Adobe's transform says
    (jpegmode "CMYK"), inverted as PIL's CMYK;I."""
    rgb = image(16, 24, 3)
    jpeg = {"grey": lambda: pil_jpeg(rgb[..., 0]), "ycbcr_420": lambda: pil_jpeg(rgb),
            "ycbcr_444": lambda: pil_jpeg(rgb, subsampling=0), "cmyk": lambda: pil_jpeg(rgb, "CMYK"),
            "ycck": lambda: ycck_bytes(np.random.RandomState(4).randint(0, 160, (16, 24, 4)).astype(np.uint8),
                                       ((2, 2), (1, 1), (1, 1), (2, 2)), 85),
            "progressive": lambda: pil_jpeg(rgb, progressive=True)}[kind]()
    with Image.open(io.BytesIO(jpeg)) as im:
        w, h = im.size
    reads(tmp_path, blp1_jpeg(jpeg, w, h), "BLP", ("f.blp", "f.png"))
    if kind != "grey":   # the swap shows
        with Image.open(io.BytesIO(jpeg)) as im:
            assert not np.array_equal(tdataset.decode_gray(tmp_path / "f.png"), np.asarray(im.convert("L")))


BLP1_JPEG = {
    "alpha": dict(alpha=8), "gap": dict(gap=b"0123456789"), "offset_behind": dict(offset=40),
    "offset_past_the_file": dict(offset=99999), "narrower_image": dict(w=10, h=16),
    "larger_image": dict(w=24, h=17),
}


@pytest.mark.parametrize("case", sorted(BLP1_JPEG))
def test_blp1_jpeg_layouts_as_pil(tmp_path, case):
    """Mode RGBA of alpha (raw BGR into RGBA), a gap before the mipmap (a
    skip), an offset behind the header (no skip back: the mipmap read where
    the header ended), an offset past the file (refused), an image narrower
    than the JPEG (its pixels read in order, sheared), larger (not enough
    image data: refused)."""
    rgb = image(16, 24, 3)
    kw = dict(BLP1_JPEG[case])
    w, h = kw.pop("w", 24), kw.pop("h", 16)
    fmt, want = holds(tmp_path / "f.png", blp1_jpeg(pil_jpeg(rgb), w, h, **kw))
    assert fmt == "BLP" and (want is None) == (case in ("offset_past_the_file", "larger_image"))


BLP_REFUSED = {
    "blp2_encoding_3": lambda: cs.blp_file(9, 6, bytes(54 * 4), encoding=3),
    "blp2_compression_0": lambda: cs.blp_file(9, 6, bytes(54), compression=0),
    "blp2_alpha_encoding_2": lambda: cs.blp_file(8, 4, bytes(32), encoding=2, alpha_encoding=2),
    "blp1_encoding_3": lambda: cs.blp_file(9, 6, bytes(54), version=1, encoding=3),
    "blp1_compression_2": lambda: cs.blp_file(9, 6, bytes(54), version=1, compression=2, encoding=5),
    "too_few_indices": lambda: cs.blp_file(9, 6, bytes(53)),
    "indices_cut": lambda: cs.blp_file(9, 6, bytes(54))[:-1],
    "palette_cut": lambda: cs.blp_file(9, 6, b"")[:600],
    "table_cut": lambda: cs.blp_file(9, 6, b"")[:100],
    "dxt_cut": lambda: cs.blp_file(8, 8, bytes(32), encoding=2)[:-1],
    "jpeg_not_a_jpeg": lambda: cs.blp_file(9, 6, b"\xff\xd8\x00" + bytes(50), version=1, compression=0),
}


@pytest.mark.parametrize("case", sorted(BLP_REFUSED))
def test_blp_refusals_as_pil(tmp_path, case):
    """Encoding 3 (UNCOMPRESSED_RAW_BGRA: "Unknown BLP encoding"), another
    compression or alpha encoding, BLP1 encodings but 4 and 5, fewer
    indices than pixels ("not enough image data"), data cut anywhere
    (_safe_read's "Truncated File Read"), a JPEG that is not one: a zero
    image, as in the JAX package."""
    refused(tmp_path, BLP_REFUSED[case](), "BLP")
    assert not jdataset.decode_image(tmp_path / "f.png", 8).any()


def test_blp1_header_of_24_bytes_opens(tmp_path):
    """BLP1's _open reads 24 bytes and seeks past the subtype: a file of 24
    bytes opens as BLP (and has no pixels: refused); 23 bytes pass on."""
    data = cs.blp_file(9, 6, bytes(54), version=1, encoding=5)
    assert holds(tmp_path / "f.png", data[:24]) == ("BLP", None)
    assert holds(tmp_path / "f.png", data[:23]) == (None, None)


# -- every route, damaged ---------------------------------------------------------

@pytest.mark.parametrize("fmt", ["DDS-RGB", "DDS-LP", "DDS-BC1-5", "DDS-BC6H", "DDS-BC7", "FTEX", "BLP"])
@pytest.mark.parametrize("part", range(2))
def test_damaged_files_read_as_pil(tmp_path, fmt, part):
    """The probe (``scripts/raster_probe.py``), 60 files a part: the bases
    damaged six ways, each read bit-equal where PIL reads, corrupt where it
    refuses."""
    counts = probe(tmp_path / "f.png", BASES[fmt](), 200 + part, 60)
    assert sum(c[0] for c in counts.values()) > 0 and sum(c[1] for c in counts.values()) > 0


# -- the slice as a whole -----------------------------------------------------------

def test_texture_tree_builds_as_the_jax_package(tmp_path, monkeypatch):
    """A folder of one DDS (BC7), FTEX (DXT1), BLP (DXT1, sheared) and
    SPIDER file each, named .png (``list_images`` filters by suffix), beside
    a PNG: the port's ``decode_images`` at 1 and 4 threads equals the JAX
    package's ``SignatureDataset``, and ``cli.preprocess`` takes them all."""
    from siggan_tpu.data.native import loader as jnative
    from siggan_tpu_torch.cli import preprocess as tcli
    from siggan_tpu_torch.data import dataset as dmod
    from siggan_tpu_torch.infer.export import encode_png
    monkeypatch.setattr(jnative, "available", lambda: False)
    raw = tmp_path / "raw" / "w0"
    raw.mkdir(parents=True)
    g = image(70, 90)
    files = {"w0_a.png": cs.dds_file(90, 70, cs.bc7_grey(g)[0], fourcc=b"DX10", dx10=98),
             "w0_b.png": cs.ftex_file(90, 70, cs.bc1_grey(g)[0]),
             "w0_c.png": cs.blp_file(90, 70, cs.bc1_grey(g)[0], encoding=2, alpha_encoding=0),
             "w0_d.png": cs.spider_file(spider_values(70, 90)),
             "w0_e.png": encode_png(g)}
    for name, data in files.items():
        (raw / name).write_bytes(data)
        assert_port_reads_as_pil(raw / name)
    assert [pil_verdict(raw / n)[0] for n in sorted(files)] == ["DDS", "FTEX", "BLP", "SPIDER", "PNG"]
    want = jdataset.SignatureDataset(raw, 32, use_cache=False).images
    assert want.any(axis=(1, 2, 3)).all()
    for threads in (1, 4):
        np.testing.assert_array_equal(dmod.decode_images(sorted(raw.iterdir()), 32, n_threads=threads), want)
    tcli.main(["--input_dir", str(tmp_path / "raw"), "--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    report = json.loads((tmp_path / "t" / "preprocess_report.json").read_text())
    assert len(report["processed"]) + len(report["invalid"]) == 5
