"""PIXAR (A.6.56), GBR (A.6.57), McIdas (A.6.58) and IMT (A.6.59) in the
port's host decoder (``decode.cpp``: ``pixar_open``, ``gbr_open``,
``mcidas_open``, ``imt_open`` and the raw tile reader ``raw_tile``),
bit-equal with PIL's ``Image.open(path).convert("L")`` (Pillow 12.1.0) and
with the JAX package's ``decode_image``: each plugin's header rules (what
passes the file on to the next plugin, what makes PIL refuse it) and its
tile, as PIL's raw decoder or, for a file opened by its name in L or
I;16B, its map of the file reads it. Files are ``chip_smoke.py``'s
writers (Pillow writes none of these formats)."""

import struct

import numpy as np
import pytest
from test_torch_port_decode import assert_port_reads_as_pil
from torch_port_header_cases import BASES, mcidas_values, verdict
from torch_port_raster_cases import image, probe

import chip_smoke as cs
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset


def reads(tmp_path, data: bytes, names=("f.png",)):
    for name in names:
        (tmp_path / name).write_bytes(data)
        assert verdict(tmp_path / name, data) == "read"
        assert_port_reads_as_pil(tmp_path / name)


def refused(tmp_path, data: bytes, want: str = "refused"):
    """PIL refuses (or passes on) the file: a zero image in both packages."""
    path = tmp_path / "f.png"
    assert verdict(path, data) == want
    assert not jdataset.decode_image(path, 8).any()
    np.testing.assert_array_equal(tdataset.decode_image(path, 8), jdataset.decode_image(path, 8))


# -- PIXAR --------------------------------------------------------------------

@pytest.mark.parametrize("size", [(5, 7), (1, 1), (40, 3), (3, 300)])
def test_pixar_reads_as_pil(tmp_path, size):
    """Raw RGB from byte 1024 (PIL's luma), under .pxr and .png names."""
    reads(tmp_path, cs.pixar_file(image(*size, 3)), ("f.pxr", "f.png"))


def pixar_head(**at) -> bytes:
    head = bytearray(cs.pixar_file(image(5, 7, 3)))
    for off, v in at.items():
        struct.pack_into("<H", head, int(off[1:]), v)
    return bytes(head)


PIXAR_CASES = {
    # name: (bytes, what PIL does)
    "extra_bytes": (lambda: cs.pixar_file(image(5, 7, 3)) + bytes(50), "read"),
    "channels_14_1": (lambda: cs.pixar_file(image(5, 7, 3), mode=(14, 1)), "passed"),
    "channels_3_2": (lambda: cs.pixar_file(image(5, 7, 3), mode=(3, 2)), "passed"),
    "width_0": (lambda: pixar_head(o418=0), "passed"),
    "height_0": (lambda: pixar_head(o416=0), "passed"),
    "header_427_bytes": (lambda: cs.pixar_file(image(5, 7, 3))[:427], "passed"),
    "header_428_bytes": (lambda: cs.pixar_file(image(5, 7, 3))[:428], "refused"),
    "pixels_a_byte_short": (lambda: cs.pixar_file(image(5, 7, 3))[:-1], "refused"),
}


@pytest.mark.parametrize("case", sorted(PIXAR_CASES))
def test_pixar_header_rules_as_pil(tmp_path, case):
    """Mode RGB only for the pair (14, 2) at 424 (else no mode: passed on),
    no size passed on, a header cut before 428 bytes passed on
    (struct.error), the raw decoder's rows whole or refused."""
    make, want = PIXAR_CASES[case]
    data = make()
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


# -- GBR ----------------------------------------------------------------------

@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("comment", [b"", b"a brush", b"x" * 300])
def test_gbr_reads_as_pil(tmp_path, version, depth, comment):
    """Versions 1 and 2, depth 1 (L) and 4 (RGBA: its luma), comments of
    any length, under .gbr and .png names."""
    reads(tmp_path, cs.gbr_file(image(6, 9, depth if depth > 1 else 0), version, comment),
          ("f.gbr", "f.png"))


def gbr_fields(**kw) -> bytes:
    data = bytearray(cs.gbr_file(image(5, 7)))
    for i, name in enumerate(("head", "version", "w", "h", "depth")):
        if name in kw:
            struct.pack_into(">I", data, 4 * i, kw[name])
    return bytes(data)


GBR_CASES = {
    "version_3": (lambda: gbr_fields(version=3), "passed"),
    "depth_2": (lambda: gbr_fields(depth=2), "passed"),
    "width_0": (lambda: gbr_fields(w=0), "passed"),
    "header_19": (lambda: gbr_fields(head=19), "passed"),
    "no_gimp_magic": (lambda: gbr_fields()[:20] + b"GIMQ" + gbr_fields()[24:], "passed"),
    "cut_in_spacing": (lambda: gbr_fields()[:26], "passed"),
    "v2_header_20": (lambda: gbr_fields(head=20), "refused"),        # read(-8)
    "v2_header_27": (lambda: gbr_fields(head=27), "refused"),        # read(-1): no pixels left
    "v1_header_21": (lambda: cs.gbr_file(image(5, 7), 1, b"", header_size=21), "read"),
    "comment_past_the_file": (lambda: gbr_fields(head=10 ** 6), "refused"),
    "pixels_a_byte_short": (lambda: gbr_fields()[:-1], "refused"),
    "bomb": (lambda: gbr_fields(w=10 ** 5, h=10 ** 5), "refused"),
}


@pytest.mark.parametrize("case", sorted(GBR_CASES))
def test_gbr_header_rules_as_pil(tmp_path, case):
    """A version, depth or size PIL does not know, a header size below 20,
    version 2 without "GIMP" or cut before its spacing: passed on; a
    comment length below -1 refused (a file's read() takes no other
    negative length), -1 reading the rest (no pixels: refused); frombytes
    needs every pixel."""
    make, want = GBR_CASES[case]
    data = make()
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


# -- McIdas -------------------------------------------------------------------

@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("prefix", [0, 5])
@pytest.mark.parametrize("bands", [1, 3])
def test_mcidas_reads_as_pil(tmp_path, size, prefix, bands):
    """1, 2 (I;16B: 255 past 255) and 4 (I;32B: clipped) bytes an element,
    with a line prefix and more bands (the stride skips them)."""
    reads(tmp_path, cs.mcidas_file(mcidas_values(6, 9, size), prefix=prefix, bands=bands))


MCIDAS_CASES = {
    # name: (element bytes, words, cut, what PIL does)
    "type_3": (1, {11: 3}, 0, "passed"),
    "lines_0": (1, {9: 0}, 0, "passed"),
    "elements_negative": (2, {10: -9}, 0, "passed"),
    "offset_negative_l": (1, {34: -300}, 0, "refused"),
    "offset_negative_i": (4, {34: -300}, 0, "refused"),
    "offset_past_the_file_l": (1, {34: 10 ** 6}, 0, "refused"),
    "stride_short_l": (1, {15: -3}, 0, "read"),            # mapped: rows 6 bytes apart
    "stride_short_i": (4, {15: -3}, 0, "refused"),         # the raw decoder's stride check
    "stride_negative_l": (1, {15: -20}, 0, "read"),        # mapped: offset + h * stride fits; default stride
    "stride_past_int": (1, {14: 1 << 30}, 0, "refused"),
    "last_row_short_l": (1, {}, 1, "refused"),
    "last_row_short_i16": (2, {}, 1, "refused"),
    "last_row_short_i": (4, {}, 1, "refused"),
    "header_cut": (1, {}, 10 ** 6, "passed"),
}


@pytest.mark.parametrize("case", sorted(MCIDAS_CASES))
def test_mcidas_header_rules_as_pil(tmp_path, case):
    """A mode or size PIL does not take passed on; a negative offset
    refused (the map's check, or the raw decoder's seek); a tile of L or
    I;16B mapped where offset + h * stride fits in the file (a stride of 0
    or less read as a row's width, rows that overlap read as they lie),
    else through the raw decoder (a stride below a row's bytes refused);
    a stride past C's int refused; data a byte short refused."""
    size, words, cut, want = MCIDAS_CASES[case]
    dtype = {1: np.uint8, 2: np.uint16, 4: np.int32}[size]
    data = cs.mcidas_file(mcidas_values(6, 9, size).astype(dtype), prefix=2, words=words)
    data = data[:max(len(data) - cut, 200)] if cut else data
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


# -- IMT ----------------------------------------------------------------------

@pytest.mark.parametrize("size", [(5, 7), (1, 1), (40, 3), (3, 300)])
def test_imt_reads_as_pil(tmp_path, size):
    """width, height and pixel n8, then a form feed and the raw L pixels
    (mapped: the file opened by its name)."""
    reads(tmp_path, cs.imt_file(image(*size)), ("f.imt", "f.png"))


IMT_CASES = {
    "size_after_the_mode": (["pixel n8", "height 5", "width 7"], 0, "read"),
    "cr_line_ends": (["width 7\r", "height 5\r", "pixel n8\r"], 0, "read"),
    "comments": (["* a", "width 7", "* b " * 10, "height 5", "pixel n8"], 0, "read"),
    "unknown_keys": (["title scan", "width 7", "height 5", "pixel n8", "depth 8"], 0, "read"),
    "no_mode": (["width 7", "height 5"], 0, "passed"),
    "mode_n16": (["width 7", "height 5", "pixel n16"], 0, "passed"),
    "no_height": (["width 7", "pixel n8"], 0, "passed"),
    "width_not_a_number": (["width 7x", "height 5", "pixel n8"], 0, "refused"),
    "width_empty": (["width ", "height 5", "pixel n8"], 0, "refused"),
    "upper_case_key": (["Width 7", "height 5", "pixel n8"], 0, "passed"),
    "line_of_one_byte": (["width 7", "", "height 5", "pixel n8"], 0, "passed"),
    "comment_of_one_byte": (["width 7", "*", "height 5", "pixel n8"], 0, "passed"),
    "line_past_100": (["width 7", "height 5", "pixel n8", "x" * 120], 0, "refused"),  # no form feed read
    "pixels_a_byte_short": (["width 7", "height 5", "pixel n8"], 1, "refused"),
}


@pytest.mark.parametrize("case", sorted(IMT_CASES))
def test_imt_header_rules_as_pil(tmp_path, case):
    """The field regex's keys (lower case), comments, a line of one byte or
    past 100 ending the header (then no form feed is read: no tile, PIL
    refuses the file), int() of the sizes, the mode n8 alone; the mapped
    pixels whole or refused."""
    lines, cut, want = IMT_CASES[case]
    data = cs.imt_file(image(5, 7), lines)
    data = data[:-cut] if cut else data
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


@pytest.mark.parametrize("fmt", ["PIXAR", "GBR", "MCIDAS", "IMT"])
@pytest.mark.parametrize("part", range(2))
def test_damaged_files_read_as_pil(tmp_path, fmt, part):
    """The probe (``scripts/raster_probe.py``), 100 files a part: the bases
    damaged six ways, each read bit-equal where PIL reads, corrupt where it
    refuses."""
    counts = probe(tmp_path / "f.png", BASES[fmt](), 500 + part, 100)
    assert counts.get(fmt, [0, 0])[0] > 0 and sum(c[1] for c in counts.values()) > 0
