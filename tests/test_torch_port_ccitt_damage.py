"""Damaged CCITT data (ROADMAP C.14) read as libtiff's fax decoder reads it
for PIL: each recovery rule of ``decode.cpp::fax_strip``, in Modified
Huffman, T.4 1-D and 2-D and T.6 (Group 4), on code written bit by bit,
and a seeded probe of PIL-written files damaged at random.

The reference is PIL's own libtiff (``tests/torch_port_libtiff.py``): the
port must refuse (a zero image) where a strip fails and PIL refuses, and
give libtiff's pixels from a cleared buffer where PIL reads, PIL's own
wherever libtiff wrote (rows a Group 4 strip did not reach keep PIL's
buffer, which is uncleared memory in its first strip). Where every row is
determined (written, or kept from an earlier strip), the file is also held
whole to PIL and the JAX package through ``assert_port_reads_as_pil``.
"""

import io

import numpy as np
import pytest
from PIL import Image

from test_torch_port_decode import assert_port_reads_as_pil, tiff_file
from torch_port_libtiff import assert_reads_as_libtiff

from test_torch_port_ccitt import CODINGS, page, strips  # noqa: E402  (after the decode helpers)

WHITE = {0: "00110101", 1: "000111", 2: "0111", 3: "1000", 4: "1011", 5: "1100", 6: "1110",
         7: "1111", 8: "10011", 9: "10100", 10: "00111", 11: "01000", 12: "001000",
         13: "000011", 14: "110100", 15: "110101", 16: "101010", 20: "0001000"}
BLACK = {0: "0000110111", 1: "010", 2: "11", 3: "10", 4: "011", 5: "0011", 6: "0010",
         7: "00011", 8: "000101", 9: "000100", 10: "0000100", 11: "0000101", 12: "0000111",
         13: "00000100", 14: "00000111", 15: "000011000", 16: "0000010111"}
EOL = "000000000001"
V0, VR1, VL1, VL3, HORIZ, PASS, EXT = "1", "011", "010", "0000010", "001", "0001", "0000001111"
BAD = "000000001"          # no run code starts so: libtiff's table has no entry for it


def packed(bits: str) -> bytes:
    bits = bits.replace(" ", "")
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def fax_file(w, h, blobs, compression, t4=None, rps=None, photometric=0, fill_order=1):
    """A little-endian bilevel TIFF of coded strips ``blobs`` (bit strings
    or bytes)."""
    blobs = [b if isinstance(b, bytes) else packed(b) for b in blobs]
    if fill_order == 2:
        rev = bytes(int(f"{v:08b}"[::-1], 2) for v in range(256))
        blobs = [b.translate(rev) for b in blobs]
    tags = [(258, 3, [1]), (259, 3, [compression]), (262, 3, [photometric]), (277, 3, [1]),
            (273, 4, None), (278, 4, [rps or h]), (279, 4, None)]
    if t4 is not None:
        tags.append((292 if compression == 3 else 293, 4, [t4]))
    if fill_order == 2:
        tags.append((266, 3, [2]))
    return tiff_file(w, h, blobs, tags)


def mh_row(bits: str) -> str:
    """A Modified Huffman row: its codes, then fill to the byte."""
    return bits + "0" * (-len(bits) % 8)


# name: (file, PIL reads it, every row determined)
RULES = {
    # Modified Huffman: a bad code ends the row, padded in the colour it
    # had reached; the next row starts on the next byte.
    "mh_bad_code_pads_the_row": (lambda: fax_file(16, 3, [
        mh_row(WHITE[4] + BLACK[3] + BAD) + mh_row(WHITE[16]) + mh_row(WHITE[2] + BLACK[14])], 2),
        True, True),
    "mh_row_too_long_is_cut": (lambda: fax_file(16, 2, [
        mh_row(WHITE[20] + BLACK[3]) + mh_row(WHITE[3] + BLACK[13])], 2), True, True),
    "mh_data_ending_early_is_refused": (lambda: fax_file(16, 3, [
        mh_row(WHITE[16]) + mh_row(WHITE[4])], 2), False, True),
    # T.4 1-D: an EOL inside a row ends it; the next row syncs on it.
    "t4_eol_inside_a_row": (lambda: fax_file(16, 2, [
        EOL + WHITE[4] + BLACK[3] + EOL + WHITE[2] + BLACK[14]], 3), True, True),
    # ... and garbage between rows is skipped to the next EOL.
    "t4_garbage_skipped_to_the_next_eol": (lambda: fax_file(16, 2, [
        EOL + WHITE[16] + "1101101" + EOL + WHITE[5] + BLACK[10] + WHITE[1]], 3),
        True, True),
    # No EOL to find: the strip is read again from its first bit, without
    # EOLs, from that row on.
    "t4_without_eols": (lambda: fax_file(20, 4, [(WHITE[3] + BLACK[2] + WHITE[15]) * 4], 3),
                        True, True),
    "t4_eols_stop_at_row_1": (lambda: fax_file(20, 3, [
        EOL + WHITE[20] + (WHITE[3] + BLACK[2] + WHITE[15]) * 3], 3), True, True),
    # ... and so in every later strip, whose EOLs are then run codes.
    "t4_no_eol_mode_carries_to_the_next_strip": (lambda: fax_file(20, 4, [
        (WHITE[3] + BLACK[2] + WHITE[15]) * 2,
        (EOL + WHITE[20]) * 2], 3, rps=2), True, True),
    # A strip that runs out of EOLs before its last row is such a strip.
    "t4_data_ending_early_is_read_again_without_eols": (lambda: fax_file(16, 3, [
        EOL + WHITE[16] + EOL + WHITE[16]], 3), True, True),
    # T.4 2-D: a vertical mode left of a0 ends the row; a horizontal pair
    # past the width is cut; an EOL inside a row fills the rest in the
    # colour of the runs so far.
    "t4_2d_vl_left_of_a0": (lambda: fax_file(16, 3, [
        EOL + "1" + WHITE[4] + BLACK[12] + EOL + "0" + VL3 + EOL + "1" + WHITE[16]], 3, 1),
        True, True),
    "t4_2d_horizontal_past_the_width": (lambda: fax_file(16, 2, [
        EOL + "0" + HORIZ + WHITE[10] + BLACK[10] + EOL + "1" + WHITE[16]], 3, 1), True, True),
    "t4_2d_eol_inside_a_row": (lambda: fax_file(16, 2, [
        EOL + "0" + HORIZ + WHITE[3] + BLACK[4] + EOL + "1" + WHITE[16]], 3, 1), True, True),
    # Group 4: a bad code ends the strip, which keeps its rows; the rows it
    # did not reach keep the previous strip's.
    "g4_bad_code_keeps_the_previous_strips_rows": (lambda: fax_file(16, 8, [
        (HORIZ + WHITE[4] + BLACK[5] + V0) * 4,
        HORIZ + WHITE[2] + BLACK[3] + V0 + V0 + BAD], 4, rps=4), True, True),
    "g4_eofb_inside_a_strip": (lambda: fax_file(16, 8, [
        (HORIZ + WHITE[1] + BLACK[9] + V0) * 4,
        HORIZ + WHITE[6] + BLACK[6] + V0 + V0 + EOL + EOL], 4, rps=4), True, True),
    "g4_extension_code_ends_the_row": (lambda: fax_file(16, 6, [
        (HORIZ + WHITE[3] + BLACK[3] + V0) * 3,
        HORIZ + WHITE[8] + BLACK[2] + VR1 + V0 + EXT], 4, rps=3), True, True),
    # ... and in its first row it fails, and PIL refuses the file.
    "g4_eol_in_the_first_row_is_refused": (lambda: fax_file(16, 4, [EOL + EOL], 4), False, True),
    # Past the data's end the reader takes zero bits: a row cut short ends
    # the strip at the EOL those bits make; the rows after it keep the
    # buffer (PIL's uncleared memory in a first strip).
    "g4_data_ending_inside_a_row": (lambda: fax_file(16, 4, [
        HORIZ + WHITE[3] + BLACK[3] + V0 + HORIZ + WHITE[5]], 4), True, False),
    # A horizontal pair past the width in Group 4; FillOrder 2 as well.
    "g4_horizontal_past_the_width": (lambda: fax_file(16, 3, [
        HORIZ + WHITE[12] + BLACK[9] + V0 + V0 + V0], 4), True, True),
    "g4_fill_order_2_bad_code": (lambda: fax_file(16, 8, [
        (HORIZ + WHITE[4] + BLACK[5] + V0) * 4,
        HORIZ + WHITE[2] + BLACK[3] + V0 + BAD], 4, rps=4, fill_order=2), True, True),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_recovery_rule_reads_as_libtiff(tmp_path, name):
    make, reads, determined = RULES[name]
    data = make()
    assert_reads_as_libtiff(data, tmp_path, reads=reads)
    if reads and determined:
        path = tmp_path / f"{name}.tif"
        path.write_bytes(data)
        assert_port_reads_as_pil(path)


def damaged(rs, coding: str) -> bytes:
    """A PIL-written CCITT file (one strip or several) damaged at random:
    bits flipped, a byte set, the strip cut, bytes inserted, or a strip of
    noise; FillOrder 2 for some."""
    h, w = int(rs.randint(2, 28)), int(rs.choice([rs.randint(1, 70), 100, 1728]))
    rps = int(rs.choice([h, rs.randint(1, h + 1)]))
    compression, t4 = CODINGS[coding]
    info = {} if t4 is None else {292: t4}
    info[278] = rps
    buf = io.BytesIO()
    Image.fromarray(page(rs, h, w, rs.choice(["noise", "strokes"]))).save(
        buf, "TIFF", compression=compression, tiffinfo=info)
    blobs = [bytearray(b) for b in strips(buf.getvalue())]
    b = blobs[rs.randint(len(blobs))]
    kind = rs.randint(5)
    if kind == 0 and b:
        for _ in range(rs.randint(1, 4)):
            p = rs.randint(len(b))
            b[p] ^= 1 << rs.randint(8)
    elif kind == 1 and b:
        b[rs.randint(len(b))] = rs.randint(256)
    elif kind == 2:
        del b[rs.randint(len(b) + 1):]
    elif kind == 3:
        p = rs.randint(len(b) + 1)
        b[p:p] = bytes(rs.randint(0, 256, rs.randint(1, 5)).tolist())
    else:
        b[:] = bytes(rs.randint(0, 256, rs.randint(0, 30)).tolist())
    code = {"tiff_ccitt": 2, "group3": 3, "group4": 4}[compression]
    return fax_file(w, h, [bytes(x) for x in blobs], code, t4, rps, photometric=int(rs.randint(2)),
                    fill_order=1 + int(rs.rand() < 0.25))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_damage_probe_reads_as_libtiff(tmp_path, seed):
    """45 damaged files a seed, the six codings in turn: every one read as
    PIL's libtiff reads it (refused, or libtiff's pixels)."""
    rs = np.random.RandomState(1000 + seed)
    verdicts = []
    for i in range(45):
        coding = sorted(CODINGS)[i % 6]
        verdicts.append(assert_reads_as_libtiff(damaged(rs, coding), tmp_path) is not None)
    assert 0 < sum(verdicts) < len(verdicts)    # both verdicts occur
