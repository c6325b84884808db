"""FLI and FLC (A.6.62) in the port's host decoder (``decode.cpp``:
``fli_open``, ``decode_fli``), bit-equal with PIL's
``Image.open(path).convert("L")`` (Pillow 12.1.0) and with the JAX
package's ``decode_image``: FliImagePlugin's header checks and palette
(the first frame's first COLOR_256 or COLOR_64 chunk, else grey), and the
first frame through Pillow's FliDecode.c, chunk kind by chunk kind:
BLACK, COPY, BRUN, LC (byte delta), SS2 (word delta), PSTAMP and the
colour chunks skipped, every overrun refused. No FLI writer and no
FliDecode.c source are at hand: the files are ``chip_smoke.py``'s writers
and chunks built here byte by byte, each held against PIL's decoder."""

import struct

import numpy as np
import pytest
from test_torch_port_plain_headers import reads, refused
from torch_port_header_cases import BASES, fli_palette_colours
from torch_port_raster_cases import image, probe

import chip_smoke as cs

G = image(6, 10)
PAL = fli_palette_colours()


@pytest.mark.parametrize("magic", [0xAF11, 0xAF12])
@pytest.mark.parametrize("size", [(6, 10), (1, 1), (40, 3), (3, 300)])
def test_fli_brun_reads_as_pil(tmp_path, magic, size):
    """A BRUN frame (runs and literals) under a COLOR_256 palette, FLI and
    FLC, under .flc and .png names (a PSTAMP chunk last: a chunk needs 10
    bytes left)."""
    g = image(*size)
    chunks = [cs.fli_palette(PAL), cs.fli_brun(g), cs.fli_chunk(18, bytes(4))]
    reads(tmp_path, cs.fli_file(size[1], size[0], chunks, magic=magic),
          ("f.flc", "f.png"))


@pytest.mark.parametrize("kind", ["copy", "brun", "lc", "ss2", "black", "pstamp"])
@pytest.mark.parametrize("palette", ["grey", "color_256", "color_64", "skip"])
def test_fli_chunk_kinds_read_as_pil(tmp_path, kind, palette):
    """Each chunk kind after a first image (COPY), under a grey palette,
    COLOR_256, COLOR_64 (values << 2, past 255 kept to their low byte) and
    a palette chunk that skips entries and sets a few."""
    second = image(6, 10, seed=11)
    chunks = {"copy": [cs.fli_chunk(16, second.tobytes())], "brun": [cs.fli_brun(second)],
              "lc": [cs.fli_lc(second[1:5], 1)], "ss2": [cs.fli_ss2(second)],
              "black": [cs.fli_chunk(13, b""), cs.fli_chunk(18, bytes(4))],
              "pstamp": [cs.fli_chunk(18, bytes(30))]}[kind]
    pal = {"grey": [], "color_256": [cs.fli_palette(PAL)], "color_64": [cs.fli_palette(PAL, 11)],
           "skip": [cs.fli_palette(PAL[:20], 4, skip=30)]}[palette]
    reads(tmp_path, cs.fli_file(10, 6, [*pal, cs.fli_chunk(16, G.tobytes()), *chunks]))


def ss2_chunk(*lines_words) -> bytes:
    """An SS2 chunk from per-line lists of 16-bit words (flag words and
    packets' counts included), given as they are to be stored."""
    out = struct.pack("<H", len(lines_words))
    for words in lines_words:
        out += b"".join(w if isinstance(w, bytes) else struct.pack("<H", w) for w in words)
    return cs.fli_chunk(7, out)


SS2_CASES = {
    # a line skip (0xC000 | -skip), the last byte of an odd row (0x8000 | byte), runs and copies
    "skip_two_lines": ss2_chunk([0x10000 - 2, 1, bytes([2, 3]) + b"abcdef"], [1, bytes([0, 0xFE]) + b"xy"]),
    "last_byte": ss2_chunk([0x8000 | 0x5A, 1, bytes([0, 2]) + b"pqrs"]),
    "run": ss2_chunk([2, bytes([1, 0xFD]) + b"mn", bytes([0, 1]) + b"zz"]),
    "skip_past_the_image": ss2_chunk([0x10000 - 9, 0]),
    "copy_past_the_row": ss2_chunk([1, bytes([8, 2]) + b"abcd"]),
    "lines_past_the_data": ss2_chunk([1, bytes([0, 1]) + b"ab"], [5]),
}


@pytest.mark.parametrize("case", sorted(SS2_CASES))
def test_fli_ss2_words_as_pil(tmp_path, case):
    """SS2's flag words (lines skipped; the last byte of a row of odd
    width), word runs and copies, and its overruns (a skip or a packet
    past the image, data past the chunk), on a width of 9."""
    first = image(6, 9)
    data = cs.fli_file(9, 6, [cs.fli_chunk(16, first.tobytes()), SS2_CASES[case]])
    fmt_want = "read" if case in ("skip_two_lines", "last_byte", "run") else "refused"
    if fmt_want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data)


def lc_chunk(y0: int, rows, packets) -> bytes:
    out = struct.pack("<HH", y0, rows)
    for p in packets:
        out += bytes([len(p)]) + b"".join(p)
    return cs.fli_chunk(12, out)


LC_CASES = {
    "skip_and_run": (lc_chunk(2, 1, [[bytes([3, 0xFE, 9]), bytes([1, 2]) + b"ab"]]), "read"),
    "rows_past_the_image": (lc_chunk(4, 5, [[bytes([0, 1, 7])]] * 5), "refused"),
    "run_past_the_row": (lc_chunk(0, 1, [[bytes([8, 0xFD, 1])]]), "refused"),
    "data_past_the_chunk": (lc_chunk(0, 2, [[bytes([0, 1]) + b"a"]]), "refused"),
}


@pytest.mark.parametrize("case", sorted(LC_CASES))
def test_fli_lc_packets_as_pil(tmp_path, case):
    """LC's skips, byte runs and copies from its first line, and its
    overruns (lines past the image, a packet past a row, data past the
    chunk)."""
    chunk, want = LC_CASES[case]
    data = cs.fli_file(10, 6, [cs.fli_chunk(16, G.tobytes()), chunk])
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data)


def header(**at) -> bytes:
    data = bytearray(cs.fli_file(10, 6, [cs.fli_brun(G)]))
    for off, v in at.items():
        data[int(off[1:])] = v
    return bytes(data)


def frame_of(chunks, **kw) -> bytes:
    return cs.fli_file(10, 6, chunks, **kw)


FLI_CASES = {
    # name: (bytes, what PIL does)
    "flags_2": (lambda: header(o14=2), "passed"),
    "byte_20_set": (lambda: header(o20=1), "passed"),
    "byte_50_set": (lambda: header(o50=1), "passed"),
    "byte_100_set": (lambda: header(o100=1), "passed"),
    "bytes_22_to_42_set": (lambda: header(o22=7, o30=9, o41=1), "read"),
    "bytes_80_to_88_set": (lambda: header(o80=7, o87=9), "read"),
    "no_frames": (lambda: header(o6=0), "passed"),                   # seek(0): EOFError
    "width_0": (lambda: header(o8=0), "passed"),
    "header_only": (lambda: header()[:128], "passed"),             # missing frame size
    "prefix_chunk": (lambda: frame_of([cs.fli_brun(G)], prefix=bytes(12)), "refused"),   # the frame at 128
    "palette_past_256": (lambda: frame_of([cs.fli_palette(PAL[:10], 4, skip=250), cs.fli_brun(G)]), "passed"),
    "palette_cut": (lambda: frame_of([cs.fli_palette(PAL)])[:300], "passed"),
    "palette_after_other_chunks": (lambda: frame_of([cs.fli_brun(G), cs.fli_palette(PAL)]), "read"),
    "second_palette_ignored": (lambda: frame_of([cs.fli_palette(PAL), cs.fli_palette(PAL[::-1]),
                                                 cs.fli_brun(G)]), "read"),
    "unknown_chunk": (lambda: frame_of([cs.fli_brun(G), cs.fli_chunk(99, bytes(8))]), "refused"),
    "black_last": (lambda: frame_of([cs.fli_brun(G), cs.fli_chunk(13, b"")]), "refused"),   # fewer than 10 bytes left
    "chunk_of_size_0": (lambda: frame_of([struct.pack("<IH", 0, 13) + bytes(8)]), "refused"),
    "chunk_past_the_frame": (lambda: frame_of([struct.pack("<IH", 500, 13) + bytes(8)]), "refused"),
    "no_chunks": (lambda: frame_of([]), "read"),
    "frame_size_odd_pad": (lambda: frame_of([cs.fli_brun(G)], frame_size=len(cs.fli_brun(G)) + 17)
                           [:-1] + b"", "refused"),
    "frame_cut": (lambda: frame_of([cs.fli_brun(G)])[:-5], "refused"),
    "copy_short": (lambda: frame_of([cs.fli_chunk(16, G.tobytes()[:40])]), "refused"),
    "brun_row_short": (lambda: frame_of([cs.fli_chunk(15, bytes([0, 5, 1]) * 6)]), "refused"),
    "not_a_frame": (lambda: frame_of([cs.fli_brun(G)])[:132] + b"\x00\xf2" + frame_of([cs.fli_brun(G)])[134:],
                    "refused"),
    "bomb": (lambda: header(o8=0xFF, o9=0xFF, o10=0xFF, o11=0xFF), "refused"),
}


@pytest.mark.parametrize("case", sorted(FLI_CASES))
def test_fli_header_and_frame_rules_as_pil(tmp_path, case):
    """The header's zero bytes and flags, no frames or no frame size
    (passed on), a prefix chunk (the palette search skips it, the decoder
    does not: refused), a palette past 256 entries or cut short (passed
    on), the first palette only; the decoder's refusals: an unknown chunk,
    fewer than 10 bytes left for a chunk, a chunk size of 0 or past the
    frame, a frame cut short, a COPY past the frame, a BRUN row not whole,
    a frame chunk that is no frame, the bomb limit."""
    make, want = FLI_CASES[case]
    data = make()
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


@pytest.mark.parametrize("part", range(3))
def test_damaged_files_read_as_pil(tmp_path, part):
    """The probe (``scripts/raster_probe.py``), 100 files a part."""
    counts = probe(tmp_path / "f.png", BASES["FLI"](), 700 + part, 100)
    assert counts.get("FLI", [0, 0])[0] > 0 and sum(c[1] for c in counts.values()) > 0


def test_palette_count_of_zero_is_256(tmp_path):
    """A COLOR_256 packet of count 0 sets 256 entries."""
    chunk = cs.fli_chunk(4, struct.pack("<HBB", 1, 0, 0) + PAL.tobytes())
    reads(tmp_path, frame_of([chunk, cs.fli_brun(G)]))
    assert np.unique(np.asarray(PAL)).size > 1
