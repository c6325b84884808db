"""IM (A.6.43), XBM (A.6.44), XPM (A.6.45) and XV thumbnail (A.6.46) in the
port's host decoder (``decode.cpp``: ``im_open`` and ``decode_im``,
``xbm_open`` and ``decode_xbm``, ``decode_xpm``, ``decode_xvthumb``), each
bit-equal with PIL's ``Image.open(path).convert("L")`` (Pillow 12.1.0):
Pillow's own files where it writes the format (IM, XBM), hand-built ones
(``chip_smoke.py``'s writers, ``tests/torch_port_text_cases.py``) of what
its plugins read and no writer makes, as Pillow's plugins and decoders
read them, their end-of-data rules included: read where PIL reads,
corrupt (``ValueError``) where PIL refuses."""

import struct

import numpy as np
import pytest
from PIL import Image, ImImagePlugin
from test_torch_port_decode import assert_port_reads_as_pil
from torch_port_raster_cases import holds, image, pil_verdict, pillow, probe
from torch_port_text_cases import BASES, IM_SAVES, LUTS, im_pillow, im_sizes

import chip_smoke as cs
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


# -- A.6.43 IM -----------------------------------------------------------------

@pytest.mark.parametrize("mode", IM_SAVES)
def test_pillow_im_reads_as_pil(tmp_path, mode):
    """Pillow's IM writer in each mode it saves (rows bottom-up; I and F
    clipped to 0 .. 255 by convert("L"), P through its palette, LA and PA
    their first band), under an .im and a .png name."""
    reads(tmp_path, im_pillow(5, 7, mode), "IM", ("f.im", "f.png"))


@pytest.mark.parametrize("name", sorted(ImImagePlugin.OPEN))
def test_im_open_name_reads_as_pil(tmp_path, name):
    """Every "Image type" of ImImagePlugin's OPEN, its pixels exactly long
    enough (line-interleaved RGB;L and its kin, planar RGB;T with G first,
    P;2 and P;4 without a palette: black, 16- and 32-bit integers, F;8 ..
    F;32F, the bit decoder for L*N): read as PIL reads them, but RLB, RYB
    (no RLB unpacker) and PA (mode LA of PA;L), which PIL refuses; a byte
    short is refused."""
    w, h = 7, 3
    data = np.random.RandomState(len(name)).randint(0, 256, im_sizes(name, w, h)).astype(np.uint8).tobytes()
    f = cs.im_file(name, data, w, h)
    fmt, want = holds(tmp_path / "f.im", f)
    assert fmt == "IM" and (want is None) == (name in ("PA image", "RLB image", "RYB image"))
    assert holds(tmp_path / "f.im", f[:-1]) == ("IM", None)


@pytest.mark.parametrize("bits", [b for b in range(2, 32) if b not in (8, 16)])
def test_im_bit_decoder_reads_as_pil(tmp_path, bits):
    """L*N images of N bits (BitDecode.c: little-endian bit packing, each
    row from a fresh byte with the bits left ORed under it, the buffer past
    32 bits refilled from the last byte) at widths whose rows end inside a
    byte; a sample of 255 or more is white."""
    for w in (3, 5, 9):
        h = 4
        rs = np.random.RandomState(bits * 10 + w)
        data = rs.randint(0, 256, im_sizes(f"L*{bits} image", w, h)).astype(np.uint8)
        data[::3] = 0   # small samples, below 255, among the large
        fmt, want = holds(tmp_path / "f.im", cs.im_file(f"L*{bits} image", data.tobytes(), w, h))
        assert fmt == "IM" and want is not None


@pytest.mark.parametrize("lut", sorted(LUTS))
@pytest.mark.parametrize("name", ["Greyscale image", "LA image", "B4 image", "RGB image", "L 16 image"])
def test_im_lut_reads_as_pil(tmp_path, lut, name):
    """A Lut's 768 bytes after ^Z: a grey one (linear or not) changes
    nothing (PIL keeps a non-linear one as ``lut`` and never applies it); a
    colour one makes L and P mode P and LA mode PA, read through it; RGB and
    I;16 skip it. (B4's raw mode P;4 becomes P: 8-bit indices.)"""
    w, h = 6, 4
    rs = np.random.RandomState(len(name))
    data = rs.randint(0, 256, 4 * w * h).astype(np.uint8).tobytes()  # enough for P's 8 bits too
    f = cs.im_file(name, data, w, h, lut=LUTS[lut])
    fmt, want = holds(tmp_path / "f.im", f)
    assert fmt == "IM" and want is not None
    with Image.open(tmp_path / "f.im") as im:
        colour = lut == "colour" and name in ("Greyscale image", "LA image", "B4 image")
        assert im.mode == ({"Greyscale image": "P", "LA image": "PA", "B4 image": "P"}[name] if colour
                           else ImImagePlugin.OPEN[name][0])


@pytest.mark.parametrize("mode", ["I", "RGBX", "P", "RGB", "L", "F", "RGBA", "1", "YCbCr", "LAB", "I;16"])
@pytest.mark.parametrize("name", ["L 16 image", "RGB image", "Greyscale image", "RGBA image", "L 32 S image"])
def test_im_mode_apart_from_raw_mode_as_pil(tmp_path, mode, name):
    """An "Image type" of a plain mode after an OPEN name: PIL takes the
    mode and keeps the raw mode of the name before ("L" at first), and
    reads the pair where it has that unpacker (RGBX from RGB;L, P from L,
    I from I;16 and I;32), refusing the rest."""
    w, h = 5, 3
    data = np.random.RandomState(7).randint(0, 256, 4 * w * h).astype(np.uint8).tobytes()
    assert holds(tmp_path / "f.im", cs.im_file(name, data, w, h, lines=[f"Image type: {mode}"]))[0] == "IM"


HEADERS = {
    # name: (header bytes before ^Z, pixels) -> PIL's verdict is the test's
    "default_size": (b"Name: x\r\n", bytes(range(256)) * 1024),
    "nul_then_skip": (b"Image type: Greyscale image\nImage size (x*y): 4*2\n\0junk", bytes(range(8))),
    "cr_lines": (b"\rImage type: Greyscale image\n\r\rImage size (x*y): 4*2\n", bytes(range(8))),
    "comma_size": (b"Image size (x*y): 4,2\r\n", bytes(range(8))),
    "spaced_size": (b"Image size (x*y): \x0b4 *\xa02\r\n", bytes(range(8))),
    "group_separator_size": (b"Image size (x*y): 4*2\x1d\r\n", bytes(range(8))),
    "underscore_size": (b"Image size (x*y): 1_0*2\r\n", bytes(range(20))),
    "float_size": (b"Image size (x*y): 4.0*2\r\n", bytes(range(8))),
    "three_sizes": (b"Image size (x*y): 4*2*1\r\n", bytes(range(8))),
    "one_size": (b"Image size (x*y): 8\r\n", bytes(range(64))),
    "zero_size": (b"Image size (x*y): 0*2\r\n", bytes(range(8))),
    "bad_number": (b"Image size (x*y): 4*x\r\n", bytes(range(8))),
    "bad_frames": (b"Image size (x*y): 4*2\r\nFile size (no of images): two\r\n", bytes(range(8))),
    "float_scale": (b"Image size (x*y): 4*2\r\nScale (x,y): 1.5,inf\r\n", bytes(range(8))),
    "no_tag": (b"Width: 4\r\n", bytes(range(8))),
    "no_colon": (b"Image size (x*y): 4*2\r\nComment\r\n", bytes(range(8))),
    "long_line": (b"Image size (x*y): 4*2\r\nComment: " + b"a" * 95 + b"\r\n", bytes(range(8))),
    "digit_key": (b"Image size (x*y): 4*2\r\n9: x\r\n", bytes(range(8))),
    "trailing_space_type": (b"Image type: Greyscale image \r\nImage size (x*y): 4*2\r\n", bytes(range(8))),
    "empty_type": (b"Image type:\r\nImage size (x*y): 4*2\r\n", bytes(range(8))),
    "tab_value": (b"Image type:\tGreyscale image\r\nImage size (x*y): 4*2\r\n", bytes(range(8))),
    "two_frames": (b"Image size (x*y): 4*2\r\nFile size (no of images): 2\r\n", bytes(range(16))),
    "no_ctrl_z": (b"Image size (x*y): 4*2\r\n", None),
}


@pytest.mark.parametrize("case", sorted(HEADERS))
def test_im_header_rules_as_pil(tmp_path, case):
    """ImImagePlugin's header rules: 512 x 512 by default, NUL ending the
    header (the pixels after the next ^Z), a CR opening a line skipped,
    sizes of "*" or "," and Python's int() (whitespace, underscores), a
    float size or one of three values refused, one value or a zero passing
    the file on, bad numbers refused, a header without a tag, with a line
    that is no "Key: value" or over 100 bytes passing it on, a mode with a
    trailing space or none, the first of several frames."""
    head, px = HEADERS[case]
    data = head + (b"" if px is None else b"\x1a" + px)
    fmt, want = holds(tmp_path / "f.im", data)
    if case in ("default_size", "nul_then_skip", "cr_lines", "comma_size", "spaced_size",
                "underscore_size", "tab_value", "two_frames"):
        assert fmt == "IM" and want is not None


# -- A.6.44 XBM ----------------------------------------------------------------

@pytest.mark.parametrize("hotspot", [None, (1, 2)])
@pytest.mark.parametrize("size", [(5, 7), (4, 16), (3, 1), (9, 33)])
def test_pillow_xbm_reads_as_pil(tmp_path, hotspot, size):
    """Pillow's XBM writer, with and without a hot spot: a set bit is white
    (PIL's mode 1 from raw 1;R), least significant bit first."""
    a = np.where(image(*size) > 120, 255, 0).astype(np.uint8)
    data = pillow(a, "XBM", "1", hotspot=hotspot)
    reads(tmp_path, data, "XBM", ("f.xbm", "f.png"))
    np.testing.assert_array_equal(tdataset.decode_gray(tmp_path / "f.png"), a)


XBM_TOKENS = {
    "upper_hex": b"0X5A, 0XFF",
    "upper_x_among": b"0X5A, 0x12, 0xFf",
    "short_token": b"0x5, 0xf",
    "no_commas": b"0x12 0x34",
    "other_separators": b"0x12;0x34|0x56",
    "non_hex": b"0xg1, 0xzz",
    "too_few": b"0x12",
    "x_cut": b"0x12, 0x",
    "file_ends_in_token": b"0x12, 0x3",
    "x_in_text": b"x12 /* x */ 0x34",
}


@pytest.mark.parametrize("case", sorted(XBM_TOKENS))
def test_xbm_data_tokens_as_pil(tmp_path, case):
    """XbmDecode.c's reading of the data: the two characters after each
    lower-case 'x', whatever they are (a non-hex character 0, a token cut
    short taking the separator), whatever separates them ("0X" is no
    token); an 'x' without two characters after it, or too few tokens, is
    refused."""
    data = b"#define t_width 9\n#define t_height 1\nstatic char t_bits[] = {\n" + XBM_TOKENS[case]
    data += b"" if case == "file_ends_in_token" else b"};\n"
    fmt, want = holds(tmp_path / "f.xbm", data)
    assert fmt == "XBM"
    assert (want is None) == (case in ("too_few", "upper_hex", "file_ends_in_token"))


XBM_HEADERS = {
    "crlf": b"#define a_width 8\r\n#define a_height 2\r\nstatic char a_bits[] = {0x01, 0x80};",
    "two_width_on_a_line": b"#define a_width 3 b_width 8\n#define a_height 2\nchar a_bits[] = {0x01,0x80};",
    "cr_in_line": b"#define a_width 4\rjunk_width 8\n#define a_height 2\nchar a_bits[] = {0x01,0x80};",
    "leading_space": b" \t\n#define a_width 8\n#define a_height 2\nchar a_bits[] = {0x01,0x80};",
    "too_much_space": b"          #define a_width 8\n#define a_height 2\nchar a_bits[] = {0x01,0x80};",
    "hotspot": b"#define a_width 8\n#define a_height 2\n#define a_x_hot 1\n#define a_y_hot 1\n"
               b"char a_bits[] = {0x01,0x80};",
    "two_bits_names": b"#define a_width 8\n#define a_height 1\nchar a_bits[] = {0x01};\n/* b_bits[] */ 0x02",
    "zero_width": b"#define a_width 0\n#define a_height 2\nchar a_bits[] = {0x01,0x80};",
    "no_bits": b"#define a_width 8\n#define a_height 2\nchar a[] = {0x01,0x80};",
    "width_no_space": b"#define a_width8\n#define a_height 2\nchar a_bits[] = {0x01,0x80};",
}


@pytest.mark.parametrize("case", sorted(XBM_HEADERS))
def test_xbm_header_as_pil(tmp_path, case):
    """The xbm_head regex: CR LF lines, the greedy ".*" taking the last
    "_width N" of its line (a CR inside the line too), whitespace before
    "#define" within _accept's 16 bytes, a hot spot, the data after the
    last "_bits[]" of the first 512 bytes; a zero size, no "_bits[]" or no
    space before the number is not an XBM file."""
    fmt, want = holds(tmp_path / "f.xbm", XBM_HEADERS[case])
    if case in ("crlf", "two_width_on_a_line", "cr_in_line", "leading_space", "hotspot", "two_bits_names"):
        assert fmt == "XBM" and want is not None


# -- A.6.45 XPM ----------------------------------------------------------------

def xpm(head: str, palette, rows, extra=()) -> bytes:
    return ("/* XPM */\nstatic char *x[] = {\n" + head + "\n" + "".join(p + "\n" for p in palette)
            + "".join(extra) + "".join(f'"{r}",\n' for r in rows) + "};\n").encode("latin-1")


XPMS = {
    "p": xpm('"3 2 2 1",', ['"a c #FF0000",', '"b c #00ff80",'], ["aba", "bab"]),
    "two_chars": xpm('"2 2 2 2",', ['"aa c #123456",', '"ab c #654321",'], ["aaab", "abab"]),
    "none_colour": xpm('"2 1 2 1",', ['"a c None",', '"b c #FFFFFF",'], ["bb"]),
    "none_pixel": xpm('"2 1 2 1",', ['"a c None",', '"b c #FFFFFF",'], ["ab"]),
    "duplicate_key": xpm('"2 1 3 1",', ['"a c #FF0000",', '"b c #00FF00",', '"a c #0000FF",'], ["ab"]),
    "unknown_key": xpm('"2 1 2 1",', ['"a c #FF0000",', '"b c #00FF00",'], ["az"]),
    "other_colour": xpm('"1 1 1 1",', ['"a c red",'], ["a"]),
    "no_c_key": xpm('"1 1 1 1",', ['"a m #000000",'], ["a"]),
    "c_second": xpm('"1 1 1 1",', ['"a m #000000 c #808080",'], ["a"]),
    "c_without_colour": xpm('"1 1 1 1",', ['"a c",'], ["a"]),
    "hex_forms": xpm('"4 1 4 1",', ['"a c #0x10_20_30",', '"b c #-1",', '"c c #fff",', '"d c #1234567890",'],
                     ["abcd"]),
    "bad_hex": xpm('"1 1 1 1",', ['"a c #12g4",'], ["a"]),
    "zero_chars": xpm('"1 1 1 0",', ['"a c #000000",'], ["a"]),
    "short_data": xpm('"3 2 1 1",', ['"a c #000000",'], ["aaa"]),
    "overshoot": xpm('"2 2 1 1",', ['"a c #808080",'], ["aaa", "aaaaa"]),
    "quote_key": xpm('"3 1 2 1",', ['"a c #808080",', '"" c #FFFFFF",'], ['a"a']),
    "quote_in_colour_line": xpm('"1 1 2 1",', ['"a c #808080",', '"\\" c #FFFFFF",'], ['a']),
    "no_quotes_line": xpm('"2 2 1 1",', ['"a c #404040",'], ["aa", "aa"], extra=("junk line\n",)),
    "pixels_twice": xpm('"2 2 1 1",', ['"a c #404040",'], ["aa", "aa"], extra=("/* pixels */\n", "/* pixels */\n")),
    "empty_number": xpm('"2  1 1",', ['"a c #404040",'], ["aa"]),
    "rgb": xpm('"2 1 300 2",', [f'"{k:02d} c #{k:06X}",' for k in range(100)] * 3, ["0199"]),
    "rgb_unknown": xpm('"2 1 300 2",', [f'"{k:02d} c #{k:06X}",' for k in range(100)] * 3, ["01zz"]),
}


@pytest.mark.parametrize("case", sorted(XPMS))
def test_xpm_as_pil(tmp_path, case):
    """XpmImagePlugin's palette (the first "c" pair's "#hex" through
    int(, 16), "None" left out, a key given twice at its first place with
    its last colour, another colour or no "c" refused) and XpmDecoder's
    pixels (between a line's first and last quote, one "/* pixels */"
    skipped, too few refused, more cut, a key not in the palette refused),
    in mode P and, past 256 palette lines, RGB."""
    fmt, want = holds(tmp_path / "f.xpm", XPMS[case])
    reads = ("p", "two_chars", "none_colour", "duplicate_key", "c_second", "hex_forms", "overshoot",
             "quote_key", "no_quotes_line", "rgb")
    if case in reads:
        assert fmt == "XPM" and want is not None
    elif case not in ("none_pixel", "pixels_twice"):
        assert want is None


@pytest.mark.parametrize("chars", [1, 2])
@pytest.mark.parametrize("colours", [2, 256, 257])
def test_hand_built_xpm_reads_as_pil(tmp_path, chars, colours):
    """``chip_smoke.xpm_file``: P of 2 and 256 colours, RGB of 257."""
    g = image(7, 13)
    idx = (g.astype(np.int64) * colours // 256)
    cols = [(k * 37 % 256, k * 11 % 256, 255 - k % 256) for k in range(colours)]
    reads(tmp_path, cs.xpm_file(idx, cols, chars=max(chars, 2 if colours > 90 else 1)), "XPM",
          ("f.xpm", "f.png"))


# -- A.6.46 XV thumbnail ---------------------------------------------------------

@pytest.mark.parametrize("comments", [(), ("#XVVERSION:Version 2.28", "#END_OF_COMMENTS")])
@pytest.mark.parametrize("size", [(5, 9), (1, 1), (16, 16)])
def test_xv_thumbnail_reads_as_pil(tmp_path, comments, size):
    """XV thumbnails of every 3-3-2 index: (r * 255) // 7, (g * 255) // 7,
    (b * 255) // 3, then convert("L") through that palette."""
    idx = (np.arange(size[0] * size[1]) * 7 % 256).astype(np.uint8).reshape(size)
    reads(tmp_path, cs.xv_thumb(idx, comments), "XVThumb", ("f.xv", "f.png"))


XV_HEADERS = {
    "extra_fields": b"P7 332 junk\n#c\n3 2 255 more\n" + bytes(6),
    "signs": b"P7 332\n+3 0_2\n" + bytes(6),
    "one_field": b"P7 332\n3\n" + bytes(6),
    "not_numbers": b"P7 332\n3 x\n" + bytes(6),
    "zero": b"P7 332\n0 2\n" + bytes(6),
    "short": b"P7 332\n3 2\n" + bytes(5),
    "no_size_line": b"P7 332\n#only a comment\n",
    "empty_line": b"P7 332\n\n3 2\n" + bytes(6),
    "tabs": b"P7 332\n\t3\t2\r\n" + bytes(6),
}


@pytest.mark.parametrize("case", sorted(XV_HEADERS))
def test_xv_thumbnail_header_as_pil(tmp_path, case):
    """The size line's first two fields (Python's split and int(): signs,
    underscores), comment lines, the pixels whole: read or refused as PIL."""
    fmt, want = holds(tmp_path / "f.xv", XV_HEADERS[case])
    if case in ("extra_fields", "signs", "tabs"):
        assert want is not None


# -- every kind, damaged ----------------------------------------------------------

@pytest.mark.parametrize("fmt", ["IM", "XBM", "XPM", "XVThumb"])
@pytest.mark.parametrize("part", range(2))
def test_damaged_files_read_as_pil(tmp_path, fmt, part):
    """The probe (``scripts/raster_probe.py``), 150 files a part: the
    bases damaged six ways, each read bit-equal where PIL reads, corrupt
    where it refuses."""
    counts = probe(tmp_path / "f.png", BASES[fmt](), 100 + part, 150)
    assert counts.get(fmt, [0, 0])[0] > 0 and sum(c[1] for c in counts.values()) > 0
