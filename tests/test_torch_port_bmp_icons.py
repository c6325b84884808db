"""DIB (A.6.33), ICO (A.6.37) and CUR (A.6.38) through the port's one DIB
reader (``decode.cpp::dib_header`` / ``dib_pixels``), BMP's faults C.23 and
C.24 found by the probe of that reader, and damaged PNG data (C.25), found
through ICO's PNG icons: each file bit-equal with PIL's
``Image.open(path).convert("L")`` (Pillow 12.1.0), or corrupt where PIL
refuses it. An ICO's PNG icon is handed back to ``infer/export.py::
decode_png`` as its offset, on each route: ``decode_gray``,
``decode_images``' threads and ``cli.preprocess``."""

import json
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil
from torch_port_raster_cases import (BASES, holds, image, pil_verdict, pillow, probe)

import chip_smoke as cs
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative
from siggan_tpu_torch.infer.export import _chunk, encode_png

RAMP = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
RAMP[:, 3] = 0


def bmp(dib: bytes, offset: int = None) -> bytes:
    """A BMP file of a DIB: the 14-byte file header, the pixel offset after
    the header and the palette unless given."""
    return b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, 0 if offset is None else offset) + dib


# -- A.6.33 DIB ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("h,w", [(5, 7), (8, 33), (3, 1)])
def test_pillow_dib_reads_as_pil(tmp_path, mode, h, w):
    """Pillow's DIB writer in each mode it takes, as ``.dib`` and ``.png``."""
    data = pillow(image(h, w, 4 if mode == "RGBA" else 3 if mode in ("RGB", "P") else 0), "DIB", mode)
    for name in ("f.dib", "f.png"):
        (tmp_path / name).write_bytes(data)
        assert pil_verdict(tmp_path / name)[0] == "DIB"
        assert_port_reads_as_pil(tmp_path / name)


@pytest.mark.parametrize("case", range(5))
def test_hand_built_dib_reads_as_pil(tmp_path, case):
    """A 4-bit palette, an OS/2 (12-byte) header with BGR entries, 16-bit
    5-5-5 bitfields (masks after a 40-byte header), 24-bit, RLE8: the data
    starts where the header, its masks and its palette end."""
    data = BASES["DIB"]()[15 + case]
    (tmp_path / "f.dib").write_bytes(data)
    assert pil_verdict(tmp_path / "f.dib")[0] == "DIB"
    assert_port_reads_as_pil(tmp_path / "f.dib")


def test_dib_whose_bitfield_masks_are_cut_is_nothing_pil_opens(tmp_path):
    """A 40-byte header of BI_BITFIELDS whose three masks the file cuts:
    PIL's read of a mask fails as Image.open takes for "not this format",
    and no other plugin takes the file: corrupt."""
    data = cs.dib_bytes(b"", 4, 2, 32, compression=3)[:48]
    assert holds(tmp_path / "f.dib", data) == (None, None)


# -- C.23, C.24: BMP as PIL reads it ---------------------------------------

def test_bmp_pixel_offset_of_zero_reads_after_the_palette_c23(tmp_path):
    """C.23: a BMP whose file header gives a pixel offset of 0: PIL reads
    the pixels from where its header and palette reads stopped; the port
    read the file from its first byte."""
    g = image(3, 4)
    for data in (pillow(g, "BMP", "L"), pillow(image(3, 4, 3), "BMP", "RGB"), pillow(g, "BMP", "1")):
        d = bytearray(data)
        struct.pack_into("<I", d, 10, 0)
        (tmp_path / "f.bmp").write_bytes(bytes(d))
        assert_port_reads_as_pil(tmp_path / "f.bmp")


@pytest.mark.parametrize("bits,colors,w", [(8, 2, 5), (4, 2, 9), (4, 16, 1), (4, 16, 9), (1, 256, 3),
                                          (1, 256, 40), (8, 512, 6), (4, 2, 40)])
def test_bmp_grey_palettes_unpacked_at_their_modes_depth_c24(tmp_path, bits, colors, w):
    """C.24: a palette PIL takes for grey (v, v, v for v = 0, 1, ..., mod
    256) makes mode L, whose rows PIL unpacks a byte a pixel whatever the
    bit depth; (0, 255) makes mode 1, a bit a pixel. A row shorter than
    that is refused by PIL's decoder, unless PIL maps the file (an L tile
    whose rows fit), where rows overlap and bytes past the file's end are
    0. The port read each as a palette image."""
    rs = np.random.RandomState(bits * 1000 + colors + w)
    pal = RAMP[np.arange(colors) % 256] if colors != 2 else RAMP[[0, 255]]
    h = 4
    stride = ((w * bits + 31) >> 3) & ~3
    rows = rs.randint(0, 256, h * stride).astype(np.uint8).tobytes()
    data = bmp(cs.dib_bytes(rows, w, h, bits, pal.tobytes()), 14 + 40 + colors * 4)
    holds(tmp_path / "f.bmp", data)


def test_bmp_palette_of_more_than_256_colours_is_refused_c24(tmp_path):
    """C.24: 300 palette entries in the file: PIL's palette holds at most
    256, so it refuses the pixels; fewer in the file than the header says
    is fine."""
    g = image(4, 6)
    pal = np.tile(RAMP[::-1], (2, 1))[:300].copy()
    pal[0] = (9, 9, 9, 0)
    data = bmp(cs.dib_bytes(cs.dib_rows(g, 8), 6, 4, 8, pal.tobytes()), 14 + 40 + 300 * 4)
    assert holds(tmp_path / "f.bmp", data) == ("BMP", None)
    cut = bmp(cs.dib_bytes(b"", 6, 4, 8, pal[:200].tobytes(), colors=300), 0)
    holds(tmp_path / "g.bmp", cut + cs.dib_rows(g, 8))


def test_bmp_rows_whose_last_padding_is_missing_read_c24(tmp_path):
    """C.24: PIL's raw decoder needs no padding after the last row, so a
    24-bit file cut there reads; an 8-bit one too (the map PIL tries first
    needs every row's padding; its decoder does not); a cut into the last
    row's pixels is refused."""
    for data in (pillow(image(3, 5, 3), "BMP", "RGB"), pillow(image(3, 5, 3), "BMP", "P")):
        for cut, read in ((1, True), (4, False)):
            fmt, want = holds(tmp_path / "f.bmp", data[:-cut])
            assert fmt == "BMP" and (want is not None) == read


def test_bmp_rle_of_black_and_white_is_refused_c24(tmp_path):
    """C.24: RLE8 with the palette (0, 255): PIL's mode 1 has no raw mode
    P for the RLE decoder's rows, so it refuses the file."""
    data = bmp(cs.dib_bytes(b"\x04\x01\x00\x00\x04\x00\x00\x01", 4, 2, 8, RAMP[[0, 255]].tobytes(),
                            compression=1), 14 + 40 + 8)
    assert holds(tmp_path / "f.bmp", data) == ("BMP", None)


# -- A.6.37 ICO ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("bitmap", [False, True])
def test_pillow_ico_reads_as_pil(tmp_path, mode, bitmap):
    """Pillow's ICO writer, of PNG icons and of bitmaps (1 bit for mode 1,
    8 for L and P, 24 for RGB, 32 for RGBA), two sizes: the largest read."""
    a = image(20, 20, 4 if mode == "RGBA" else 3 if mode in ("RGB", "P") else 0)
    kw = {"bitmap_format": "bmp"} if bitmap else {}
    data = pillow(a, "ICO", mode, sizes=[(16, 16), (8, 8)], **kw)
    for name in ("f.ico", "f.png"):
        (tmp_path / name).write_bytes(data)
        assert pil_verdict(tmp_path / name)[0] == "ICO"
        assert_port_reads_as_pil(tmp_path / name)


@pytest.mark.parametrize("bits", [1, 4, 8, 24])
def test_bitmap_icons_at_each_depth_read_as_pil(tmp_path, bits):
    """A hand-built icon of a bitmap at 1, 4, 8 and 24 bits and its AND
    mask, the image the first half of the DIB's rows."""
    data = cs.ico_file([(9, 6, 0, 1, bits, cs.icon_dib(image(6, 9), bits))])
    (tmp_path / "f.ico").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "f.ico")


def test_ico_entry_is_pils_choice(tmp_path):
    """PIL sorts the directory by colour depth (bits, else the colour
    count's log2, else 256), then by area, largest first, both stable, and
    loads the first: the later of two equal areas at a lower depth, the
    larger area whatever its depth, an entry of width byte 0 as 256."""
    g = [image(6, 9, seed=s) for s in range(4)]
    cases = [[(9, 6, 0, 1, 8, cs.icon_dib(g[0], 8)), (9, 6, 0, 1, 4, cs.icon_dib(g[1], 4))],
             [(9, 6, 16, 1, 0, cs.icon_dib(g[2], 4)), (9, 6, 2, 1, 0, cs.icon_dib(g[3], 1))],
             [(4, 4, 0, 1, 1, cs.icon_dib(g[0][:4, :4], 1)), (9, 6, 0, 1, 24, cs.icon_dib(g[1], 24))],
             [(9, 6, 1, 1, 0, cs.icon_dib(g[2], 8)), (9, 6, 0, 1, 32, encode_png(g[3]))]]
    for i, icons in enumerate(cases):
        (tmp_path / f"{i}.ico").write_bytes(cs.ico_file(icons))
        assert_port_reads_as_pil(tmp_path / f"{i}.ico")


def test_png_icon_of_another_size_takes_the_pngs(tmp_path):
    """A PNG icon whose directory entry says 16 x 16 and whose PNG is 12 x
    15 (PIL warns and takes the PNG's size), after a bitmap entry."""
    data = cs.ico_file([(16, 16, 0, 1, 32, encode_png(image(12, 15))),
                        (4, 4, 0, 1, 8, cs.icon_dib(image(4, 4), 8))])
    (tmp_path / "f.ico").write_bytes(data)
    assert pil_verdict(tmp_path / "f.ico")[1].shape == (12, 15)
    assert_port_reads_as_pil(tmp_path / "f.ico")
    assert tnative.decode_or_png(data)[:2] == (None, 6 + 32)


def test_png_icon_goes_to_decode_png_on_every_route(tmp_path, monkeypatch):
    """The ICO's PNG icon is decoded by ``decode_png`` (no PNG decoder in
    decode.cpp) through ``decode_gray``, ``decode_images``' thread pool and
    ``cli.preprocess``, under .png and .bmp names, beside a PNG and a BMP."""
    from siggan_tpu.data.native import loader as jnative
    from siggan_tpu_torch.cli import preprocess as tcli
    from siggan_tpu_torch.data import dataset as dmod
    monkeypatch.setattr(jnative, "available", lambda: False)
    raw = tmp_path / "raw" / "w0"
    raw.mkdir(parents=True)
    scan = image(90, 140)
    (raw / "w0_a.png").write_bytes(encode_png(scan))
    (raw / "w0_b.png").write_bytes(pillow(image(140, 140), "ICO", sizes=[(128, 128)]))
    (raw / "w0_c.bmp").write_bytes(pillow(image(70, 70), "ICO", sizes=[(64, 64)]))
    (raw / "w0_d.bmp").write_bytes(pillow(scan, "BMP"))
    calls = []
    decode_png = dmod.decode_png
    monkeypatch.setattr(dmod, "decode_png", lambda d: calls.append(d[:8]) or decode_png(d))
    for p in sorted(raw.iterdir()):
        assert_port_reads_as_pil(p)
    assert calls and set(calls) == {b"\x89PNG\r\n\x1a\n"}
    calls.clear()
    for threads in (1, 4):
        np.testing.assert_array_equal(dmod.decode_images(sorted(raw.iterdir()), 32, n_threads=threads),
                                      jdataset.SignatureDataset(raw, 32, use_cache=False).images)
    assert len(calls) == 6
    tcli.main(["--input_dir", str(tmp_path / "raw"), "--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    report = json.loads((tmp_path / "t" / "preprocess_report.json").read_text())
    assert len(report["processed"]) + len(report["invalid"]) == 4


def test_ico_failures_are_pils(tmp_path):
    """An entry's offset past the file: PIL passes the file on and nothing
    else opens it; a bitmap header cut short, a bitmap of height 1 (an
    empty XOR half), a cut AND mask, a 32-bit directory depth over too few
    bytes: PIL's Image.open raises (it decodes the icon); the mask's last
    row's padding missing: PIL reads it."""
    g = image(6, 9)
    dib = cs.icon_dib(g, 8)
    files = [cs.ico_file([(9, 6, 0, 1, 8, dib)])[:30],
             cs.ico_file([(9, 6, 0, 1, 8, dib)])[:6 + 16 + 20],
             cs.ico_file([(9, 6, 0, 1, 8, cs.dib_bytes(cs.dib_rows(g[:1], 8) + bytes(4), 9, 1, 8,
                                                       RAMP.tobytes()))]),
             cs.ico_file([(9, 6, 0, 1, 8, dib)])[:-10],
             cs.ico_file([(9, 6, 0, 1, 32, dib)]),
             cs.ico_file([(9, 6, 0, 1, 8, dib)])[:-2]]
    for i, data in enumerate(files):     # PIL decodes an icon inside Image.open, which raises
        fmt, got = holds(tmp_path / f"{i}.ico", data)
        assert (fmt, got is not None) == (("ICO", True) if i == 5 else (None, False)), i


# -- A.6.38 CUR ----------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 4, 8, 24])
def test_cursor_reads_as_pil(tmp_path, bits):
    """A hand-built cursor (Pillow writes none) at 1, 4, 8 and 24 bits: the
    DIB's first half of rows, bottom-up, as ``.cur`` and ``.png``."""
    data = cs.ico_file([(9, 6, 0, 1, 0, cs.icon_dib(image(6, 9), bits))], b"\0\0\2\0")
    for name in ("f.cur", "f.png"):
        (tmp_path / name).write_bytes(data)
        assert pil_verdict(tmp_path / name)[0] == "CUR"
        assert_port_reads_as_pil(tmp_path / name)


def test_cursor_choice_and_offset_zero(tmp_path):
    """PIL keeps the first cursor unless a later one's width and height
    bytes are both larger (a byte of 0 counts as 0); an entry offset of 0
    reads the DIB where the directory ends."""
    g = [image(8, 8, seed=s) for s in range(3)]
    cases = [[(4, 4, 0, 1, 0, cs.icon_dib(g[0][:4, :4], 8)), (8, 8, 0, 1, 0, cs.icon_dib(g[1], 8))],
             [(8, 8, 0, 1, 0, cs.icon_dib(g[0], 8)), (0, 0, 0, 1, 0, cs.icon_dib(g[1], 8)),
              (8, 9, 0, 1, 0, cs.icon_dib(g[2], 4))],
             [(8, 4, 0, 1, 0, cs.icon_dib(g[0], 8)), (9, 4, 0, 1, 0, cs.icon_dib(g[1], 8))]]
    for i, icons in enumerate(cases):
        assert holds(tmp_path / f"{i}.cur", cs.ico_file(icons, b"\0\0\2\0"))[1] is not None
    one = bytearray(cs.ico_file(cases[0][:1], b"\0\0\2\0"))
    struct.pack_into("<I", one, 18, 0)
    assert holds(tmp_path / "zero.cur", bytes(one))[0] == "CUR"


def test_cursor_of_one_row_is_passed_on(tmp_path):
    """A cursor whose DIB is 1 row high has a size of 0 rows: PIL's
    Image.open passes it on; with a hotspot and a size that TgaImagePlugin
    takes, PIL reads it as a TGA, and so does the port."""
    g = image(1, 4)
    dib = cs.dib_bytes(cs.dib_rows(g, 8) + bytes(4), 4, 1, 8, RAMP.tobytes())
    data = cs.ico_file([(4, 1, 0, 1, 0, dib)], b"\0\0\2\0")
    assert holds(tmp_path / "f.cur", data) == (None, None)
    tga = bytearray(data + bytes(24 << 16))
    struct.pack_into("<HHI", tga, 10, 0, 3, len(tga) - 22)       # hotspot y 3: TGA's width
    fmt, want = holds(tmp_path / "g.cur", bytes(tga))
    assert fmt == "TGA"


# -- C.25: damaged PNG data ------------------------------------------------

def test_damaged_png_reads_as_pil_c25(tmp_path):
    """C.25 (found through ICO's PNG icons): PIL checks no IDAT CRC, needs
    no chunk after the image data but those its load_end walks, and stops
    inflating when the image is full; the port's ``decode_png`` refused
    all of these."""
    b = pillow(image(12, 17, 3), "PNG")
    at = b.index(b"IDAT")
    n = struct.unpack(">I", b[at - 4:at])[0]
    end = at + 4 + n
    files = {"bad IDAT CRC": b[:end] + b"\0\0\0\0" + b[end + 4:], "cut after the image": b[:end + 2],
             "no IEND": b[:end + 4], "IEND renamed": b[:end + 8] + b"IENa" + b[end + 12:],
             "trailing bytes in the stream": b[:at + 4] + b[at + 4:end] + b[end:]}
    for name, data in files.items():
        fmt, want = holds(tmp_path / "f.png", data)
        assert fmt == "PNG" and want is not None, name
    raw = image(20, 30)
    import zlib
    short = zlib.compress(b"".join(b"\0" + r.tobytes() for r in raw[:7]))
    head = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", 30, 20, 8, 0, 0, 0, 0))
    fmt, want = holds(tmp_path / "g.png", head + _chunk(b"IDAT", short) + _chunk(b"IEND", b""))
    assert (want[:7] == raw[:7]).all() and not want[7:].any()


@pytest.mark.parametrize("fmt,seed", [("DIB", 1), ("BMP", 2), ("ICO", 3), ("CUR", 4), ("PNG", 5)])
def test_damaged_files_read_as_pil(tmp_path, fmt, seed):
    """The probe of A.6.33, A.6.37, A.6.38, C.23-C.25, 300 seeded damaged
    files a format (``torch_port_raster_cases.damage``: bits flipped, bytes
    changed, cut, a header byte set, bytes inserted or deleted), each as PIL
    has it. ``scripts/raster_probe.py`` runs it at any size (PERF.md)."""
    counts = probe(tmp_path / "f.png", BASES[fmt](), seed, 300)
    assert sum(v[0] for v in counts.values()) and sum(v[1] for v in counts.values())
