"""TGA (A.6.34), PCX (A.6.35), DCX (A.6.36), SGI (A.6.39), SUN raster
(A.6.40), MSP (A.6.41) and QOI (A.6.42) in the port's host decoder
(``decode.cpp``: ``decode_tga``, ``decode_pcx``, ``decode_sgi``,
``decode_sun``, ``decode_msp``, ``decode_qoi``), each bit-equal with PIL's
``Image.open(path).convert("L")`` (Pillow 12.1.0) on Pillow's files in
every mode its writer takes and on hand-built files of what no writer
makes, as Pillow's run-length decoders end on damaged or short data: read
where PIL reads, corrupt where PIL refuses."""

import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil
from torch_port_raster_cases import (BASES, holds, image, pcx_planes, pil_verdict, pillow, probe,
                                     sun_nibbles, tga_16)

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


# -- A.6.34 TGA ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "P", "RGB", "RGBA", "LA", "1"])
@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("orientation", [1, -1])
def test_pillow_tga_reads_as_pil(tmp_path, mode, rle, orientation):
    """Pillow's TGA writer in each mode it takes, raw and RLE, top-down and
    bottom-up (a 1-bit file only raw: PIL's RLE decoder never fills a row
    of it)."""
    if mode == "1" and rle:
        data = cs.tga_file(np.packbits(image(7, 11) > 128, axis=1)[..., None], 11, 1)
        assert holds(tmp_path / "f.tga", data) == ("TGA", None)
        return
    bands = {"P": 3, "RGB": 3, "RGBA": 4, "LA": 2}.get(mode, 0)
    reads(tmp_path, pillow(image(7, 11, bands), "TGA", mode, rle=rle, orientation=orientation), "TGA",
          ("f.tga", "f.png"))


def test_tga_16_bit_pixels_expand_as_pils_unpacker(tmp_path):
    """Type 2 at 16 bits (BGRA;15Z): every 5-bit value of each channel, in
    a raw and an RLE file, mirrored by flag 0x10; PIL's channel is v * 255
    // 31."""
    v = np.arange(32, dtype=np.uint16)
    px = np.stack([v << 10, v << 5, v, v << 10 | v << 5 | v | 0x8000]).astype("<u2")
    data = px.view(np.uint8).reshape(4, 32, 2)
    with Image.open(__import__("io").BytesIO(cs.tga_file(data, 2, 16))) as im:
        rgba = np.asarray(im)
    assert rgba[0, :, 0].tolist() == (v * 255 // 31).tolist()
    for t, flags in ((2, 0x20), (10, 0x30), (2, 0x10)):
        reads(tmp_path, cs.tga_file(data, t, 16, flags=flags), "TGA")


def test_tga_colour_maps_as_pil(tmp_path):
    """A colour map from index ``start`` > 0 (PIL pads that many black
    entries), of 16-bit and 24-bit entries, raw and RLE, an image id before
    it, right-to-left rows; a map on a grey image gives its indices, on a
    grey + alpha image its colours; PIL refuses a map of 32-bit entries,
    one past 256 entries, and one on an RGB or 1-bit image."""
    g = image(6, 10)
    cmap = (np.arange(60) * 4).astype(np.uint8).tobytes()
    for data in (cs.tga_file(g // 20 + 3, 1, 8, colormap=cmap, start=3, flags=0x30, image_id=b"hello"),
                 cs.tga_file(g // 20 + 3, 9, 8, colormap=cmap, start=3, flags=0x10),
                 cs.tga_file(g // 20, 1, 8, colormap=(np.arange(40) * 6).astype(np.uint8).tobytes(),
                             map_depth=16),
                 cs.tga_file(g // 40, 3, 8, colormap=cmap),
                 cs.tga_file(np.dstack([g // 40, g]), 3, 16, colormap=cmap)):
        reads(tmp_path, data, "TGA")
    for data in (cs.tga_file(g // 20, 1, 8, colormap=bytes(60 * 4), map_depth=32),
                 cs.tga_file(g // 20, 1, 8, colormap=bytes(60 * 3), start=200),
                 cs.tga_file(np.dstack([g, g, g]), 2, 24, colormap=cmap),
                 cs.tga_file(g // 20, 1, 8)):
        assert holds(tmp_path / "f.tga", data) == ("TGA", None)


def test_tga_rle_packets_across_rows(tmp_path):
    """TgaRleDecode.c: a literal packet runs on into the next rows, a run
    packet past a row's end is refused, and data that ends before the last
    row is refused."""
    g = image(5, 7)
    reads(tmp_path, cs.tga_file(g, 11, 8, cross_rows=True), "TGA")
    run_across = cs.tga_file(np.zeros((2, 3), np.uint8), 11, 8)[:18] + bytes([0x83, 9]) + bytes([0x81, 9])
    assert holds(tmp_path / "f.tga", run_across) == ("TGA", None)
    full = cs.tga_file(g, 11, 8)
    assert holds(tmp_path / "f.tga", full[:-1]) == ("TGA", None)


# -- A.6.35 PCX, A.6.36 DCX --------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("h,w", [(5, 7), (6, 16), (3, 1)])
def test_pillow_pcx_reads_as_pil(tmp_path, mode, h, w):
    """Pillow's PCX writer in each mode it takes, odd widths among them
    (rows made even, PIL's stride with a header that says otherwise); PIL
    refuses its own RGB file one pixel wide, and so does the port."""
    data = pillow(image(h, w, 3 if mode in ("P", "RGB") else 0), "PCX", mode)
    if (mode, w) == ("RGB", 1):
        assert holds(tmp_path / "f.pcx", data) == ("PCX", None)
        return
    reads(tmp_path, data, "PCX", ("f.pcx", "f.png"))


@pytest.mark.parametrize("planes", [2, 4])
@pytest.mark.parametrize("w", [13, 16, 3])
def test_pcx_bit_planes_read_as_pil(tmp_path, planes, w):
    """1-bit pixels in 2 or 4 planes with the header's 16 colours (P;2L,
    P;4L), the header's row length even or PIL's own; PIL moves padded
    planes together before it unpacks them."""
    g = image(6, w)
    for stride, version in ((None, 5), ((w + 7) // 8, 2), ((w + 7) // 8 + 1, 5)):
        reads(tmp_path, pcx_planes(g, planes, stride, version), "PCX")


def test_pcx_grey_and_palette_and_refusals(tmp_path):
    """An 8-bit PCX whose trailing palette is the grey ramp is mode L, any
    other palette mode P; a file under 769 bytes (PIL cannot seek to the
    palette) and a run past a row's end are refused."""
    g = image(40, 30)
    reads(tmp_path, cs.pcx_grey(g), "PCX")
    reads(tmp_path, cs.pcx_grey(g, palette=(np.arange(768) * 7 % 256).astype(np.uint8).tobytes()), "PCX")
    small = cs.pcx_grey(image(3, 4))
    assert holds(tmp_path / "f.pcx", small[:-769]) == (None, None)
    head = cs.pcx_grey(image(2, 4))[:128]
    body = bytes([0xC6, 7, 0xC2, 7]) + bytes(700) + b"\x0c" + bytes(768)
    assert holds(tmp_path / "f.pcx", head + body) == ("PCX", None)


def test_dcx_first_page_reads_as_pil(tmp_path):
    """DCX: the first page of the offset list, read as PCX (its 8-bit
    palette at the file's end); an offset list the file cuts before its 0
    is passed on by PIL and read by nothing."""
    p = [pillow(image(5, 9, 3), "PCX", "RGB"), cs.pcx_grey(image(20, 40))]
    for pages in (p, p[::-1], p[:1]):
        reads(tmp_path, cs.dcx_file(pages), "DCX", ("f.dcx", "f.png"))
    cut = struct.pack("<II", 987654321, 12) + bytes([1])
    assert holds(tmp_path / "f.dcx", cut) == (None, None)


# -- A.6.39 SGI ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("bpc", [1, 2])
def test_pillow_sgi_reads_as_pil(tmp_path, mode, bpc):
    """Pillow's SGI writer (raw planes) in each mode, 8 and 16 bits a
    channel (PIL keeps a 16-bit sample's high byte)."""
    reads(tmp_path, pillow(image(5, 9, {"L": 0, "RGB": 3, "RGBA": 4}[mode]), "SGI", mode, bpc=bpc), "SGI",
          ("f.sgi", "f.png"))


@pytest.mark.parametrize("z", [1, 3, 4])
def test_sgi_rle_reads_as_pil(tmp_path, z):
    """Hand-built RLE at 8 and 16 bits a channel (16-bit: 2-byte packets),
    raw 16-bit, a one-dimensional grey image."""
    g = image(5, 9).astype(np.int64)
    ch = np.stack([g, 255 - g, g // 2, g // 3][:z])
    for data in (cs.sgi_file(ch, 1, rle=True), cs.sgi_file((ch * 257) ^ 5, 2, rle=True),
                 cs.sgi_file(ch * 257 + 255 - ch, 2)):
        reads(tmp_path, data, "SGI")
    reads(tmp_path, cs.sgi_file(g[None], 1, dimension=1), "SGI")


def test_sgi_rle_rows_end_as_pils_decoder(tmp_path):
    """SgiRleDecode.c: a row's packets are counted by its length (a length
    past 2^31 reads nothing, the row keeps the previous row's values); a
    row that ends early keeps them too; a last counted packet that is not
    the row's end stops the decode with what was read; a packet past the
    row's width, and tables past the file, are refused."""
    g = image(4, 6).astype(np.int64)
    data = bytearray(cs.sgi_file(g[None], 1, rle=True))
    lens = 512 + 4 * 4
    for i, value in ((1, 0x80000000), (2, 1)):
        d = bytearray(data)
        struct.pack_into(">I", d, lens + 4 * i, value)
        assert holds(tmp_path / "f.sgi", bytes(d))[1] is not None
    short_row = bytearray(data)
    at = struct.unpack_from(">I", short_row, 512 + 4)[0]
    short_row[at] = 0
    assert holds(tmp_path / "f.sgi", bytes(short_row))[1] is not None
    wide = bytearray(data)
    wide[struct.unpack_from(">I", wide, 512)[0]] = 0x7F
    assert holds(tmp_path / "f.sgi", bytes(wide)) == ("SGI", None)
    assert holds(tmp_path / "f.sgi", bytes(data[:512 + 20])) == ("SGI", None)


# -- A.6.40 SUN ----------------------------------------------------------------

@pytest.mark.parametrize("file_type", [0, 1, 2, 3])
@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
def test_sun_raster_reads_as_pil(tmp_path, file_type, depth):
    """Hand-built Sun rasters (Pillow writes none) at each depth, raw (rows
    padded to 16 bits; type 3 RGB order) and RLE (type 2: unpadded rows,
    runs carried into the next rows), an odd width."""
    g = image(5, 11)
    rows = {1: [np.packbits(r > 128).tobytes() for r in g], 4: sun_nibbles(g),
            8: [r.tobytes() for r in g], 24: [r.tobytes() for r in image(5, 11, 3)],
            32: [r.tobytes() for r in image(5, 11, 4)]}[depth]
    reads(tmp_path, cs.sun_file(rows, 11, 5, depth, file_type=file_type), "SUN", ("f.ras", "f.png"))


def test_sun_palettes_and_rle_ends(tmp_path):
    """A palette (planar RGB) makes 4 and 8-bit grey mode P; PIL refuses one
    on a 1-bit or RGB image and one of more than 256 entries; RLE data that
    ends before the image is full is refused, a run past the image read."""
    g = image(5, 11)
    pal = (np.arange(768) * 3 % 256).astype(np.uint8).tobytes()
    reads(tmp_path, cs.sun_file([r.tobytes() for r in g], 11, 5, 8, palette=pal), "SUN")
    reads(tmp_path, cs.sun_file(sun_nibbles(g), 11, 5, 4, file_type=2, palette=bytes(range(48))), "SUN")
    for data in (cs.sun_file([np.packbits(r > 128).tobytes() for r in g], 11, 5, 1, palette=bytes(6)),
                 cs.sun_file([r.tobytes() for r in g], 11, 5, 8, palette=bytes(774))):
        assert holds(tmp_path / "f.ras", data) == ("SUN", None)
    rle = cs.sun_file([r.tobytes() for r in g], 11, 5, 8, file_type=2)
    assert holds(tmp_path / "f.ras", rle[:-2]) == ("SUN", None)
    assert holds(tmp_path / "f.ras", rle[:32] + bytes([0x80, 255, 7]))[1] is not None


# -- A.6.41 MSP ----------------------------------------------------------------

def test_msp_reads_as_pil(tmp_path):
    """Pillow's MSP writer (version 1) and hand-built version 1 and 2
    files; a version 2 row of length 0 is white."""
    ink = image(7, 21) < 100
    reads(tmp_path, pillow(np.where(ink, 0, 255).astype(np.uint8), "MSP", "1"), "MSP", ("f.msp", "f.png"))
    line = np.zeros((5, 30), bool)
    line[2] = True
    for data in (cs.msp_file(ink, 1), cs.msp_file(ink, 2), cs.msp_file(line, 2)):
        reads(tmp_path, data, "MSP")


def test_msp_rows_of_another_length_shift_the_rest(tmp_path):
    """MspDecoder writes its rows into one buffer read as raw 1-bit rows: a
    row that decodes one byte long shifts every later row, too little data
    in all is refused, a run cut short is refused, too much is read."""
    ink = image(6, 16) < 100
    data = bytearray(cs.msp_file(ink, 2))
    rowmap = 32
    first = 32 + 2 * 6
    n0 = struct.unpack_from("<H", data, rowmap)[0]
    longer = bytes(data[:rowmap]) + struct.pack("<H", n0 + 2) + bytes(data[rowmap + 2:first]) \
        + bytes(data[first:first + n0]) + bytes([1, 0x0F]) + bytes(data[first + n0:])
    assert holds(tmp_path / "f.msp", longer)[1] is not None
    assert holds(tmp_path / "f.msp", bytes(data[:first + 3])) == ("MSP", None)
    cut_run = bytes(data[:rowmap]) + struct.pack("<H", 2) + bytes(data[rowmap + 2:first]) + bytes([0, 5]) \
        + bytes(data[first + n0:])
    assert holds(tmp_path / "f.msp", cut_run) == ("MSP", None)


# -- A.6.42 QOI ----------------------------------------------------------------

@pytest.mark.parametrize("bands", [3, 4])
def test_qoi_reads_as_pil(tmp_path, bands):
    """Pillow's QOI writer and the reference encoder's ops (index, diff,
    luma, run, RGB, RGBA), RGB and RGBA; a channel count other than 3 makes
    PIL's image RGBA."""
    a = image(6, 10, bands)
    a[:, 3:6] = a[0, 0]
    reads(tmp_path, pillow(a, "QOI"), "QOI", ("f.qoi", "f.png"))
    reads(tmp_path, cs.qoi_file(a), "QOI")
    odd = bytearray(cs.qoi_file(image(6, 10, 4)))
    odd[12] = 7
    reads(tmp_path, bytes(odd), "QOI")


def test_qoi_ends_as_pils_decoder(tmp_path):
    """QoiDecoder reads ops until the image is full: the end marker is not
    needed, data that ends before is refused (an op's bytes cut short too),
    an index never set is (0, 0, 0, 0), a run past the image is read."""
    a = image(4, 5, 3)
    data = cs.qoi_file(a)
    body = data[:-8]
    assert holds(tmp_path / "f.qoi", body)[1] is not None
    assert holds(tmp_path / "f.qoi", body[:-1]) == ("QOI", None)
    head = data[:14]
    assert holds(tmp_path / "f.qoi", head + bytes([0x05]) * 20)[1] is not None
    assert holds(tmp_path / "f.qoi", head + bytes([0xFE, 1, 2, 3, 0xFD]))[1] is not None
    assert holds(tmp_path / "f.qoi", head + bytes([0xFF, 1, 2]))[0] == "QOI"


@pytest.mark.parametrize("fmt,seed", [("TGA", 11), ("PCX", 12), ("DCX", 13), ("SGI", 14), ("SUN", 15),
                                      ("MSP", 16), ("QOI", 17)])
def test_damaged_files_read_as_pil(tmp_path, fmt, seed):
    """The probe of A.6.34-A.6.36 and A.6.39-A.6.42, 300 seeded damaged
    files a format, each as PIL has it (``scripts/raster_probe.py`` runs it
    at any size; PERF.md)."""
    counts = probe(tmp_path / "f.png", BASES[fmt](), seed, 300)
    assert sum(v[0] for v in counts.values()) and sum(v[1] for v in counts.values())


def test_phase_12_pages_and_tree_scans_read_as_pil(tmp_path):
    """``chip_smoke.a6_raster_pages`` (the card's 1200 x 500 pages of
    A.6.33-A.6.42, built without PIL) match the digests of PIL's grey that
    phase 12 holds them to (a6_pages.sha256), PIL's and the port's alike;
    each kind of ``chip_smoke.raster_scan`` (the card's raster tree) reads
    as PIL reads it and as the grey it was built from."""
    digests = dict(reversed(line.split()) for line in
                   (cs.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    for name, data in cs.a6_raster_pages(cs.golden_arrays()).items():
        (tmp_path / name).write_bytes(data)
        assert cs.gray_digest(pil_verdict(tmp_path / name)[1]) == digests[name], name
        assert cs.gray_digest(tdataset.decode_gray(tmp_path / name)) == digests[name], name
    scan = image(37, 61)
    for kind in cs.RASTER_TREE_KINDS:
        data, grey = cs.raster_scan(kind, scan)
        reads(tmp_path, data, kind.split("-")[0])
        np.testing.assert_array_equal(tdataset.decode_gray(tmp_path / "f.png"), grey)
