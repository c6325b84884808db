"""Planar YCbCr old-style JPEG-in-TIFF (compression 6, PlanarConfiguration 2;
ROADMAP C.20) in the port's host decoder (``data/native/decode.cpp``,
``ojpeg_planes``) against PIL, through the JAX package; and C.22, a JPEG
Huffman table with an all-ones code, which libjpeg refuses.

libtiff's OJPEG codec decodes plane s as a frame of that one sample, its
scan found by searching the byte source (the JPEGInterchangeFormat bytes,
then every strip of every plane) onward from plane s - 1's SOS for the next
FF DA, which must name one component. PIL reads the planes through
libtiff's RGBA reader (gtStripSeparate, 1 x 1 subsampling alone): a call a
strip, each plane's strip read into a buffer cleared for the call, a plane
that fails to read left zero. So a tables-layout file whose planes hold no
SOS reads as TiffYcc(Y, 0, 0). The frames are written with
``torch_port_jpeg_writers.non_interleaved_jpeg`` (one scan a component)
and ``chip_smoke.ojpeg_planes_tiff``; each test states PIL's outcome."""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels
from test_torch_port_lzw_ojpeg_tiles import entries, ifd_first, pil_grey
from test_torch_port_progressive import pil_jpeg
from torch_port_jpeg_writers import FLAT_AC, FLAT_DC, non_interleaved_jpeg

import chip_smoke
from siggan_tpu_torch.data.native import loader as tnative


def segments(stream: bytes):
    """A JPEG's marker segments before its first SOS ((marker, body) each)
    and that SOS's offset."""
    out, i = [], 2
    while stream[i + 1] != 0xDA:
        m, n = stream[i + 1], struct.unpack(">H", stream[i + 2:i + 4])[0]
        out.append((m, stream[i + 4:i + 2 + n]))
        i += 2 + n
    return out, i


def scans(stream: bytes, renumber: bool = True):
    """(SOS segment, entropy-coded data with its RSTn) of each scan of a
    non-interleaved JPEG; ``renumber``: the SOS names component k, as the
    frame libtiff builds from the tables layout's tags does."""
    out, i = [], segments(stream)[1]
    while stream[i + 1] == 0xDA:
        n = struct.unpack(">H", stream[i + 2:i + 4])[0]
        sos, j = stream[i:i + 2 + n], i + 2 + n
        k = j
        while not (stream[k] == 0xFF and stream[k + 1] != 0 and not 0xD0 <= stream[k + 1] <= 0xD7):
            k += 1
        if renumber:
            sos = sos[:5] + bytes([len(out)]) + sos[6:]
        out.append((sos, stream[j:k]))
        i = k
    return out


def planar_jif(stream: bytes, w: int, h: int, *, photometric: int = 6, offsets: int = 1,
               counts: int = 3, sub=None) -> bytes:
    """JPEGInterchangeFormat giving the whole stream, StripOffsets of
    ``offsets`` and StripByteCounts of ``counts`` values (libtiff pads the
    shorter with zeros; one of each is its hack: contiguous samples)."""
    tags = [(258, 3, [8] * 3), (259, 3, [6]), (262, 3, [photometric]), (277, 3, [3]),
            (284, 3, [2]), (513, 4, lambda o: [o[0]]), (514, 4, [len(stream)]),
            (273, 4, lambda o: [o[0]] * offsets), (278, 4, [h]), (279, 4, [len(stream)] * counts)]
    if sub:
        tags.append((530, 3, list(sub)))
    return chip_smoke.tiff_pack(w, h, [stream], tags)


def planar_tables(stream: bytes, w: int, h: int, *, rows=None, sos=(False, True, True),
                  photometric: int = 6, sub=(1, 1), tile=None) -> bytes:
    """The tables layout: each plane's scan in strips (restart intervals of
    ``rows`` rows), plane after plane, the first strip of plane s opening
    with its SOS where ``sos[s]``; the tables in JPEGQTables /
    JPEGDCTables / JPEGACTables (the flat Huffman tables, shared). With
    ``tile`` = (tw, th) the intervals are tiles (the stream tw wide, its
    rows the tiles' one after another)."""
    segs = segments(stream)[0]
    q = {}
    for m, b in segs:
        for i in range(0, len(b) if m == 0xDB else 0, 65):
            q[b[i] & 15] = b[i + 1:i + 65]
    sof = next(b for m, b in segs if m == 0xC0)
    blobs = []
    for s, (head, data) in enumerate(scans(stream)):
        cuts = [k for k in range(len(data) - 1) if data[k] == 0xFF and 0xD0 <= data[k + 1] <= 0xD7]
        parts = [data[a:b] for a, b in zip([0] + [c + 2 for c in cuts], cuts + [len(data)])]
        if sos[s]:
            parts[0] = head + parts[0]
        blobs += parts
    n = len(blobs)
    tabs = [q[sof[8 + 3 * k]] for k in range(3)]
    dc, ac = bytes(FLAT_DC[0]) + bytes(FLAT_DC[1]), bytes(FLAT_AC[0]) + bytes(FLAT_AC[1])
    extra = list(dict.fromkeys(tabs + [dc, ac]))
    at = {t: n + k for k, t in enumerate(extra)}
    layout = ([(322, 4, [tile[0]]), (323, 4, [tile[1]]), (324, 4, lambda o: o[:n]),
               (325, 4, [len(b) for b in blobs])] if tile else
              [(273, 4, lambda o: o[:n]), (278, 4, [rows or h]), (279, 4, [len(b) for b in blobs])])
    tags = [(258, 3, [8] * 3), (259, 3, [6]), (262, 3, [photometric]), (277, 3, [3]), (284, 3, [2]),
            (512, 3, [1])] + layout + [(519, 4, lambda o: [o[at[t]] for t in tabs]),
            (520, 4, lambda o: [o[at[dc]]] * 3), (521, 4, lambda o: [o[at[ac]]] * 3)]
    if sub:
        tags.append((530, 3, list(sub)))
    return chip_smoke.tiff_pack(w, h, blobs + extra, tags)


def stream_of(h: int, w: int, seed: int, rows=None, subsampling: int = 0) -> bytes:
    """A non-interleaved baseline JPEG of seeded RGB, a restart every
    ``rows`` rows of 8 x 8 blocks."""
    rgb = pixels(np.random.RandomState(seed), (h, w, 3)).astype(np.uint8)
    src = pil_jpeg(rgb, quality=85, subsampling=subsampling)
    return non_interleaved_jpeg(src, restart=((w + 7) // 8) * (rows // 8) if rows else 0)


def test_non_interleaved_writer_is_read_by_pil_as_its_source():
    """``non_interleaved_jpeg`` re-codes a baseline JPEG's coefficients a
    scan a component: PIL's grey of it is PIL's grey of the source."""
    rgb = pixels(np.random.RandomState(3), (29, 37, 3)).astype(np.uint8)
    for sub in (0, 2):
        src = pil_jpeg(rgb, quality=85, subsampling=sub)
        for restart in (0, 3):
            ni = non_interleaved_jpeg(src, restart=restart)
            assert len(scans(ni)) == 3
            np.testing.assert_array_equal(pil_grey(ni), pil_grey(src))


@pytest.mark.parametrize("photometric", [6, 2])
@pytest.mark.parametrize("layout,offsets,counts", [("jif", 1, 3), ("jif", 3, 1), ("jif", 3, 3),
                                                   ("tables", 0, 0)])
@pytest.mark.parametrize("size", [(29, 37), (40, 24)])
def test_planar_ycbcr_reads_as_pil(tmp_path, photometric, layout, offsets, counts, size):
    """Both layouts, photometric 6 and 2 (libtiff takes 2 of 3 samples for
    YCbCr): the JPEGInterchangeFormat stream with StripOffsets or
    StripByteCounts padded by libtiff, and the tables layout with each
    plane's scan a strip; PIL reads each, and so does the port, bit-equal."""
    h, w = size
    stream = stream_of(h, w, h * w)
    data = (planar_jif(stream, w, h, photometric=photometric, offsets=offsets, counts=counts)
            if layout == "jif" else planar_tables(stream, w, h, photometric=photometric))
    assert pil_grey(data) is not None
    (tmp_path / "p.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "p.tif")


@pytest.mark.parametrize("subsampling", [0, 2])
def test_planes_of_one_strip_offset_and_count_are_contiguous(tmp_path, subsampling):
    """libtiff's old-style JPEG hack: PlanarConfiguration 2 whose
    StripOffsets and StripByteCounts hold one value each is read as
    contiguous samples, so an interleaved stream reads (4:4:4 and 4:2:0),
    as PIL reads it."""
    rgb = pixels(np.random.RandomState(9), (29, 37, 3)).astype(np.uint8)
    data = planar_jif(pil_jpeg(rgb, quality=85, subsampling=subsampling), 37, 29, counts=1)
    assert pil_grey(data) is not None
    (tmp_path / "p.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "p.tif")


@pytest.mark.parametrize("rows", [8, 16, 24])
@pytest.mark.parametrize("sos", [(False, True, True), (False, True, False), (False, False, True),
                                 (False, False, False)])
def test_planar_tables_strips_read_as_pil(tmp_path, rows, sos):
    """Planes in strips, each strip a restart interval, planes 1 and 2 with
    or without their SOS. A plane whose SOS is not found fails every read;
    PIL's reader leaves it zero. A plane's session left open reads on from
    where the search stopped (Y's second strip from the source's end: PIL
    reads 2 strips, refuses 3 or more); plane 1 found at plane 2's SOS,
    naming the wrong component, leaves libtiff's session stuck open and
    every later header fails (PIL refuses more than one strip)."""
    h, w = 29, 37
    data = planar_tables(stream_of(h, w, rows, rows=rows), w, h, rows=rows, sos=sos)
    want = pil_grey(data)
    if want is None:
        with pytest.raises(ValueError):
            tnative.decode(data)
        assert rows == 8 or sos == (False, False, True)
        return
    np.testing.assert_array_equal(tnative.decode(data), want)


def test_planes_without_their_sos_read_as_ycc_of_y_and_zero(tmp_path):
    """A tables-layout file whose planes 1 and 2 hold no SOS: PIL's grey is
    TiffYcc(Y, 0, 0), that of the same file whose chroma planes are scans of
    zeros (a zero plane decodes to zeros exactly), and the port's too."""
    y = pixels(np.random.RandomState(4), (24, 40)).astype(np.int64)
    zero = np.zeros_like(y)
    with_sos = chip_smoke.ojpeg_planes_tiff([y, zero, zero], chip_smoke.Q90)
    strips, at, f = entries(with_sos, 279)
    offs = entries(with_sos, 273)[0]
    d = bytearray(with_sos)
    for k in (1, 2):  # each chroma strip's SOS (10 bytes) made entropy data
        d[offs[k]:offs[k] + 10] = bytes(10)
    no_sos = bytes(d)
    want = pil_grey(no_sos)
    np.testing.assert_array_equal(want, pil_grey(with_sos))
    np.testing.assert_array_equal(tnative.decode(no_sos), want)
    assert strips[1] > 10


def test_planar_kinds_pil_refuses_are_corrupt(tmp_path):
    """PIL refuses, so the port calls corrupt: planes of 4:2:0 (the RGBA
    reader takes 1 x 1 alone), the tables layout without a YCbCrSubsampling
    tag (libtiff's default 2 x 2), a first strip opening with an SOS before
    any frame (libtiff wants the frame first), in planes and contiguous."""
    h, w = 29, 37
    files = {
        "420": planar_jif(stream_of(h, w, 1, subsampling=2), w, h),
        "no_tag": planar_tables(stream_of(h, w, 2), w, h, sub=None),
        "sos_first": planar_tables(stream_of(h, w, 3), w, h, sos=(True, True, True)),
    }
    grey = pil_jpeg(pixels(np.random.RandomState(5), (16, 16)).astype(np.uint8), quality=85)
    segs, sos = segments(grey)
    head = grey[sos:sos + 2 + struct.unpack(">H", grey[sos + 2:sos + 4])[0]]
    head = head[:5] + b"\0" + head[6:]  # the component libtiff's tables frame names
    strip = head + grey[sos + len(head):grey.rindex(b"\xff\xd9")]
    tables = {(b[0] >> 4, b[0] & 15): b[1:] for m, b in segs if m == 0xC4}
    q = next(b for m, b in segs if m == 0xDB)[1:65]
    files["contiguous_sos_first"] = chip_smoke.tiff_pack(16, 16, [strip, q, tables[0, 0], tables[1, 0]], [
        (258, 3, [8]), (259, 3, [6]), (262, 3, [1]), (277, 3, [1]), (512, 3, [1]),
        (273, 4, lambda o: o[:1]), (278, 4, [16]), (279, 4, [len(strip)]),
        (519, 4, lambda o: [o[1]]), (520, 4, lambda o: [o[2]]), (521, 4, lambda o: [o[3]])])
    for name, data in files.items():
        assert pil_grey(data) is None, name
        with pytest.raises(ValueError):
            tnative.decode(data, name)


def planar_tiled(h: int, w: int, tw: int, th: int, seed: int, sos=(False, True, True)) -> bytes:
    """Planar YCbCr old-style JPEG-in-TIFF of seeded RGB in tw x th tiles,
    the tables layout: each plane's scan tw wide, its rows the tiles' one
    after another (a restart interval a tile), planes 1 and 2 opening with
    their SOS where ``sos`` says."""
    down, across = -(-h // th), -(-w // tw)
    rgb = pixels(np.random.RandomState(seed), (down * th, across * tw, 3)).astype(np.uint8)
    tiles = [rgb[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] for ty in range(down) for tx in range(across)]
    stream = non_interleaved_jpeg(pil_jpeg(np.ascontiguousarray(np.concatenate(tiles, 0)), quality=85,
                                           subsampling=0), restart=(tw // 8) * (th // 8))
    return planar_tables(stream, w, h, tile=(tw, th), sos=sos)


def planar_tiles() -> bytes:
    """Planar YCbCr old-style JPEG-in-TIFF in 16 x 16 tiles of a 32 x 16
    image, the tables layout, which PIL reads through gtTileSeparate."""
    rgb = pixels(np.random.RandomState(6), (16, 32, 3)).astype(np.uint8)
    stacked = np.ascontiguousarray(np.concatenate([rgb[:, :16], rgb[:, 16:]], 0))
    stream = non_interleaved_jpeg(pil_jpeg(stacked, quality=85, subsampling=0), restart=4)
    return planar_tables(stream, 32, 16, tile=(16, 16))


def test_planar_tiles_pil_reads_raise_naming_a6(tmp_path):
    """A.6.48, planes in tiles: PIL reads them through gtTileSeparate, whose
    tile buffer is not cleared between a row's tiles. libtiff's frame of
    the tables layout is one column of tiles high, so the second tile of
    the row gets no line and keeps the first's rows: the right half reads
    as the left, in PIL and in the port, bit-equal."""
    data = planar_tiles()
    want = pil_grey(data)
    assert want is not None and np.array_equal(want[:, :16], want[:, 16:])
    (tmp_path / "p.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "p.tif")


@pytest.mark.parametrize("tw,th", [(16, 16), (16, 8), (32, 16), (8, 24)])
@pytest.mark.parametrize("size", [(16, 32), (30, 40), (17, 33), (40, 16), (48, 48), (8, 64)])
@pytest.mark.parametrize("sos", [(False, True, True), (False, False, False), (False, True, False),
                                 (False, False, True)])
def test_planar_tiles_read_as_pil(tw, th, size, sos):
    """Tile sizes, partial tiles at the right and bottom edges, one and
    several rows of tiles, planes 1 and 2 with or without their SOS: tiles
    below the frame read no line and keep the buffer (the tile before, in
    the row), a read that fails before it decodes clears its plane's tile,
    a first tile of a row that fails so fails PIL's read. PIL's verdict,
    and the port's: bit-equal, or corrupt where PIL refuses."""
    h, w = size
    data = planar_tiled(h, w, tw, th, h * w + tw * th, sos)
    want = pil_grey(data)
    if want is None:
        with pytest.raises(ValueError):
            tnative.decode(data)
        return
    np.testing.assert_array_equal(tnative.decode(data), want)


def damaged(seed: int):
    """A seeded planar file, either layout, in one strip a plane, in
    restart-interval strips or in tiles (the tables layout), planes 1 and 2
    with or without their SOS, its directory first or last, damaged one of
    four ways: bytes of a strile changed (0, some in its first 12: an SOS),
    a strile's byte count cut (1), the file truncated (2), a byte count past
    the end of the file (3). Returns (layout, damage, file)."""
    rs = np.random.RandomState(seed)
    h, w = int(rs.randint(8, 48)), int(rs.randint(8, 48))
    layout = ["jif", "tables", "tiles"][rs.randint(3)]
    sos = [(False, True, True), (False, False, False), (False, True, False)][rs.randint(3)]
    if layout == "jif":
        data = planar_jif(stream_of(h, w, seed), w, h, offsets=[1, 3][rs.randint(2)])
    elif layout == "tables":
        rows = [None, 8, 16][rs.randint(3)]
        rows = rows if rows and rows < h else None
        data = planar_tables(stream_of(h, w, seed, rows=rows), w, h, rows=rows, sos=sos)
    else:
        tw, th = [(16, 16), (16, 8), (8, 16), (32, 8)][rs.randint(4)]
        data = planar_tiled(h, w, tw, th, seed, sos)
    if rs.rand() < 0.5:
        data = ifd_first(data)
    d = bytearray(data)
    offs = entries(data, 324 if layout == "tiles" else 273)[0]
    counts, at, f = entries(data, 325 if layout == "tiles" else 279)
    how, i = rs.randint(4), rs.randint(len(counts))
    if how == 0:
        for _ in range(rs.randint(1, 4)):
            if offs[i % len(offs)] and counts[i]:
                p = offs[i % len(offs)] + rs.randint(min(counts[i], 12 if rs.rand() < 0.5 else counts[i]))
                d[p] = rs.randint(256)
    elif how == 1:
        struct.pack_into("<" + f, d, at + i * struct.calcsize(f), rs.randint(0, counts[i] + 1))
    elif how == 2:
        del d[rs.randint(min(o for o in offs if o), len(d)):]
    else:
        struct.pack_into("<" + f, d, at + i * struct.calcsize(f), len(d) + rs.randint(1, 5000))
    return layout, how, bytes(d)


@pytest.mark.parametrize("part", range(2))
def test_damaged_planes_probe_reads_as_pil(part):
    """C.20's probe, 300 files a part: read bit-equal where PIL reads,
    corrupt where it refuses. (It found the session left open after a
    failed search reading on from where the search stopped, and C.22.)"""
    verdicts = set()
    for seed in range(300 * part, 300 * part + 300):
        layout, how, data = damaged(seed)
        want = pil_grey(data)
        verdicts.add(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"seed {seed}")
    assert verdicts == {True, False}


def test_huffman_table_with_an_all_ones_code_is_corrupt():
    """C.22: libjpeg's jpeg_make_d_derived_tbl refuses a table in which a
    length's codes run to the all-ones code; the port read such a file
    (and wrote past its lookup table for a length of too many codes). 15
    DC codes of 4 bits read, 16 are refused, in a JPEG file and through
    the old-style tables tags (where the probe met it)."""
    import torch_port_jpeg_writers as writers
    src = pil_jpeg(pixels(np.random.RandomState(7), (16, 16)).astype(np.uint8), quality=85)
    flat = writers.FLAT_DC
    try:
        for k, reads in ((15, True), (16, False)):
            writers.FLAT_DC = ([0, 0, 0, k] + [0] * 12, list(range(k)))
            data = writers.non_interleaved_jpeg(src)
            assert (pil_grey(data) is not None) == reads
            if reads:
                np.testing.assert_array_equal(tnative.decode(data), pil_grey(data))
            else:
                with pytest.raises(ValueError, match="Huffman"):
                    tnative.decode(data)
    finally:
        writers.FLAT_DC = flat
    data = bytearray(planar_tables(stream_of(16, 16, 8), 16, 16))
    at = entries(bytes(data), 521)[0][0]
    data[at + 2] = 83  # the AC table's count of 3-bit codes: past 2^3
    assert pil_grey(bytes(data)) is None
    with pytest.raises(ValueError):
        tnative.decode(bytes(data))


def test_phase_12_page_reads_as_its_digest():
    """``chip_smoke.a6_gif_pnm_pages``' planar page (1200 x 500, built
    without PIL: Y the grey, two chroma planes of it) decodes to the digest
    of PIL's grey that the fixtures keep."""
    digests = dict(reversed(line.split()) for line in
                   (chip_smoke.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    data = chip_smoke.a6_gif_pnm_pages(chip_smoke.golden_arrays())["planar_ojpeg_page.tif"]
    with Image.open(io.BytesIO(data)) as im:
        assert chip_smoke.gray_digest(np.asarray(im.convert("L"))) == digests["planar_ojpeg_page.tif"]
    assert chip_smoke.gray_digest(tnative.decode(data)) == digests["planar_ojpeg_page.tif"]


def jif_cut(stream: bytes, cut: int, w: int, h: int, spp: int, photometric: int) -> bytes:
    """Old-style JPEG-in-TIFF whose JPEGInterchangeFormat block is the
    stream's first ``cut`` bytes and whose one strip is the rest."""
    tags = [(258, 3, [8] * spp), (259, 3, [6]), (262, 3, [photometric]), (277, 3, [spp]),
            (513, 4, lambda o: [o[0]]), (514, 4, [cut]), (273, 4, lambda o: [o[1]]), (278, 4, [h]),
            (279, 4, [len(stream) - cut])]
    if spp == 3:
        tags.append((530, 3, [1, 1]))
    return chip_smoke.tiff_pack(w, h, [stream[:cut], stream[cut:]], tags)


@pytest.mark.parametrize("spp", [1, 3])
@pytest.mark.parametrize("where", ["sos_end", "sos_mid", "com"])
def test_header_skip_stops_at_its_block_end(tmp_path, spp, where):
    """C.26: libtiff's OJPEGReadSkip skips no further than the end of the
    block it reads (the JPEGInterchangeFormat bytes, a strile). An SOS
    whose Ss, Se and Ah/Al lie past the block's end leaves them to the
    scan, and a COM segment cut at the block's end leaves its rest to the
    next marker's place; the port skipped across (so read, where PIL
    refuses, a file it now calls corrupt, and decoded the scan from the
    wrong byte: damaged planar files of the probe met it). Each as PIL
    reads it, grey and YCbCr 4:4:4."""
    g = pixels(np.random.RandomState(11), (16, 24, 3)).astype(np.uint8)
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(g[..., 0] if spp == 1 else g).save(b, "JPEG", quality=85, subsampling=0,
                                                       comment=b"a scanner's note")
    stream = b.getvalue()
    sos = stream.index(b"\xff\xda")
    com = stream.index(b"\xff\xfe")
    cut = {"sos_end": sos + 5 + 2 * spp, "sos_mid": sos + 6 + 2 * spp, "com": com + 8}[where]
    data = jif_cut(stream, cut, 24, 16, spp, 1 if spp == 1 else 6)
    want = pil_grey(data)
    if want is None:
        with pytest.raises(ValueError):
            tnative.decode(data)
        return
    np.testing.assert_array_equal(tnative.decode(data), want)
    assert where != "sos_end" or not np.array_equal(want, pil_grey(jif_cut(stream, sos + 8 + 2 * spp, 24, 16, spp,
                                                                           1 if spp == 1 else 6)))
