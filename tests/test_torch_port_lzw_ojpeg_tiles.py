"""Old-style LZW (ROADMAP A.6.18) and old-style JPEG-in-TIFF in tiles
(A.6.19) in the port's host decoder (``data/native/decode.cpp``) against
PIL, through the JAX package.

Old-style LZW is the LZW of libtiff before 5.0, which libtiff still reads
(``LZWDecodeCompat``): codes LSB first, the code width growing one code
later than new-style LZW, a strip cut at its byte count. libtiff takes the
style from the first strip it decodes (first byte 0, the second's low bit
set) for every strip of the image. ``chip_smoke.lzw_encode(old_style=True)``
writes it; PIL reading its output as the source image proves the writer.
Damaged strips are held to PIL: a bad code, a table that overflows (5119
entries), a strip without EOI, and a seeded probe.

Old-style JPEG-in-TIFF in tiles is read as libtiff's tif_ojpeg.c reads it
for PIL: the tiles are striles of one JPEG stream, each ``th`` rows of a
frame ``tw`` wide, a tile after another (across, then down). In the
JPEGInterchangeFormat layout the stream's frame is the writer's; in the
tables layout libtiff makes a frame one column of tiles high, so in a page
of several columns the tiles past it get no rows from libjpeg: grey ones
keep PIL's tile buffer (the previous tile's rows), YCbCr ones the last iMCU
row libtiff's raw buffer holds. PIL's libtiff RGBA reader takes the YCbCr
tiles; every edge tile is cropped."""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels
from test_torch_port_ojpeg import ojpeg_tables
from test_torch_port_progressive import pil_jpeg

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative


def pil_grey(data: bytes):
    """PIL's ``convert("L")``, or None where PIL refuses the file."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("L"))
    except Exception:
        return None


def holds(tmp_path, data: bytes, reads: bool, name: str = "f.tif"):
    """PIL reads the file or refuses it, as ``reads`` says, and so does the
    port: bit-equal with PIL, or corrupt (a zero image and ValueError)."""
    assert (pil_grey(data) is not None) == reads
    path = tmp_path / name
    path.write_bytes(data)
    if reads:
        assert_port_reads_as_pil(path)
        return
    assert not jdataset.decode_image(path, 16).any()
    assert not tdataset.decode_image(path, 16).any()
    with pytest.raises(ValueError):
        tnative.decode(data)


# -- A.6.18: old-style LZW ---------------------------------------------------------

RS = np.random.RandomState(18)
GREY = pixels(RS, (37, 45)).astype(np.int64)
RGB = pixels(RS, (21, 30, 3)).astype(np.int64)
OLD = -5  # chip_smoke.tiff_codec: old-style LZW, tagged 5

LAYOUTS = {
    "strips": lambda: chip_smoke.tiff_layout(GREY[..., None], 8, 1, compression=OLD,
                                             rows_per_strip=8),
    "one_strip": lambda: chip_smoke.tiff_layout(GREY[..., None], 8, 1, compression=OLD),
    "tiles": lambda: chip_smoke.tiff_layout(GREY[..., None], 8, 1, compression=OLD,
                                            tile=(16, 16)),
    "predictor_2": lambda: chip_smoke.tiff_layout(GREY[..., None], 8, 1, compression=OLD,
                                                  rows_per_strip=8, predictor=2),
    "16_bits": lambda: chip_smoke.tiff_layout(GREY[..., None] * 257, 16, 1, compression=OLD,
                                              rows_per_strip=8),
    "rgb_planar": lambda: chip_smoke.tiff_layout(RGB, 8, 2, compression=OLD, planar=2,
                                                 rows_per_strip=8),
    "fill_order_2": lambda: chip_smoke.tiff_layout(RGB, 8, 2, compression=OLD, fill=2,
                                                   rows_per_strip=8),
    "ycbcr": lambda: chip_smoke.tiff_ycbcr(GREY[:36, :44], GREY[:36:2, :44:2], GREY[1:36:2, 1:44:2],
                                           (2, 2), compression=OLD, rows_per_strip=8),
    "bilevel": lambda: chip_smoke.tiff_layout((GREY > 100)[..., None], 1, 1, compression=OLD,
                                              rows_per_strip=8),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_old_style_lzw_reads_as_pil(tmp_path, layout):
    """Every layout the LZW tests cover, in old-style LZW: PIL reads it
    (grey as the very source pixels, which proves the writer), and the port
    bit-equal with PIL."""
    data = LAYOUTS[layout]()
    assert data[data.index(struct.pack("<HHI", 259, 3, 1)) + 8] == 5
    if layout in ("strips", "one_strip", "tiles", "predictor_2"):
        np.testing.assert_array_equal(pil_grey(data), GREY)
    holds(tmp_path, data, True)


def test_old_style_pages_of_every_table_width(tmp_path):
    """A page of noise (the table filled and cleared again and again, codes
    of 9 to 12 bits) and of long runs (strings longer than a strip's rest)."""
    rs = np.random.RandomState(3)
    for img in (rs.randint(0, 256, (120, 300)), np.repeat(np.arange(60) % 7, 900).reshape(60, 900)):
        for rows in (7, 0):
            data = chip_smoke.tiff_layout(img[..., None], 8, 1, compression=OLD,
                                          rows_per_strip=rows)
            np.testing.assert_array_equal(pil_grey(data), img)
            holds(tmp_path, data, True)


def grey_strips(blobs, w: int, rows: int, h: int) -> bytes:
    return chip_smoke.tiff_pack(w, h, blobs, [
        (258, 3, [8]), (259, 3, [5]), (262, 3, [1]), (277, 3, [1]), (273, 4, lambda o: o),
        (278, 4, [rows]), (279, 4, [len(b) for b in blobs])])


@pytest.mark.parametrize("first", ["old", "new"])
def test_the_first_strip_decides_the_style(tmp_path, first):
    """Strips of both styles in one file: libtiff keeps the first strip's
    style for every strip, so a strip of the other style is read in the
    wrong one (here garbage: PIL refuses the file, or reads it otherwise
    than the source), and the port does as PIL does."""
    img = GREY[:32].astype(np.uint8)
    blobs = [chip_smoke.lzw_encode(img[y:y + 8].tobytes(), old_style=(y // 8) % 2 == (first == "new"))
             for y in range(0, 32, 8)]
    data = grey_strips(blobs, 45, 8, 32)
    got = pil_grey(data)
    assert got is None or not np.array_equal(got, img)
    holds(tmp_path, data, got is not None)


def old_codes(codes, widths=None) -> bytes:
    """Codes packed LSB first at old-style LZW's widths (the decoder's table
    one entry behind: a clear code resets it), or at ``widths``."""
    out, acc, n, free, width = bytearray(), 0, 0, None, 9
    for i, code in enumerate(codes):
        w = widths[i] if widths else width
        acc |= code << n
        n += w
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8
        if code == 256:
            free, width = None, 9
        elif free is None:
            free = 258
        else:
            free += 1
            if free > (1 << width) - 1 and width < 12:
                width += 1
    if n:
        out.append(acc & 0xFF)
    return bytes(out)


DAMAGED = {  # name -> (strip, whether PIL reads it)
    "code_past_the_next_entry": (old_codes([256, 65, 66, 300, 257]), False),
    "no_clear_code_first": (old_codes([65, 66, 67, 257], [9] * 4), False),
    "clear_then_a_string_code": (old_codes([256, 258, 257]), False),
    "table_overflow": (old_codes([256] + [65] * 4870 + [257]), False),
    "table_full_after_the_strip": (old_codes([256] + [65] * 4870 + [257]), True),
    "no_eoi_strip_full": (old_codes([256] + [65] * 45 * 8), True),
    "cut_before_the_strip_is_full": (old_codes([256] + [65] * 45 * 4 + [257]), False),
    "kwkwk_codes": (old_codes([256, 65] + list(range(258, 284)) + [257]), True),
}


@pytest.mark.parametrize("name", sorted(DAMAGED))
def test_damaged_old_style_strips_read_as_pil(tmp_path, name):
    """Strips of old-style codes written by hand (a first strip of 8 rows
    of 45, old-style by its first two bytes): a code past the next free
    entry, a first code that is no clear code, a clear code followed by a
    string code, the table past its 5119 entries (its 4863rd code after the
    clear would make entry 5119: a strip of 4863 bytes is refused there, one
    of 4862 is full a code before), a strip filled without
    EOI (read: libtiff only warns), a strip cut short, KwKwK codes whose
    last string runs past the strip's end (cut to it)."""
    strip, reads = DAMAGED[name]
    if name == "no_clear_code_first":  # it must still look old-style to libtiff
        strip = b"\x00\x01" + strip
    w = {"table_overflow": 4863, "table_full_after_the_strip": 4862}.get(name, 45)
    data = grey_strips([strip], w, 1, 1) if w != 45 else grey_strips([strip], 45, 8, 8)
    holds(tmp_path, data, reads)


def damage(rs, blob: bytes) -> bytes:
    b, kind = bytearray(blob), rs.randint(4)
    if kind == 0:
        for _ in range(rs.randint(1, 3)):
            b[rs.randint(len(b))] ^= 1 << rs.randint(8)
    elif kind == 1:
        b[rs.randint(2, len(b))] = rs.randint(256)
    elif kind == 2:
        del b[rs.randint(2, len(b) + 1):]
    else:
        del b[-2:]  # the EOI code's bytes
    return bytes(b)


@pytest.mark.parametrize("part", range(2))
def test_damaged_old_style_probe_reads_as_pil(tmp_path, part):
    """A seeded probe of 100 files a part: grey pages in old-style strips
    (one in six new-style, so files mix the styles), one strip damaged (bits
    flipped, a byte replaced, cut, its EOI cut off): read bit-equal where
    PIL reads, refused where it refuses."""
    verdicts = []
    for seed in range(100 * part, 100 * part + 100):
        rs = np.random.RandomState(seed)
        h, w = int(rs.randint(2, 50)), int(rs.randint(2, 80))
        img = (rs.randint(0, 256, (h, w)) if rs.rand() < 0.5 else
               np.add.outer(np.arange(h), np.arange(w)) * rs.randint(1, 5) % 256).astype(np.uint8)
        rows = int(rs.randint(1, h + 1))
        blobs = [chip_smoke.lzw_encode(img[y:y + rows].tobytes(), old_style=rs.rand() < 0.85)
                 for y in range(0, h, rows)]
        i = rs.randint(len(blobs))
        blobs[i] = damage(rs, blobs[i])
        data = grey_strips(blobs, w, rows, h)
        want = pil_grey(data)
        verdicts.append(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"seed {seed}")
    assert 0 < sum(verdicts) < len(verdicts)


# -- A.6.19: old-style JPEG-in-TIFF in tiles -----------------------------------------

def tile_stream(img, tile, kind: str) -> bytes:
    """PIL's JPEG of the tiles of ``img`` (edges repeated) one after another
    in a frame a tile wide, a restart interval a tile."""
    tw, th = tile
    h, w = img.shape[:2]
    across, down = -(-w // tw), -(-h // th)
    pad = np.pad(img, ((0, down * th - h), (0, across * tw - w)) + ((0, 0),) * (img.ndim - 2),
                 mode="edge")
    frame = np.concatenate([pad[y:y + th, x:x + tw] for y in range(0, down * th, th)
                            for x in range(0, across * tw, tw)])
    mcu = 16 if kind == "420" else 8
    return pil_jpeg(frame, quality=85, restart_marker_rows=th // mcu,
                    **({} if kind == "grey" else {"subsampling": SUB[kind][1]}))


SUB = {"444": ((1, 1), 0), "422": ((2, 1), 1), "420": ((2, 2), 2)}
SIZES = {"one_column": (32, 16, (16, 16)), "edges": (37, 45, (16, 16)),
         "taller_tiles": (20, 40, (16, 32)), "two_by_two": (48, 64, (32, 32))}


@pytest.mark.parametrize("layout", ["jif", "tables"])
@pytest.mark.parametrize("kind", ["grey", "444", "422", "420"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_ojpeg_tiles_read_as_pil(tmp_path, layout, kind, size):
    """Both layouts, grey and YCbCr 4:4:4, 4:2:2, 4:2:0, a column of tiles,
    edge tiles of a page off the tile grid, tiles taller than the page and
    two columns: read bit-equal with PIL (past the tables layout's frame as
    libtiff reads past it)."""
    h, w, tile = SIZES[size]
    rs = np.random.RandomState(h * w)
    img = rs.randint(0, 256, (h, w) if kind == "grey" else (h, w, 3)).astype(np.uint8)
    stream = tile_stream(img, tile, kind)
    spp, photometric = (1, 1) if kind == "grey" else (3, 6)
    if layout == "jif":
        data = chip_smoke.ojpeg_tiles(stream, w, h, tile, spp, photometric)
    else:
        data = ojpeg_tables(stream, w, h, spp, photometric=photometric, tile=tile,
                            sub=None if kind == "grey" else SUB[kind][0])
    holds(tmp_path, data, True)


def test_ojpeg_tiles_pil_refuses_are_corrupt(tmp_path):
    """Tiles not whole MCU rows of 4:2:0 (8 rows), and a stream's frame
    wider or narrower than its tiles: PIL refuses each (libtiff's OJPEG
    checks), and the port calls it corrupt."""
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (40, 48, 3)).astype(np.uint8)
    stream = tile_stream(img, (16, 8), "444")
    with_420 = pil_jpeg(np.concatenate([img[:, :16], img[:, 16:32], img[:, 32:]]), quality=85,
                        subsampling=2)
    holds(tmp_path, ojpeg_tables(with_420, 48, 40, 3, sub=(2, 2), tile=(16, 8)), False, "a.tif")
    grey = rs.randint(0, 256, (32, 32)).astype(np.uint8)
    wide = pil_jpeg(grey, quality=85)

    def jif(w, h, tile, s, n):
        return chip_smoke.tiff_pack(w, h, [s], [
            (258, 3, [8]), (259, 3, [6]), (262, 3, [1]), (277, 3, [1]), (322, 4, [tile[0]]),
            (323, 4, [tile[1]]), (324, 4, lambda o: [o[0]] * n), (325, 4, [len(s)] * n),
            (513, 4, lambda o: [o[0]]), (514, 4, [len(s)])])
    holds(tmp_path, jif(32, 32, (16, 16), wide, 4), False, "wide.tif")
    narrow = pil_jpeg(grey[:16, :24], quality=85)
    holds(tmp_path, jif(20, 16, (32, 16), narrow, 1), False, "narrow.tif")
    assert stream  # the 4:4:4 tiles of 8 rows themselves are whole MCU rows
    holds(tmp_path, chip_smoke.ojpeg_tiles(stream, 48, 40, (16, 8), 3), True, "rows8.tif")


def test_ojpeg_jif_frame_of_the_page_height(tmp_path):
    """A JPEGInterchangeFormat frame as high as the page, not as its tiles
    (libtiff takes a frame no lower than the page): the last tile's rows
    past the frame are not read, and the page reads as PIL reads it."""
    rs = np.random.RandomState(5)
    for kind, spp, photometric in (("grey", 1, 1), ("420", 3, 6)):
        img = rs.randint(0, 256, (20, 16) if spp == 1 else (20, 16, 3)).astype(np.uint8)
        s = pil_jpeg(img, quality=85, restart_marker_rows=1,
                     **({} if spp == 1 else {"subsampling": 2}))
        data = chip_smoke.tiff_pack(16, 20, [s], [
            (258, 3, [8] * spp), (259, 3, [6]), (262, 3, [photometric]), (277, 3, [spp]),
            (322, 4, [16]), (323, 4, [16]), (324, 4, lambda o: [o[0]] * 2),
            (325, 4, [len(s)] * 2), (513, 4, lambda o: [o[0]]), (514, 4, [len(s)])])
        holds(tmp_path, data, True, f"{kind}.tif")


# -- C.17: damaged old-style JPEG-in-TIFF tiles --------------------------------------

def ifd_first(data: bytes) -> bytes:
    """A little-endian classic TIFF of ``chip_smoke.tiff_pack`` with its
    directory (and the values it points at) moved in front of the image
    data, every offset moved with it: cutting the file then cuts the data,
    not the directory."""
    at = struct.unpack_from("<I", data, 4)[0]
    region = bytearray(data[at:])
    shift = len(region) + (len(region) & 1)
    for i in range(struct.unpack_from("<H", region, 0)[0]):
        e = 2 + 12 * i
        tag, typ, count = struct.unpack_from("<HHI", region, e)
        where = e + 8
        if {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1}[typ] * count > 4:
            where = struct.unpack_from("<I", region, e + 8)[0] - at
            struct.pack_into("<I", region, e + 8, where + 8)
        if tag in (273, 324, 513, 519, 520, 521):  # offsets into the image data
            f = "H" if typ == 3 else "I"
            values = struct.unpack_from(f"<{count}{f}", region, where)
            struct.pack_into(f"<{count}{f}", region, where, *[v + shift for v in values])
    return data[:4] + struct.pack("<I", 8) + bytes(region) + b"\0" * (len(region) & 1) + data[8:at]


def entries(data: bytes, tag: int):
    """An entry's values, where they sit and their struct format."""
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        e = ifd + 2 + 12 * i
        t, typ, count = struct.unpack_from("<HHI", data, e)
        if t == tag:
            f = "H" if typ == 3 else "I"
            at = e + 8 if count * struct.calcsize(f) <= 4 else struct.unpack_from("<I", data, e + 8)[0]
            return list(struct.unpack_from(f"<{count}{f}", data, at)), at, f
    raise KeyError(tag)


def damaged_tiles(seed: int):
    """A seeded old-style JPEG-in-TIFF in tiles, either layout, grey or
    YCbCr 4:4:4, 4:2:2 or 4:2:0, its directory first or last, then damaged
    one of four ways: bytes of a tile changed (0), a tile's byte count cut
    (1), the file truncated (2), a tile's byte count past the end of the
    file (3). Returns (layout, kind, damage, file)."""
    rs = np.random.RandomState(seed)
    layout, kind = ["jif", "tables"][rs.randint(2)], ["grey", "444", "422", "420"][rs.randint(4)]
    tw, th = [(16, 16), (16, 32), (32, 16), (32, 32)][rs.randint(4)]
    h, w = int(rs.randint(8, 70)), int(rs.randint(8, 70))
    img = rs.randint(0, 256, (h, w) if kind == "grey" else (h, w, 3)).astype(np.uint8)
    if rs.rand() < 0.5:
        img = (np.add.outer(np.arange(h), np.arange(w)) * 3 % 256).astype(np.uint8)
        if kind != "grey":
            img = np.dstack([img, img[::-1], 255 - img])
    stream = tile_stream(img, (tw, th), kind)
    spp, photometric = (1, 1) if kind == "grey" else (3, 6)
    if layout == "jif":
        data = chip_smoke.ojpeg_tiles(stream, w, h, (tw, th), spp, photometric)
    else:
        data = ojpeg_tables(stream, w, h, spp, photometric=photometric, tile=(tw, th),
                            sub=None if kind == "grey" else SUB[kind][0])
    if rs.rand() < 0.5:
        data = ifd_first(data)
    d = bytearray(data)
    offs = entries(data, 324)[0]
    counts, at, f = entries(data, 325)
    how, i = rs.randint(4), rs.randint(len(offs))
    if how == 0:
        for _ in range(rs.randint(1, 4)):
            if counts[i]:
                p = offs[i] + rs.randint(counts[i])
                d[p] = rs.randint(256) if rs.rand() < 0.5 else d[p] ^ (1 << rs.randint(8))
    elif how == 1:
        struct.pack_into("<" + f, d, at + i * struct.calcsize(f), rs.randint(0, counts[i] + 1))
    elif how == 2:
        del d[rs.randint(min(offs), len(d)):]
    else:
        struct.pack_into("<" + f, d, at + i * struct.calcsize(f), len(d) + rs.randint(1, 5000))
    return layout, kind, how, bytes(d)


@pytest.mark.parametrize("part", range(2))
def test_damaged_ojpeg_tiles_probe_reads_as_pil(part):
    """C.17's probe, 200 files a part: both tile layouts, grey and YCbCr,
    bytes changed, a tile's count cut, the file truncated, a count past the
    file: read bit-equal where PIL reads, corrupt where it refuses. (Before
    C.17 the port appended an EOI to every stream and read on where libtiff
    stops: 31 of 1500 such files read otherwise than PIL.)"""
    verdicts = {}
    for seed in range(200 * part, 200 * part + 200):
        layout, kind, how, data = damaged_tiles(seed)
        want = pil_grey(data)
        verdicts.setdefault(how, set()).add(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"seed {seed}")
    assert verdicts[2] == {True, False} and True in verdicts[0] | verdicts[3]


# Seeds of damaged_tiles that show C.17's rules (PIL's verdict, the tiles it
# leaves blank): a truncated file whose last tiles have no data, so
# libtiff's stream has no EOI and libjpeg runs out in a tile.
STOPS = {
    "ycbcr_stop_in_the_last_row": (1246, True),    # tiles 1 and 2 of 3 blank
    "ycbcr_stop_before_the_last_row": (91, False),  # the next row's first tile fails
    "grey_stop": (1430, False),                     # TIFFReadEncodedTile fails
}


@pytest.mark.parametrize("name", sorted(STOPS))
def test_ojpeg_tiles_stopped_by_the_end_of_their_data(tmp_path, name):
    """A tile the stream runs out in (no EOI after it): libtiff zeroes it,
    and every later tile fails before it is read; PIL's RGBA reader keeps
    the zeroed buffer for those unless one is the first tile of its call (a
    row of tiles), so YCbCr reads with the stopped tile and the rest of the
    last row blank (Y = Cb = Cr = 0) and is refused when a row follows;
    grey, read tile by tile, is refused."""
    seed, reads = STOPS[name]
    layout, kind, how, data = damaged_tiles(seed)
    assert how == 2 and layout == "jif"
    holds(tmp_path, data, reads)
    if reads:
        grey = pil_grey(data)
        blank = grey[:, 16:].ravel()
        assert (blank == blank[0]).all() and grey[:, :16].std() > 0


# -- the datasets, phase 12's pages and tree ------------------------------------------

def test_datasets_read_the_new_kinds_as_jax(tmp_path, monkeypatch):
    """Two writers' old-style LZW and tiled old-style JPEG-in-TIFF scans
    beside PNGs: ``SignatureDataset`` bit-equal with the JAX package's (its
    PIL path)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    rs = np.random.RandomState(6)
    for wi in range(2):
        d = tmp_path / f"writer{wi}"
        d.mkdir()
        for k in range(2):
            scan = pixels(rs, (40 + 8 * k, 64)).astype(np.uint8)
            (d / f"w{wi}_lzw{k}.tif").write_bytes(chip_smoke.tiff_layout(
                scan[..., None].astype(np.int64), 8, 1, compression=OLD, rows_per_strip=16))
            (d / f"w{wi}_ojpeg{k}.tif").write_bytes(chip_smoke.ojpeg_tiles(
                tile_stream(np.dstack([scan] * 3), (32, 16), "420"), 64, scan.shape[0], (32, 16),
                3))
        Image.fromarray(pixels(rs, (30, 70)).astype(np.uint8)).save(d / f"w{wi}_png.png")
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 10
    np.testing.assert_array_equal(t.images, j.images)


def test_phase_12_pages_read_as_their_digests():
    """``chip_smoke.a6_ccitt_lzw_pages`` (1200 x 500, built without PIL:
    Group 4 tiles, a 1-bit palette, the uncompressed-mode bit, old-style
    LZW, old-style JPEG-in-TIFF tiles, a SOF11 JPEG) decode to the digests
    of PIL's grey the fixtures keep, or are corrupt where PIL refuses them,
    as phase 12 holds them on the card's host; PIL gives those digests."""
    digests = dict(reversed(line.split()) for line in
                   (chip_smoke.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    pages = chip_smoke.a6_ccitt_lzw_pages(chip_smoke.golden_arrays())
    assert len(pages) == 6
    for name, data in pages.items():
        want = pil_grey(data)
        if digests[name] == "refused":
            assert want is None
            with pytest.raises(ValueError, match="SOF11"):
                tnative.decode(data, name)
            continue
        assert chip_smoke.gray_digest(want) == digests[name]
        assert chip_smoke.gray_digest(tnative.decode(data, name)) == digests[name]


def test_mixed_tree_old_style_lzw_reads_as_pil(tmp_path):
    """``chip_smoke.mixed_tiff``'s old-style LZW layout of a scan reads as
    PIL reads it (its source pixels)."""
    grey = pixels(np.random.RandomState(7), (300, 420)).astype(np.uint8)
    layout, data = chip_smoke.mixed_tiff(grey, 12)
    assert layout == "old_lzw"
    np.testing.assert_array_equal(pil_grey(data), grey)
    holds(tmp_path, data, True)
