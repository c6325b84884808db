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
