"""CCITT layouts PIL reads that the port refused before (ROADMAP A.6.15 to
A.6.17), in the port's host decoder (``data/native/decode.cpp``) against
PIL, through the JAX package.

- Uncompressed mode (T4Options / T6Options bit 1): the bit alone changes
  nothing in libtiff, so every coding reads as the plain file. Code data
  that enters uncompressed mode is held to PIL's libtiff called through
  ctypes (``torch_port_libtiff.py``): its decoder ends the row at the 2-D
  extension code (``0000001xxx``, S_Ext in its mode table) and reads on, as
  at damaged data (C.14); its 1-D tables have no extension state, so the
  1-D code (``000000001111``) is a bad code there and ends the row too.
- Tiles: each tile a coded unit of tile-width rows on an all-white
  reference line, the edge tiles padded (PIL crops them), every coding,
  FillOrder 2. A damaged tile ends as a damaged strip does, but where the
  fax decoder fails (data that ends early, a row of too many runs) libtiff
  takes its -1 for success in tiles (TIFFReadEncodedTile tests the return
  for truth, TIFFReadEncodedStrip for <= 0): the rows it did not reach keep
  PIL's tile buffer (the previous tile's rows). Held to libtiff's reading
  tile after tile into one buffer.
- A 1-bit palette (photometric 3) on libtiff's route: PIL's ``P`` through
  its two ColorMap entries. A ColorMap of the wrong count or none, and
  photometric 2, 4, 5 or 6 on CCITT data, PIL refuses: corrupt (a zero
  image, as in the JAX package).

Tiles of every coding are PIL's own files of each tile's pixels, their one
strip taken as the tile; the pages of ``chip_smoke.py`` (Group 4 from its
own encoder, ``tiff_g4``) are held too."""

import numpy as np
import pytest
from test_torch_port_ccitt import (CODINGS, ccitt_bytes, ifd_entries, page, pil_l, strips,
                                   wrap)
from test_torch_port_decode import assert_port_reads_as_pil, layout_tags, pixels, tiff_file
from torch_port_libtiff import assert_reads_as_libtiff

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative

COMPRESSION = {"mh": 2, "t4_1d": 3, "t4_1d_fill": 3, "t4_2d": 3, "t4_2d_fill": 3, "t6": 4}
REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def options(coding: str, uncompressed: bool = False) -> list:
    """The T4Options / T6Options entry of a coding, (tag, type, value),
    with bit 1 set when ``uncompressed``; none for Modified Huffman unless
    the bit is asked."""
    t4 = CODINGS[coding][1] or 0
    bit = 2 if uncompressed else 0
    if coding == "t6":
        return [(293, 4, bit)] if bit else []
    return [(292, 4, t4 | bit)] if (t4 | bit) or coding != "mh" else []


def coded_file(img, coding: str, *, tile=None, fill: int = 1, uncompressed: bool = False,
               photometric: int = 1, extra=()) -> bytes:
    """A CCITT TIFF of bilevel ``img`` (True white): one strip, or tiles
    of ``tile`` = (tw, th) padded white, each PIL's coding of its pixels;
    FillOrder 2 reverses each byte's bits."""
    h, w = img.shape
    if tile is None:
        blobs = strips(ccitt_bytes(img, coding))
    else:
        tw, th = tile
        pad = np.ones((-(-h // th) * th, -(-w // tw) * tw), bool)
        pad[:h, :w] = img
        blobs = [strips(ccitt_bytes(pad[y:y + th, x:x + tw].copy(), coding))[0]
                 for y in range(0, pad.shape[0], th) for x in range(0, pad.shape[1], tw)]
    if fill == 2:
        blobs = [b.translate(REVERSED) for b in blobs]
    tags = [(258, 3, [1]), (259, 3, [COMPRESSION[coding]]), (262, 3, [photometric]),
            (277, 3, [1])] + layout_tags(tile, None, h)
    tags += [(t, typ, [v]) for t, typ, v in options(coding, uncompressed)]
    tags += ([(266, 3, [2])] if fill == 2 else []) + list(extra)
    return tiff_file(w, h, blobs, tags)


def check(tmp_path, data: bytes, name: str = "f.tif"):
    path = tmp_path / name
    path.write_bytes(data)
    assert_port_reads_as_pil(path)


# -- A.6.15: uncompressed mode ---------------------------------------------------

@pytest.mark.parametrize("coding", sorted(CODINGS))
def test_uncompressed_mode_bit_reads_as_the_plain_file(tmp_path, coding):
    """The options bit set, the data without the extension code: PIL reads
    each coding (MH carrying a T4Options of 2 too) as the page, and so does
    the port, bit-equal."""
    for seed, (h, w, kind) in enumerate(((20, 45, "strokes"), (9, 70, "noise"),
                                         (5, 2600, "strokes"))):
        img = page(np.random.RandomState(seed), h, w, kind)
        data = coded_file(img, coding, uncompressed=True)
        tags = ifd_entries(data)
        assert (tags[293 if coding == "t6" else 292][3][0] & 2) == 2
        np.testing.assert_array_equal(pil_l(data), np.where(img, 255, 0))
        check(tmp_path, data)


def two_d_rows(img) -> list:
    """Each row's 2-D code (``chip_smoke.g4_rows``, True black)."""
    return chip_smoke.g4_rows(~img)


def one_d_row(row) -> str:
    """A row's Modified Huffman runs, white first (True white)."""
    out, x, white = "", 0, True
    while x < len(row):
        e = x
        while e < len(row) and row[e] == white:
            e += 1
        out, x, white = out + chip_smoke.ccitt_run(e - x, not white), e, not white
    return out


EOL = "000000000001"
EXT_2D, EXT_1D = "0000001111", "000000001111"


def extension_file(coding: str, row: int, tail: str) -> bytes:
    """A 30 x 12 page of ``coding`` whose row ``row`` starts with the
    extension code into uncompressed mode (T.4 Table 6 / T.6 Table 4, the
    2-D one in 2-D rows, the 1-D one in MH and T.4 1-D rows), then ``tail``
    (uncompressed-mode bits libtiff does not read), then the page's rows on."""
    img = page(np.random.RandomState(row), 12, 30, "strokes")
    two, bits = two_d_rows(img), ""
    for y in range(12):
        if coding == "t6":
            code = (EXT_2D + tail if y == row else "") + two[y]
        elif coding == "t4_2d":
            code = EOL + ("1" + one_d_row(img[y]) if y == 0 else "0" + (EXT_2D + tail if y == row
                                                                           else "") + two[y])
        else:
            code = (EXT_1D + tail if y == row else "") + one_d_row(img[y])
            code = EOL + code if coding == "t4_1d" else code + "0" * (-len(code) % 8)
        bits += code
    opts = {"mh": [], "t4_1d": [(292, 4, 2)], "t4_2d": [(292, 4, 3)], "t6": [(293, 4, 2)]}[coding]
    return wrap(30, 12, [chip_smoke.fax_bytes(bits)], COMPRESSION[coding], extra=opts)


@pytest.mark.parametrize("coding", ["mh", "t4_1d", "t4_2d", "t6"])
@pytest.mark.parametrize("row,tail", [(3, "1"), (7, "0101011"), (11, "")])
def test_extension_code_reads_as_libtiff(tmp_path, coding, row, tail):
    """Data that enters uncompressed mode: libtiff's decoder ends the row at
    the extension code (2-D: S_Ext; 1-D: a bad code, its white table has
    no such state) and decodes on from the bits after it; the port gives
    libtiff's pixels, and PIL's wherever libtiff wrote (the JAX package's
    ``decode_image`` too where every row was written)."""
    data = extension_file(coding, row, tail)
    got = assert_reads_as_libtiff(data, tmp_path)
    if got is not None and got[1].all():
        check(tmp_path, data)


# -- A.6.16: tiles -----------------------------------------------------------------

@pytest.mark.parametrize("coding", sorted(CODINGS))
@pytest.mark.parametrize("fill", [1, 2])
def test_tiles_read_as_pil(tmp_path, coding, fill):
    """Tiles of every coding, edge tiles padded (a 45 x 37 page in 16 x 16
    tiles, a 70 x 20 one in 32 x 32: one tile row taller than the page, and
    a page of one tile), FillOrder 1 and 2."""
    for seed, (h, w, tile) in enumerate(((37, 45, (16, 16)), (20, 70, (32, 32)),
                                         (16, 16, (16, 16)))):
        img = page(np.random.RandomState(10 + seed), h, w, "strokes" if seed else "noise")
        data = coded_file(img, coding, tile=tile, fill=fill)
        np.testing.assert_array_equal(pil_l(data), np.where(img, 255, 0))
        check(tmp_path, data)


def damage(rs, blob: bytes) -> bytes:
    b = bytearray(blob)
    kind = rs.randint(3)
    if kind == 0:
        for _ in range(rs.randint(1, 4)):
            b[rs.randint(len(b))] ^= 1 << rs.randint(8)
    elif kind == 1:
        del b[rs.randint(1, len(b) + 1):]
    else:
        b[rs.randint(len(b))] = rs.randint(256)
    return bytes(b)


@pytest.mark.parametrize("coding", sorted(CODINGS))
def test_damaged_tiles_read_as_libtiff(tmp_path, coding):
    """A seeded probe of 30 files a coding, one or two tiles damaged (bits
    flipped, cut, a byte replaced): the port reads each as PIL's libtiff
    decodes it tile after tile into one buffer (rows a tile did not reach,
    whether its decoder stopped or failed, keep the previous tile's; in a
    first tile zeros where PIL's buffer is uncleared memory)."""
    rs = np.random.RandomState(sorted(CODINGS).index(coding))
    verdicts = []
    for _ in range(30):
        h, w = int(rs.randint(10, 40)), int(rs.randint(10, 60))
        tile = (16 * int(rs.randint(1, 3)), 16 * int(rs.randint(1, 3)))
        img = page(rs, h, w, ["noise", "strokes"][rs.randint(2)])
        data = coded_file(img, coding, tile=tile)
        tags = ifd_entries(data)
        offs, counts = tags[324][3], tags[325][3]
        blobs = [data[o:o + n] for o, n in zip(offs, counts)]
        for _ in range(rs.randint(1, 3)):
            i = rs.randint(len(blobs))
            blobs[i] = damage(rs, blobs[i])
        data = wrap(w, h, blobs, COMPRESSION[coding], extra=options(coding), tile=tile)
        verdicts.append(assert_reads_as_libtiff(data, tmp_path) is not None)
    assert any(verdicts)


# -- A.6.17: a 1-bit palette -------------------------------------------------------

RED_GREEN = [65535, 0, 0, 65535, 0, 0]  # ColorMap: index 0 red, 1 green


@pytest.mark.parametrize("coding", sorted(CODINGS))
def test_palette_reads_as_pil(tmp_path, coding):
    """Photometric 3 with a two-entry ColorMap: PIL opens ``P`` through
    libtiff and ``convert("L")`` gives the entries' greys (red 76 where the
    bit is 0, green 150 where it is 1); in strips and in tiles, and with
    FillOrder 2."""
    img = page(np.random.RandomState(20), 24, 50, "strokes")
    for kw in (dict(), dict(tile=(32, 16)), dict(fill=2)):
        data = coded_file(img, coding, photometric=3, extra=[(320, 3, RED_GREEN)], **kw)
        np.testing.assert_array_equal(pil_l(data), np.where(img, 150, 76))
        check(tmp_path, data)
    ink = chip_smoke.tiff_g4(~img, photometric=3, tags=[(320, 3, chip_smoke.PAPER_INK)])
    check(tmp_path, ink, "paper_ink.tif")


@pytest.mark.parametrize("case", ["colormap_of_3_entries", "colormap_of_1_entry",
                                  "no_colormap", "photometric_2", "photometric_4",
                                  "photometric_5", "photometric_6"])
def test_palette_and_photometric_refusals_are_corrupt(tmp_path, case):
    """What PIL refuses on CCITT data: a ColorMap of the wrong count or none
    (libtiff's directory then lacks its required ColorMap), photometric 2,
    4, 5 or 6 of one bit (no PIL mode): a zero image and ValueError."""
    img = page(np.random.RandomState(21), 16, 40, "strokes")
    if case.startswith("photometric"):
        data = coded_file(img, "t6", photometric=int(case[-1]))
    else:
        cmap = {"colormap_of_3_entries": RED_GREEN + [0, 0, 0], "colormap_of_1_entry": [0, 0, 0],
                "no_colormap": None}[case]
        data = coded_file(img, "t6", photometric=3, extra=[(320, 3, cmap)] if cmap else [])
    path = tmp_path / f"{case}.tif"
    path.write_bytes(data)
    with pytest.raises(Exception):
        pil_l(data)
    assert not jdataset.decode_image(path, 16).any()
    assert not tdataset.decode_image(path, 16).any()
    with pytest.raises(ValueError):
        tnative.decode(data)


# -- the datasets and phase 12's tree ---------------------------------------------

def test_datasets_over_the_new_layouts_match_jax(tmp_path, monkeypatch):
    """Two writers' scans in CCITT tiles, with a palette and with the
    uncompressed-mode bit, beside PNGs: ``SignatureDataset`` bit-equal with
    the JAX package's (its PIL path)."""
    from PIL import Image
    monkeypatch.setattr(jnative, "available", lambda: False)
    rs = np.random.RandomState(22)
    for wi in range(2):
        d = tmp_path / f"writer{wi}"
        d.mkdir()
        for k, coding in enumerate(("t6", "t4_2d", "mh")):
            img = pixels(rs, (40 + 6 * k, 80 - 5 * k)).astype(np.uint8) > 128
            (d / f"w{wi}_tiles{k}.tif").write_bytes(coded_file(img, coding, tile=(32, 32)))
            (d / f"w{wi}_pal{k}.tif").write_bytes(
                coded_file(img, coding, photometric=3, extra=[(320, 3, RED_GREEN)]))
            (d / f"w{wi}_unc{k}.tif").write_bytes(coded_file(img, coding, uncompressed=True))
        Image.fromarray(pixels(rs, (30, 70)).astype(np.uint8)).save(d / f"w{wi}_png.png")
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 20
    np.testing.assert_array_equal(t.images, j.images)


@pytest.mark.parametrize("turn", [9, 10, 11])
def test_mixed_tree_ccitt_layouts_read_as_pil(tmp_path, turn):
    """``chip_smoke.mixed_tiff``'s Group 4 layouts of a scan (tiles, a
    palette in tiles, the uncompressed-mode bit) read as PIL reads them."""
    grey = pixels(np.random.RandomState(23), (300, 420)).astype(np.uint8)
    layout, data = chip_smoke.mixed_tiff(grey, turn)
    assert layout == ("g4_tiles", "g4_palette", "g4_uncompressed")[turn - 9]
    check(tmp_path, data)
