"""CCITT RLE-W (compression 32771, ROADMAP A.6.23) and ThunderScan
(compression 32809, A.6.24) in the port's host decoder
(``data/native/decode.cpp``) against PIL, through the JAX package.

RLE-W is libtiff's Fax3DecodeRLE: each row's Modified Huffman runs, no EOL,
no RTC, then the row aligned to a 16-bit word as libtiff's reader sees it:
the bits it holds past a multiple of 16 dropped and, holding none, its read
pointer moved to an even address. PIL hands libtiff the file at an even
address, so a strip at an odd offset is aligned otherwise than one at an
even offset, and a file padded to words from the strip's start, as the
format says, can read otherwise than it was written, or not at all.
``chip_smoke.rlew_strip`` writes libtiff's alignment (its reader's fetches
followed) or the format's.

ThunderScan is libtiff's ThunderDecode: a code byte's top two bits choose a
run of the last pixel, three 2-bit deltas, two 3-bit deltas (a delta of the
skip code writes nothing) or a raw 4-bit pixel; a row is the image's width
in pixels, and a row of too few or too many fails the strip.
``chip_smoke.thunder_codes`` writes every code kind; PIL reading its output
as the source image proves it."""

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels
from test_torch_port_lzw_ojpeg_tiles import holds, pil_grey

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative

RLEW, THUNDER = 32771, 32809


def strips_tiff(blobs, w: int, h: int, rows: int, bits: int, compression: int,
                photometric: int = 0, odd: bool = False, tags=()) -> bytes:
    """A TIFF of ``blobs``, one a strip of ``rows`` rows; ``odd``: each
    strip one byte past an even offset."""
    pre = b"\0" if odd else b""
    return chip_smoke.tiff_pack(w, h, [pre + b for b in blobs], [
        (258, 3, [bits]), (259, 3, [compression]), (262, 3, [photometric]), (277, 3, [1]),
        (273, 4, lambda o: [x + len(pre) for x in o]), (278, 4, [rows]),
        (279, 4, [len(b) for b in blobs])] + list(tags))


def ink(rs, h: int, w: int):
    black = rs.rand(h, w) < rs.choice([0.05, 0.3, 0.6])
    if rs.rand() < 0.3:
        black[:] = black[:, :1]
    return black


# -- A.6.23: RLE-W ----------------------------------------------------------------------

RLEW_CASES = {  # name -> (width, height, rows a strip, odd offset)
    "even_width": (64, 20, 20, False),
    "odd_width": (37, 20, 7, False),
    "odd_offset": (45, 16, 5, True),
    "one_column": (1, 12, 12, False),
    "wide_runs": (3000, 4, 2, True),   # make-up codes of 2560 and more
}


@pytest.mark.parametrize("name", sorted(RLEW_CASES))
def test_rlew_reads_as_pil(tmp_path, name):
    """libtiff-aligned RLE-W of even and odd widths, strips at even and odd
    offsets, a single column and runs past 2560: bit-equal with PIL, and
    PIL's grey is the source (black 0, WhiteIsZero)."""
    w, h, rows, odd = RLEW_CASES[name]
    rs = np.random.RandomState(w)
    black = ink(rs, h, w)
    blobs = [chip_smoke.rlew_strip(black[y:y + rows], odd) for y in range(0, h, rows)]
    data = strips_tiff(blobs, w, h, rows, 1, RLEW, odd=odd)
    holds(tmp_path, data, True)
    np.testing.assert_array_equal(pil_grey(data), np.where(black, 0, 255))


def word_boundary_rows(rs, w: int, n: int):
    """Rows whose codes end on a 16-bit word: runs chosen until a row's
    Modified Huffman code is a whole number of words."""
    rows = []
    while len(rows) < n:
        row = ink(rs, 1, w)[0]
        if sum(len(word) for word, _ in chip_smoke.mh_words(row)) % 16 == 0:
            rows.append(row)
    return np.array(rows)


@pytest.mark.parametrize("odd", [False, True])
def test_rlew_rows_ending_on_a_word(tmp_path, odd):
    """Rows whose code ends exactly on a 16-bit word (no padding), at an
    even and an odd offset, in libtiff's alignment and in the format's:
    read as PIL reads them, each kind the same as the source in libtiff's."""
    black = word_boundary_rows(np.random.RandomState(3), 29, 12)
    for libtiff in (True, False):
        data = strips_tiff([chip_smoke.rlew_strip(black, odd, libtiff)], 29, 12, 12, 1, RLEW, odd=odd)
        want = pil_grey(data)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
            continue
        np.testing.assert_array_equal(tnative.decode(data), want)
        if libtiff:
            np.testing.assert_array_equal(want, np.where(black, 0, 255))


@pytest.mark.parametrize("part", range(2))
def test_rlew_probe_reads_as_pil(part):
    """A seeded probe of 150 files a part: widths 1 - 60, strips of any
    rows at even and odd offsets, libtiff's alignment or the format's (which
    libtiff reads otherwise where its reader holds 16 bits at a row's end),
    photometric 0 or 1, and damage in one strip of some (bits flipped, a
    cut, bytes added): read bit-equal where PIL reads, corrupt where it
    refuses."""
    verdicts = []
    for seed in range(150 * part, 150 * part + 150):
        rs = np.random.RandomState(seed)
        h, w = int(rs.randint(1, 20)), int(rs.randint(1, 60))
        black, rows, odd = ink(rs, h, w), int(rs.randint(1, h + 1)), bool(rs.rand() < 0.5)
        libtiff = rs.rand() < 0.5
        blobs = [bytearray(chip_smoke.rlew_strip(black[y:y + rows], odd, libtiff))
                 for y in range(0, h, rows)]
        if rs.rand() < 0.4:
            b = blobs[rs.randint(len(blobs))]
            kind = rs.randint(3)
            if kind == 0 and len(b):
                for _ in range(rs.randint(1, 3)):
                    b[rs.randint(len(b))] ^= 1 << rs.randint(8)
            elif kind == 1:
                del b[rs.randint(len(b) + 1):]
            else:
                b += bytes(rs.randint(0, 256, 2).tolist())
        data = strips_tiff([bytes(b) for b in blobs], w, h, rows, 1, RLEW,
                           photometric=int(rs.randint(2)), odd=odd)
        want = pil_grey(data)
        verdicts.append(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"seed {seed}")
    assert 0 < sum(verdicts) < len(verdicts)


def test_rlew_tiles_and_fill_order_2_read_as_pil(tmp_path):
    """RLE-W in tiles (each tile's rows its own data, a failing tile no
    error) and with FillOrder 2 (each byte's bits reversed): as PIL."""
    rs = np.random.RandomState(7)
    black = ink(rs, 40, 50)
    tiles = [chip_smoke.rlew_strip(np.pad(black, ((0, 8), (0, 14)))[y:y + 16, x:x + 32])
             for y in range(0, 40, 16) for x in range(0, 50, 32)]
    data = chip_smoke.tiff_pack(50, 40, tiles, [
        (258, 3, [1]), (259, 3, [RLEW]), (262, 3, [0]), (277, 3, [1]), (322, 3, [32]),
        (323, 3, [16]), (324, 4, lambda o: o), (325, 4, [len(t) for t in tiles])])
    holds(tmp_path, data, True, "tiles.tif")
    blob = chip_smoke.rlew_strip(black)
    data = strips_tiff([blob.translate(chip_smoke.REVERSED_BITS)], 50, 40, 40, 1, RLEW,
                       tags=[(266, 3, [2])])
    holds(tmp_path, data, True, "fill2.tif")


# -- A.6.24: ThunderScan ------------------------------------------------------------------

def test_thunder_writer_is_read_by_pil_as_its_source():
    """Every code kind of ``chip_smoke.thunder_codes`` (runs, 2-bit and
    3-bit deltas with skip codes, raw values; deltas wrapping modulo 16):
    PIL's grey is the 4-bit source x 17 (inverted for WhiteIsZero)."""
    for seed in range(12):
        rs = np.random.RandomState(seed)
        h, w = int(rs.randint(1, 24)), int(rs.randint(1, 40))
        img = (np.add.outer(np.arange(h), np.arange(w)) // rs.randint(1, 6) % 16 if seed % 2 else
               rs.randint(0, 16, (h, w)))
        rows, photometric = int(rs.randint(1, h + 1)), seed % 3 % 2
        codes = [chip_smoke.thunder_codes(img[y:y + rows], rs if seed % 4 else None)
                 for y in range(0, h, rows)]
        grey = pil_grey(strips_tiff(codes, w, h, rows, 4, THUNDER, photometric))
        np.testing.assert_array_equal(grey, img * 17 if photometric else 255 - img * 17)


THUNDER_ROWS = {  # name -> (code bytes of one 6-pixel row, whether PIL reads it)
    "raw": (bytes([0xC1, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6]), True),
    "run_from_an_even_pixel": (bytes([0xC7, 0x05]), True),
    "run_from_an_odd_pixel": (bytes([0xC7, 0xC3, 0x04]), True),
    "run_ending_the_row": (bytes([0xC9, 0xCA, 0x04]), True),
    "run_of_0": (bytes([0xC9, 0x00, 0xCA, 0xC1, 0xC2, 0xC3, 0xC4]), True),
    "run_past_the_row": (bytes([0xC9, 0x06]), False),
    "two_bit_deltas_with_skips": (bytes([0xC8, 0x4D, 0x62, 0x40]), True),
    "three_bit_deltas_with_skips": (bytes([0xC0, 0x9D, 0xA4, 0x85, 0xC1]), True),
    "deltas_wrapping": (bytes([0xC0, 0x7F, 0xCF, 0x55]), True),
    "too_few_pixels": (bytes([0xC1, 0xC2]), False),
    "extra_bytes_after_the_rows": (bytes([0xC1] * 6), True),   # see TAIL
    "extra_bytes_between_rows": (bytes([0xC1] * 6 + [0x3F, 0xC2]), False),
}
TAIL = {"extra_bytes_after_the_rows": bytes([0x3F, 0xC2, 0x00])}


@pytest.mark.parametrize("name", sorted(THUNDER_ROWS))
def test_thunder_code_kinds_read_as_pil(tmp_path, name):
    """Hand-written 6-pixel rows (three of them, one strip) of each code
    kind and each quirk: a run's odd start completing the half-written
    byte, a run that ends the row (written) or runs past it (the strip
    fails), a run of 0, skip codes, deltas wrapping past 15, a row of too
    few pixels, bytes left after the last row (not read) or between rows
    (the next row's): as PIL."""
    row, reads = THUNDER_ROWS[name]
    holds(tmp_path, strips_tiff([row * 3 + TAIL.get(name, b"")], 6, 3, 3, 4, THUNDER, 1), reads)


@pytest.mark.parametrize("bits", [1, 2, 8])
def test_thunder_of_other_bits_is_corrupt(tmp_path, bits):
    """ThunderScan of other than 4 bits: libtiff's decoder refuses it, and
    so PIL; corrupt."""
    holds(tmp_path, strips_tiff([bytes([0xC1] * 8)], 8, 1, 1, bits, THUNDER, 1), False)


@pytest.mark.parametrize("part", range(2))
def test_thunder_damage_probe_reads_as_pil(part):
    """A seeded probe of 150 files a part: random code kinds, one strip
    damaged (bytes replaced, cut, bytes added, a run inserted): a row of too
    few or too many pixels fails its strip (PIL refuses), any other reads;
    bit-equal where PIL reads."""
    verdicts = []
    for seed in range(1000 + 150 * part, 1150 + 150 * part):
        rs = np.random.RandomState(seed)
        h, w = int(rs.randint(1, 20)), int(rs.randint(1, 30))
        img = (np.add.outer(np.arange(h), np.arange(w)) // rs.randint(1, 6) % 16
               if rs.rand() < 0.5 else rs.randint(0, 16, (h, w)))
        rows = int(rs.randint(1, h + 1))
        blobs = [bytearray(chip_smoke.thunder_codes(img[y:y + rows], rs)) for y in range(0, h, rows)]
        b, kind = blobs[rs.randint(len(blobs))], rs.randint(4)
        if kind == 0 and len(b):
            for _ in range(rs.randint(1, 4)):
                b[rs.randint(len(b))] = rs.randint(256)
        elif kind == 1:
            del b[rs.randint(len(b) + 1):]
        elif kind == 2:
            b += bytes(rs.randint(0, 256, rs.randint(1, 5)).tolist())
        else:
            b.insert(rs.randint(len(b) + 1), rs.randint(0, 64))
        data = strips_tiff([bytes(x) for x in blobs], w, h, rows, 4, THUNDER, 1)
        want = pil_grey(data)
        verdicts.append(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"seed {seed}")
    assert 0 < sum(verdicts) < len(verdicts)


# -- the datasets, phase 12 ------------------------------------------------------------

def test_datasets_read_the_new_kinds_as_jax(tmp_path, monkeypatch):
    """Two writers' RLE-W and ThunderScan scans beside PNGs:
    ``SignatureDataset`` bit-equal with the JAX package's (its PIL path)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    rs = np.random.RandomState(9)
    for wi in range(2):
        d = tmp_path / f"writer{wi}"
        d.mkdir()
        scan = pixels(rs, (40 + 8 * wi, 61)).astype(np.uint8)
        for turn in (16, 17):
            layout, data = chip_smoke.mixed_tiff(scan, turn)
            (d / f"w{wi}_{layout}.tif").write_bytes(data)
        Image.fromarray(pixels(rs, (30, 70)).astype(np.uint8)).save(d / f"w{wi}_png.png")
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 6
    np.testing.assert_array_equal(t.images, j.images)


def test_mixed_tree_rlew_and_thunder_read_as_pil(tmp_path):
    """``chip_smoke.mixed_tiff``'s RLE-W and ThunderScan layouts of a scan,
    at even and odd widths, read as PIL reads them."""
    for w in (60, 61):
        scan = pixels(np.random.RandomState(w), (45, w)).astype(np.uint8)
        for turn in (16, 17):
            layout, data = chip_smoke.mixed_tiff(scan, turn)
            path = tmp_path / f"{layout}_{w}.tif"
            path.write_bytes(data)
            assert_port_reads_as_pil(path)
