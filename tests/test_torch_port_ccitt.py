"""CCITT-coded bilevel TIFF (Modified Huffman, T.4 1-D and 2-D with and
without EOL fill bits, T.6 / Group 4) in the port's host decoder
(``data/native/decode.cpp``) against PIL, through the JAX package.

The files are written by PIL (its libtiff: ``compression="tiff_ccitt"``,
``"group3"`` with ``tiffinfo={292: T4Options}``, ``"group4"``), on pages
drawn by hypothesis: widths off a multiple of 8, 1 px wide, wider than
2560 (the extended make-up codes), all white, all black, several strips.
PIL writes PhotometricInterpretation 1; a 0 is patched into the tag.
Each is read bit-equal with PIL's ``convert("L")`` through
``decode_gray``, ``data/dataset.py::decode_image`` and
``cli/preprocess.py::load_canvas`` against the JAX package's, and so is
Group 4 with FillOrder 2 (A.6.10), and the kinds refused before A.6.15 and
A.6.16, uncompressed mode and CCITT in tiles (their cases in full are
``tests/test_torch_port_ccitt_layouts.py``'s).
Damaged code data reads as libtiff's fax decoder reads it for PIL (C.14;
``tests/test_torch_port_ccitt_damage.py``): a file PIL refuses is corrupt
(a zero image with a warning)."""

import io
import logging
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative
from test_torch_port_decode import (SETTINGS, assert_port_reads_as_pil, layout_tags, pil_gray,
                                    pixels, tiff_file)
from torch_port_libtiff import assert_reads_as_libtiff

# Compression name and T4Options of each coding PIL writes.
CODINGS = {"mh": ("tiff_ccitt", None), "t4_1d": ("group3", None),
           "t4_1d_fill": ("group3", 4), "t4_2d": ("group3", 1), "t4_2d_fill": ("group3", 5),
           "t6": ("group4", None)}


def page(rs, h: int, w: int, kind: str) -> np.ndarray:
    """A bilevel page (True = white): noise, a blank or black sheet, or
    strokes of varied run lengths on white."""
    if kind == "white":
        return np.ones((h, w), bool)
    if kind == "black":
        return np.zeros((h, w), bool)
    if kind == "noise":
        return rs.rand(h, w) > rs.uniform(0.1, 0.9)
    a = np.ones((h, w), bool)
    for _ in range(rs.randint(1, 30)):
        y, x = rs.randint(0, h), rs.randint(0, w)
        a[y:y + rs.randint(1, 6), x:x + rs.randint(1, max(2, w // 2))] = False
    return a


def ccitt_bytes(img: np.ndarray, coding: str, rows_per_strip=None) -> bytes:
    compression, t4 = CODINGS[coding]
    info = {} if t4 is None else {292: t4}
    if rows_per_strip:
        info[278] = rows_per_strip
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", compression=compression, tiffinfo=info)
    return buf.getvalue()


def ifd_entries(data: bytes):
    """{tag: (entry offset, type, count, values)} of a little-endian TIFF's
    first IFD (PIL writes little-endian)."""
    assert data[:2] == b"II"
    ifd = struct.unpack_from("<I", data, 4)[0]
    out = {}
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        e = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack_from("<HHI", data, e)
        size = {3: 2, 4: 4}.get(typ, 1) * count
        at = e + 8 if size <= 4 else struct.unpack_from("<I", data, e + 8)[0]
        fmt = {3: "H", 4: "I"}.get(typ, "B")
        out[tag] = (e, typ, count, list(struct.unpack_from(f"<{count}{fmt}", data, at)))
    return out


def patch_tag(data: bytes, tag: int, value: int) -> bytes:
    """The file with one single-valued SHORT or LONG tag set to ``value``."""
    e, typ, count, _ = ifd_entries(data)[tag]
    assert count == 1
    out = bytearray(data)
    struct.pack_into("<H" if typ == 3 else "<I", out, e + 8, value)
    return bytes(out)


def strips(data: bytes):
    tags = ifd_entries(data)
    return [data[o:o + n] for o, n in zip(tags[273][3], tags[279][3])]


def wrap(w: int, h: int, blobs, compression: int, extra=(), tile=None) -> bytes:
    """A little-endian bilevel TIFF of coded ``blobs``: strips of all rows,
    or tiles of ``tile`` = (tw, th); ``extra`` more (tag, type, value)."""
    tags = [(258, 3, [1]), (259, 3, [compression]), (262, 3, [1]), (277, 3, [1])]
    tags += layout_tags(tile, None, h) + [(t, typ, [v]) for t, typ, v in extra]
    return tiff_file(w, h, blobs, tags)


def pil_l(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L"))


# -- every coding against PIL -------------------------------------------------

WIDTHS = st.one_of(st.integers(1, 40), st.sampled_from([1, 8, 63, 64, 65, 1728, 1729, 2560,
                                                         2561, 2625, 4000]))


@pytest.mark.parametrize("coding", sorted(CODINGS))
@settings(max_examples=30, **SETTINGS)
@given(h=st.integers(1, 24), w=WIDTHS, kind=st.sampled_from(["noise", "white", "black",
                                                             "strokes"]),
       strip=st.integers(0, 24), invert=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_ccitt_coding_matches_pil(tmp_path, coding, h, w, kind, strip, invert, seed):
    """``strip`` 0: one strip, else that many rows a strip; ``invert``
    patches PhotometricInterpretation to 0 (WhiteIsZero), which PIL reads
    inverted."""
    data = ccitt_bytes(page(np.random.RandomState(seed), h, w, kind), coding, strip or None)
    if invert:
        data = patch_tag(data, 262, 0)
    path = tmp_path / f"{coding}.tif"
    path.write_bytes(data)
    assert_port_reads_as_pil(path)


def test_page_sized_group4_and_every_coding_of_one_scan(tmp_path):
    """A signature page at 1200 x 500 in every coding, several strips."""
    rs = np.random.RandomState(11)
    scan = pixels(rs, (500, 1200)).astype(np.uint8) > 120
    for coding in CODINGS:
        path = tmp_path / f"{coding}.tif"
        path.write_bytes(ccitt_bytes(scan, coding, rows_per_strip=128))
        assert len(strips(path.read_bytes())) == 4
        assert_port_reads_as_pil(path)


def test_pil_writes_the_codings_it_is_asked_for():
    """The files above carry what they are named for: the compression,
    the T4Options, several strips and photometric 1."""
    img = page(np.random.RandomState(1), 10, 30, "strokes")
    for coding, (name, t4) in CODINGS.items():
        tags = ifd_entries(ccitt_bytes(img, coding, rows_per_strip=4))
        assert tags[259][3] == [{"tiff_ccitt": 2, "group3": 3, "group4": 4}[name]]
        assert tags[262][3] == [1] and len(tags[273][3]) == 3
        assert tags.get(292, (0, 0, 0, [None]))[3] == [t4]


# -- what stays refused, what is corrupt --------------------------------------

def refused_files():
    """{name: (bytes, what the message named)}: kinds PIL reads that the
    port refused before, uncompressed mode (read since A.6.15), tiles (since
    A.6.16) and FillOrder 2 (since A.6.10)."""
    img = page(np.random.RandomState(2), 32, 40, "strokes")
    g4 = ccitt_bytes(img, "t6")
    t4 = ccitt_bytes(img, "t4_2d")
    # FillOrder 2: the same code with each byte's bits reversed.
    rev = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
    (strip,) = strips(g4)
    fill2 = wrap(40, 32, [strip.translate(rev)], 4, extra=[(266, 3, 2)])
    padded = np.ones((32, 48), bool)
    padded[:, :40] = img
    tiles = [strips(ccitt_bytes(padded[y:y + 16, x:x + 16].copy(), "t6"))[0]
             for y in (0, 16) for x in (0, 16, 32)]
    return {"t4_uncompressed": (patch_tag(t4, 292, 3), "uncompressed mode"),
            "t6_uncompressed": (wrap(40, 32, strips(g4), 4, extra=[(293, 4, 2)]),
                                "uncompressed mode"),
            "tiles": (wrap(40, 32, tiles, 4, tile=(16, 16)), "in tiles"),
            "fill_order_2": (fill2, "FillOrder 2")}, img


@pytest.mark.parametrize("name", ["t4_uncompressed", "t6_uncompressed", "tiles"])
def test_formerly_refused_kinds_read_as_pil(tmp_path, name):
    """Uncompressed mode's tag bit (A.6.15) and CCITT in tiles (A.6.16),
    which the port refused naming A.6: PIL reads each as the page, and so
    does the port, as the JAX package through ``decode_image``."""
    files, img = refused_files()
    data, _ = files[name]
    want = np.where(img, 255, 0).astype(np.uint8)
    np.testing.assert_array_equal(pil_l(data), want)              # PIL reads it
    np.testing.assert_array_equal(tnative.decode(data), want)
    path = tmp_path / f"{name}.tif"
    path.write_bytes(data)
    assert_port_reads_as_pil(path)


def test_group4_with_fill_order_2_reads_as_pil(tmp_path):
    """FillOrder 2 (A.6.10): libtiff reverses each byte's bits before its
    fax decoder, and the port does as well; refused before."""
    files, img = refused_files()
    data, _ = files["fill_order_2"]
    np.testing.assert_array_equal(pil_l(data), np.where(img, 255, 0).astype(np.uint8))
    path = tmp_path / "fill_order_2.tif"
    path.write_bytes(data)
    assert_port_reads_as_pil(path)


def damaged_file(damage: str) -> bytes:
    """A 50 x 20 page's strip, damaged: ``cut_strip`` (its byte count cut
    to a third), ``garbage`` (an EOL then zeros), ``eol_missing`` (T.4 1-D
    rows of 1 bits, no EOL to find), ``too_long`` (horizontal mode "001",
    white 64 + 0 ("11011" "00110101"), black 0: past the 50 px)."""
    img = page(np.random.RandomState(3), 20, 50, "strokes")
    data = ccitt_bytes(img, "t4_1d" if damage == "eol_missing" else "t6")
    (strip,) = strips(data)
    if damage == "cut_strip":
        return patch_tag(data, 279, len(strip) // 3)
    if damage == "garbage":
        return wrap(50, 20, [b"\x00\x01" + bytes(len(strip))], 4)
    if damage == "eol_missing":
        return wrap(50, 20, [b"\xff" * len(strip)], 3)
    return wrap(50, 20, [int("00111011001101010000110111".ljust(32, "0"), 2).to_bytes(4, "big")], 4)


@pytest.mark.parametrize("damage,message", [
    ("garbage", "CCITT Group 4 strip that ends in its first row"),
])
def test_bad_code_data_is_a_corrupt_file(tmp_path, caplog, damage, message):
    """A Group 4 strip whose first row meets an EOL fails in libtiff's
    decoder, and PIL refuses the file: a zero image, as in the JAX package."""
    data = damaged_file(damage)
    with pytest.raises(ValueError, match=message):
        tnative.decode(data)
    with pytest.raises(OSError):
        pil_l(data)
    path = tmp_path / f"{damage}.tif"
    path.write_bytes(data)
    with caplog.at_level(logging.WARNING):
        out = tdataset.decode_image(path, 16)
    assert out.shape == (16, 16, 1) and not out.any()
    assert "using zero image" in caplog.text
    np.testing.assert_array_equal(jdataset.decode_image(path, 16), out)


@pytest.mark.parametrize("damage", ["cut_strip", "eol_missing", "too_long"])
def test_damaged_code_data_reads_as_pil(tmp_path, damage):
    """Damaged fax data that PIL reads (C.14): libtiff's decoder ends a bad
    row in the colour it reached and goes on (T.4 without EOLs is read from
    the strip's first bit; Group 4 keeps the rows before a fault). The rows
    a Group 4 strip did not reach (``cut_strip`` after row 10, ``too_long``
    after row 1) are PIL's uncleared strip buffer, which differs from run to
    run: there the port gives its cleared buffer's rows, and is held to PIL
    and to the JAX package on the rows libtiff wrote; ``eol_missing`` is
    written whole and held whole."""
    data = damaged_file(damage)
    path = tmp_path / f"{damage}.tif"
    path.write_bytes(data)
    grey, written = assert_reads_as_libtiff(data, tmp_path, reads=True)
    rows = written.all(axis=1)
    assert rows.sum() == {"cut_strip": 11, "eol_missing": 20, "too_long": 2}[damage]
    np.testing.assert_array_equal(pil_gray(path)[rows], tdataset.decode_gray(path)[rows])
    if rows.all():
        assert_port_reads_as_pil(path)


def test_dataset_over_a_mixed_tree_matches_jax(tmp_path, monkeypatch):
    """CCITT scans of every coding beside PNG and LZW TIFF scans:
    ``SignatureDataset`` bit-equal with the JAX package's (its native
    decoder off, as in ``test_torch_port_decode.py``)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    rs = np.random.RandomState(4)
    for wi in range(2):
        d = tmp_path / f"writer{wi}"
        d.mkdir()
        for k, coding in enumerate(sorted(CODINGS)):
            scan = pixels(rs, (40 + 5 * k, 90 - 4 * k)).astype(np.uint8)
            (d / f"w{wi}_{k}.tif").write_bytes(ccitt_bytes(scan > 128, coding, 16))
        Image.fromarray(pixels(rs, (30, 70)).astype(np.uint8)).save(d / f"w{wi}_png.png")
        Image.fromarray(pixels(rs, (35, 60)).astype(np.uint8)).save(
            d / f"w{wi}_lzw.tif", compression="tiff_lzw")
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 16
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.writer_labels()[0], j.writer_labels()[0])
