"""TIFF number formats (ROADMAP A.6.4) against PIL, through the JAX
package: grey samples of 12 bits, signed 16 and 32 bits, unsigned 32 bits
and 32-bit IEEE floats, uncompressed, Deflate (with predictor 2, and the
floating-point predictor 3 on floats), PackBits and LZW (PIL's libtiff
writer), in strips and tiles. Each reads as PIL's ``convert("L")`` of its
mode: I;12 and I;16S clip, I and I;32N (a uint32 read as an int32) clip to
0 .. 255, F clips and truncates, NaN is 0. libtiff hands PIL a compressed
file's 16- and 32-bit samples in the host's byte order and PIL reads them
in the file's, so a big-endian compressed file's samples come out
byte-swapped; the port reads them so too. A float of 16 or 64 bits has no
PIL mode: a zero image (C.10)."""

import io
import zlib

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset

# The edges of each mode's convert("L"): clip, truncation, NaN, infinities.
FLOAT_EDGES = [-3.7, -0.0, 0.0, 0.5, 0.99999, 1.0, 1.5, 127.99, 254.5, 254.9999, 255.0, 255.4,
               300.0, 1e10, -1e10, 2.0 ** -140, np.nan, np.inf, -np.inf]
INT_EDGES = [-(2 ** 31), -70000, -256, -1, 0, 1, 2, 254, 255, 256, 70000, 2 ** 31 - 1]

FORMATS = {  # name: (dtype, SampleFormat, edge values)
    "float32": ("f4", 3, FLOAT_EDGES), "int32": ("i4", 2, INT_EDGES),
    "uint32": ("u4", 1, [0, 1, 254, 255, 256, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]),
    "int16": ("i2", 2, [-32768, -256, -1, 0, 1, 254, 255, 256, 32767]),
}


def samples(name: str, h: int, w: int, seed: int) -> np.ndarray:
    """Stroke-like values spread past 0 .. 255, with the mode's edge values
    in the first row."""
    dtype, _, edges = FORMATS[name]
    rs = np.random.RandomState(seed)
    v = (pixels(rs, (h, w)).astype(np.float64) - 60) * 1.7 + rs.rand(h, w)
    v = v.astype(dtype) if dtype == "f4" else np.round(v).astype(dtype)
    flat = v.reshape(-1)
    n = min(len(edges), flat.size)
    flat[:n] = np.array(edges[:n]).astype(dtype)
    return v


# Every format in either byte order (no big-endian uint32: PIL has no mode,
# a zero image below), each coding; predictor 3 on floats only (on integers
# PIL refuses: test_torch_port_refusals).
CASES = [(name, order, coding) for name in sorted(FORMATS) for order in "<>"
         for coding in ("raw", "deflate", "deflate_pred2", "deflate_pred3", "deflate_strips")
         if (coding != "deflate_pred3" or name == "float32")
         and not (name == "uint32" and order == ">")]


@pytest.mark.parametrize("name,order,coding", CASES)
def test_number_tiff_matches_pil(tmp_path, name, order, coding):
    dtype, fmt, _ = FORMATS[name]
    v = samples(name, 13, 22, seed=len(coding))
    data = chip_smoke.tiff_numbers(
        v, order + dtype, fmt, compression=1 if coding == "raw" else 8,
        predictor=3 if coding.endswith("pred3") else 2 if coding.endswith("pred2") else 1,
        rows_per_strip=4 if coding == "deflate_strips" else 0)
    (tmp_path / "n.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "n.tif")


@pytest.mark.parametrize("coding", ["raw", "deflate", "deflate_strips"])
@pytest.mark.parametrize("w", [5, 6, 22])
def test_12_bit_grey_matches_pil(tmp_path, coding, w):
    """12-bit grey (PIL's I;12, little-endian only), two samples in three
    bytes MSB first, odd widths padding their rows to a byte."""
    v = np.random.RandomState(w).randint(0, 4096, (9, w))
    v[0, :5] = [0, 1, 255, 256, 4095][:w]
    data = chip_smoke.tiff_numbers(v, "12", 1, compression=1 if coding == "raw" else 8,
                                   rows_per_strip=4 if coding == "deflate_strips" else 0)
    (tmp_path / "g12.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "g12.tif")


@pytest.mark.parametrize("mode,compression,predictor", [
    ("F", "tiff_lzw", 1), ("F", "tiff_lzw", 2), ("F", "tiff_lzw", 3), ("F", "packbits", 1),
    ("F", "tiff_adobe_deflate", 3), ("I", "tiff_lzw", 1), ("I", "tiff_lzw", 2),
    ("I", "packbits", 1), ("I", "tiff_adobe_deflate", 2)])
def test_pil_written_number_tiff_matches_pil(tmp_path, mode, compression, predictor):
    """PIL's own writer (libtiff: LZW, PackBits, Deflate; the tag says the
    predictor, which libtiff applies under LZW and Deflate only)."""
    v = samples("float32" if mode == "F" else "int32", 17, 23, seed=predictor)
    Image.fromarray(v, mode).save(tmp_path / "p.tif", "TIFF", compression=compression,
                                  tiffinfo={317: predictor})
    with Image.open(tmp_path / "p.tif") as im:
        assert im.tag_v2[317] == predictor
    assert_port_reads_as_pil(tmp_path / "p.tif")


def test_number_tiles_and_white_is_zero_match_pil(tmp_path):
    """Tiles (padded past the image) and a float WhiteIsZero file (PIL's F,
    not inverted)."""
    v = samples("float32", 10, 12, seed=3)
    tile = np.zeros((16, 16), "<f4")
    tile[:10, :12] = v
    raw = tile.tobytes()
    data = chip_smoke.tiff_pack(12, 10, [raw], [
        (258, 3, [32]), (259, 3, [1]), (262, 3, [1]), (277, 3, [1]), (322, 3, [16]),
        (323, 3, [16]), (324, 4, lambda o: o), (325, 4, [len(raw)]), (339, 3, [3])])
    (tmp_path / "tiles.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "tiles.tif")
    photometric_1 = bytes([0x06, 0x01, 0x03, 0, 1, 0, 0, 0, 1, 0])  # tag 262, SHORT, 1, 1
    data = chip_smoke.tiff_numbers(v, "<f4", 3).replace(photometric_1, photometric_1[:8] + b"\0\0")
    (tmp_path / "wiz.tif").write_bytes(data)
    with Image.open(tmp_path / "wiz.tif") as im:
        assert im.tag_v2[262] == 0 and im.mode == "F"
    assert_port_reads_as_pil(tmp_path / "wiz.tif")


@pytest.mark.parametrize("kind,what", [("float16", "without a PIL mode"),
                                       ("float64", "without a PIL mode"),
                                       ("uint32_be", "without a PIL mode"),
                                       ("grey12_predictor2", "predictor 2 with 12-bit")])
def test_number_kind_pil_refuses_is_a_zero_image(tmp_path, kind, what):
    """No PIL mode (16- and 64-bit floats, big-endian uint32), or libtiff's
    refusal (predictor 2 on 12-bit samples)."""
    v = samples("int16", 6, 7, seed=1)
    data = {"float16": lambda: chip_smoke.tiff_numbers(v, "<f2", 3),
            "float64": lambda: chip_smoke.tiff_numbers(v, "<f8", 3),
            "uint32_be": lambda: chip_smoke.tiff_numbers(np.abs(v), ">u4", 1),
            "grey12_predictor2": lambda: chip_smoke.tiff_numbers(np.abs(v), "12", 1,
                                                                 compression=8, predictor=2),
            }[kind]()
    path = tmp_path / f"{kind}.tif"
    path.write_bytes(data)
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.convert("L")
    np.testing.assert_array_equal(tdataset.decode_image(path, 16), jdataset.decode_image(path, 16))
    with pytest.raises(ValueError, match=what):
        tdataset.decode_gray(path)


def test_float_page_of_the_smoke_is_pils(tmp_path):
    """``chip_smoke.tiff_numbers``' float page layout (phase 12: a scan's
    grey as float32, Deflate strips, predictor 3), at a small size: PIL's
    grey, which is the grey it was written from."""
    grey = pixels(np.random.RandomState(4), (60, 90)).astype(np.uint8)
    data = chip_smoke.tiff_numbers(grey.astype(np.float32), "<f4", 3, rows_per_strip=16,
                                   compression=8, predictor=3)
    (tmp_path / "page.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "page.tif")
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("L")), grey)


@pytest.mark.parametrize("damage", ["adler", "adler_cut", "second_block_type", "clean_junk"])
def test_deflate_reads_on_after_the_strip_is_whole(tmp_path, damage):
    """C.13: once a strip is whole, zlib still reads what it can without
    room for output, the Adler-32 after the last block among it, so a bad
    check (or a bad block after the data) fails libtiff and PIL; a check
    cut off, or bytes after a good one, do not."""
    grey = pixels(np.random.RandomState(2), (12, 20)).astype(np.uint8)
    z = zlib.compress(grey.tobytes(), 6)
    co = zlib.compressobj(6)
    split = co.compress(grey.tobytes()) + co.flush(zlib.Z_FULL_FLUSH)   # the data, then an empty
    stream = {"adler": z[:-1] + bytes([z[-1] ^ 1]), "adler_cut": z[:-2],    # stored block
              "second_block_type": split + b"\x07", "clean_junk": z + b"junk"}[damage]
    data = chip_smoke.tiff_pack(20, 12, [stream], [
        (258, 3, [8]), (259, 3, [8]), (262, 3, [1]), (273, 4, lambda o: o), (277, 3, [1]),
        (278, 4, [12]), (279, 4, [len(stream)])])
    path = tmp_path / f"{damage}.tif"
    path.write_bytes(data)
    if damage in ("adler", "second_block_type"):
        with pytest.raises(Exception):
            with Image.open(path) as im:
                im.convert("L")
        with pytest.raises(ValueError, match="Deflate"):
            tdataset.decode_gray(path)
        np.testing.assert_array_equal(tdataset.decode_image(path, 16),
                                      jdataset.decode_image(path, 16))
    else:
        assert_port_reads_as_pil(path)
