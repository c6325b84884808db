"""FITS (A.6.60) in the port's host decoder (``decode.cpp``: ``fits_open``,
``decode_fits``, ``gunzip``), bit-equal with PIL's
``Image.open(path).convert("L")`` (Pillow 12.1.0) and with the JAX
package's ``decode_image``. Pillow's FitsImagePlugin, not the format's
specification: 80-byte cards to END, headers after the first read past,
the tile where the first card of data started; BITPIX 8 L, 16 I;16, 32 I,
-32 and -64 F, each read in the raw mode of its mode (little-endian, -64
as float32), the bottom row first, with no BSCALE or BZERO; NAXIS 1 a
1 x NAXIS1 image; the GZIP_1 tile-compressed route (``fits_gzip``:
Python's gzip.decompress of the rest of the file, the last bytes of each
4-byte sample). Files are ``chip_smoke.py``'s ``fits_file``,
``fits_gzip_file`` and ``fits_cards`` (Pillow writes no FITS)."""

import gzip

import numpy as np
import pytest
from test_torch_port_plain_headers import reads, refused
from torch_port_header_cases import BASES, fits_values
from torch_port_raster_cases import image, probe

import chip_smoke as cs


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
@pytest.mark.parametrize("big_endian", [True, False])
@pytest.mark.parametrize("size", [(5, 7), (1, 1), (40, 3), (3, 300)])
def test_fits_reads_as_pil(tmp_path, bitpix, big_endian, size):
    """Each BITPIX, either byte order (PIL reads both as little-endian),
    values past 0 .. 255, NaN and infinities: I;16 255 where its high byte
    is set, I clipped, F clipped and truncated; under .fits and .png."""
    reads(tmp_path, cs.fits_file(fits_values(*size, bitpix), bitpix, big_endian), ("f.fits", "f.png"))


def test_fits_bzero_and_bscale_are_not_applied(tmp_path):
    """A 16-bit ramp written big-endian with BZERO 32768 (the format's
    unsigned 16 bits): PIL applies neither card and reads the samples
    little-endian, and so does the port."""
    ramp = (np.arange(54).reshape(6, 9) * 1000).astype(np.int64) - 32768
    reads(tmp_path, cs.fits_file(ramp, 16, cards=[("BZERO", 32768), ("BSCALE", 1)]))


def test_fits_naxis_1_is_one_column(tmp_path):
    """NAXIS 1: PIL's size (1, NAXIS1), a 1-pixel-wide image."""
    data = cs.fits_cards([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 1), ("NAXIS1", 9)])
    reads(tmp_path, data + image(1, 9).tobytes() + bytes(2871))


def extension_after(bitpix: int) -> bytes:
    img = cs.fits_file(fits_values(4, 6, bitpix), bitpix)
    ext = cs.fits_cards([("XTENSION", "'IMAGE   '"), ("BITPIX", 16), ("NAXIS", 2), ("NAXIS1", 3),
                         ("NAXIS2", 2)])
    return img[:2880] + ext + img[2880:]


@pytest.mark.parametrize("bitpix", [8, 16, 32])
def test_fits_extension_headers_are_read_past(tmp_path, bitpix):
    """An extension header between the primary header and its data (PIL
    reads past it once the primary header gave a decoder: the data starts
    after it)."""
    reads(tmp_path, extension_after(bitpix))


def cards(*extra, naxis=((2, 7), (5,)), data=True) -> bytes:
    head = [("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", naxis[0][0]), ("NAXIS1", naxis[0][1]),
            ("NAXIS2", naxis[1][0]), *extra]
    body = cs.fits_cards(head)
    return body + (image(5, 7).tobytes() + bytes(2880 - 35) if data else b"")


FITS_CASES = {
    # name: (bytes, what PIL does)
    "naxis_0": (lambda: cs.fits_cards([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)]) + bytes(2880),
                "refused"),                                                          # No image data
    "header_cut": (lambda: cards()[:400], "refused"),                                 # Truncated FITS file
    "no_data": (lambda: cards(data=False), "refused"),                                # Truncated after END
    "simple_f": (lambda: cards().replace(b"= " + b" " * 19 + b"T", b"= " + b" " * 19 + b"F", 1), "passed"),
    "bitpix_24": (lambda: cards(("BITPIX", 24)), "passed"),                           # no mode
    "naxis1_not_a_number": (lambda: cards(("NAXIS1", "'seven'")), "refused"),
    "no_naxis2": (lambda: cs.fits_cards([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 7)])
                  + bytes(2880), "passed"),                                           # KeyError
    "naxis1_0": (lambda: cards(("NAXIS1", 0)), "passed"),
    "value_comment": (lambda: cards(("NAXIS1", "7 / the width")), "read"),
    "data_of_54_bytes": (lambda: cards(data=False) + image(6, 9).tobytes(), "read"),  # tile from the read's end - 80
    "data_of_35_bytes": (lambda: cards(data=False) + image(5, 7).tobytes(), "read"),   # from 45 bytes before
    "bomb": (lambda: cards(("NAXIS1", 10 ** 5), ("NAXIS2", 10 ** 5)), "refused"),
    "float_short": (lambda: cs.fits_file(fits_values(5, 7, -32), -32)[:2880 + 139], "refused"),
    "int_short": (lambda: cs.fits_file(fits_values(5, 7, 32), 32)[:2880 + 139], "refused"),
    "i16_short": (lambda: cs.fits_file(fits_values(6, 7, 16), 16)[:2880 + 83], "refused"),
    "i16_short_of_a_card": (lambda: cs.fits_file(fits_values(5, 7, 16), 16)[:2880 + 69], "read"),
}


@pytest.mark.parametrize("case", sorted(FITS_CASES))
def test_fits_header_rules_as_pil(tmp_path, case):
    """NAXIS 0 refused (No image data), a header or data unit cut short
    refused (Truncated FITS file), a first card other than SIMPLE = T
    passed on, a BITPIX without a mode passed on, int() of a value that is
    no number refused, a card missing passed on (KeyError), no size passed
    on; a value's comment after '/'; data shorter than a card shifts the
    tile (it starts 80 bytes before the read's end); every pixel, mapped
    (L, I;16) or through the raw decoder (I, F), or the file refused."""
    make, want = FITS_CASES[case]
    data = make()
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


@pytest.mark.parametrize("zbitpix", [8, 16, 32])
@pytest.mark.parametrize("size", [(5, 7), (1, 1), (30, 4)])
def test_fits_gzip_reads_as_pil(tmp_path, zbitpix, size):
    """fits_gzip: the last 1, 2 or 4 bytes of each 4-byte sample in the
    mode's raw mode (I;16 little-endian), the rows reversed."""
    v = fits_values(*size, 16 if zbitpix == 8 else zbitpix)
    reads(tmp_path, cs.fits_gzip_file(v, zbitpix), ("f.fits", "f.png"))


def gzip_file(heap: bytes, table: int = 8, **cards) -> bytes:
    head = {"ZIMAGE": "T", "ZCMPTYPE": "'GZIP_1  '", "ZBITPIX": 8, "ZNAXIS": 2, "ZNAXIS1": 7, "ZNAXIS2": 5,
            **cards}
    primary = cs.fits_cards([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)])
    ext = cs.fits_cards([("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", table),
                         ("NAXIS2", 1), *[(k, v) for k, v in head.items() if v is not None]])
    data = bytes(range(7, 7 + table)) + heap
    return primary + ext + data + bytes(-len(data) % 2880)


def samples(n: int = 35) -> bytes:
    return (image(5, 7).astype(">i4")).tobytes()[:4 * n]


GZIP_CASES = {
    "two_members": (lambda: gzip_file(gzip.compress(samples()[:60]) + gzip.compress(samples()[60:])), "read"),
    "members_with_nul_between": (lambda: gzip_file(gzip.compress(samples()[:60]) + bytes(5)
                                                    + gzip.compress(samples()[60:])), "read"),
    "file_name_field": (lambda: gzip_file(b"\x1f\x8b\x08\x08" + bytes(6) + b"name\0"
                                          + gzip.compress(samples())[10:]), "read"),
    "extra_samples": (lambda: gzip_file(gzip.compress(samples() + bytes(40))), "read"),
    "too_few_samples": (lambda: gzip_file(gzip.compress(samples(34))), "refused"),
    "crc_wrong": (lambda: (lambda z: gzip_file(z[:-8] + bytes([z[-8] ^ 1]) + z[-7:]))(gzip.compress(samples())),
                  "refused"),
    "stream_cut": (lambda: gzip_file(gzip.compress(samples())[:-12]), "refused"),
    "junk_after": (lambda: gzip_file(gzip.compress(samples()) + b"\x01junk"), "refused"),
    "stored_block": (lambda: gzip_file(gzip.compress(samples(), 0)), "read"),
    "zbitpix_minus_32": (lambda: gzip_file(gzip.compress(samples()), ZBITPIX=-32), "refused"),
    "no_zcmptype": (lambda: gzip_file(gzip.compress(samples()), ZCMPTYPE=None), "passed"),   # KeyError
    "rice": (lambda: gzip_file(gzip.compress(samples()), ZCMPTYPE="'RICE_1  '"), "read"),     # the raw table
    "no_znaxis": (lambda: gzip_file(gzip.compress(samples()), ZNAXIS=None), "passed"),
    "table_of_12": (lambda: gzip_file(gzip.compress(samples()), table=12), "read"),
}


@pytest.mark.parametrize("case", sorted(GZIP_CASES))
def test_fits_gzip_rules_as_pil(tmp_path, case):
    """gzip.decompress's members (NUL bytes between them, a name field, a
    stored block), CRC and length checked, data after the last member
    refused; too few samples, or none (a negative ZBITPIX), refused; no
    ZCMPTYPE or ZNAXIS passed on (KeyError); another ZCMPTYPE read as a
    raw image of the table (its NAXIS and BITPIX)."""
    make, want = GZIP_CASES[case]
    data = make()
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


@pytest.mark.parametrize("route", ["FITS-RAW", "FITS-GZIP"])
@pytest.mark.parametrize("part", range(2))
def test_damaged_files_read_as_pil(tmp_path, route, part):
    """The probe (``scripts/raster_probe.py``), 100 files a part."""
    counts = probe(tmp_path / "f.png", BASES[route](), 600 + part, 100)
    assert counts.get("FITS", [0, 0])[0] > 0 and sum(c[1] for c in counts.values()) > 0
