"""IPTC/NAA (A.6.61) and Photo CD (A.6.63) in the port's host decoder
(``decode.cpp``: ``iptc_open``, ``decode_iptc``, ``decode_pcd``),
bit-equal with PIL's ``Image.open(path).convert("L")`` (Pillow 12.1.0)
and with the JAX package's ``decode_image``.

IPTC: IptcImagePlugin's fields (lengths, records, a tag given twice), its
mode, size and compression, and ``load()``: the image records' data
joined (raw after a PGM header) and opened again, a JPEG or that PGM,
alone (mode L) or as one band of an RGB or CMYK merge with zero bands. An
image whose mode convert("L") keeps (an RGB JPEG under mode L) and a
format the port does not read out of such a buffer (a PNG) raise naming
them (A.6). PCD: the base image's rows and chroma as PcdDecode.c pairs
them, PhotoYCC through the tables of Pillow's YCC;P unpacker (held
exhaustively by ``scripts/pcd_ycc_check.py``; here a seeded sample), the
orientations' rotations."""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil
from test_torch_port_plain_headers import reads, refused
from torch_port_header_cases import BASES, jpeg, verdict
from torch_port_raster_cases import image, probe

import chip_smoke as cs
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.infer.export import encode_png

G = image(8, 12)
J = jpeg(G)


@pytest.mark.parametrize("piece", [7, 96, 30000])
@pytest.mark.parametrize("compression", [1, 5])
def test_iptc_grey_reads_as_pil(tmp_path, piece, compression):
    """Raw grey (a PGM header before the joined data) and a grey JPEG, in
    one image record or split over many, under .iptc and .png names."""
    data = cs.iptc_file(12, 8, G.tobytes() if compression == 1 else J, compression=compression, piece=piece)
    reads(tmp_path, data, ("f.iptc", "f.png"))


@pytest.mark.parametrize("layers", [3, 4])
@pytest.mark.parametrize("band", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("compression", [1, 5])
def test_iptc_band_reads_as_pil(tmp_path, layers, band, compression):
    """A grey image as one band of RGB (3 layers) or CMYK (4), the others
    zero: 3:65 gives the band + 1 (none: the first; 0: the last, Python's
    index -1), then convert("L")."""
    data = cs.iptc_file(12, 8, G.tobytes() if compression == 1 else J, layers=layers, component=1,
                        compression=compression, band=band)
    if band is not None and band > layers:
        refused(tmp_path, data)
    else:
        reads(tmp_path, data)


def test_iptc_long_fields_read_as_pil(tmp_path):
    """A field whose length byte is 129 .. 132 takes that many minus 128
    bytes of length after its five (a page-sized record)."""
    g = image(200, 300)
    reads(tmp_path, cs.iptc_file(300, 200, g.tobytes(), piece=10 ** 6))


def fields(*recs, image_data=G.tobytes()) -> bytes:
    return b"".join(cs.iptc_record(*r) if isinstance(r, tuple) else r for r in recs) + (
        cs.iptc_record(8, 10, image_data) if image_data is not None else b"")


STD = ((3, 60, b"\x01\x00"), (3, 20, struct.pack(">I", 12)), (3, 30, struct.pack(">I", 8)),
       (3, 120, struct.pack(">I", 1)))

IPTC_CASES = {
    # name: (bytes, what PIL does)
    "no_3_60": (lambda: fields(*STD[1:]), "passed"),                       # KeyError
    "3_60_empty": (lambda: fields((3, 60, b""), *STD[1:]), "passed"),       # None: TypeError
    "3_60_one_byte": (lambda: fields((3, 60, b"\x01"), *STD[1:]), "passed"),
    "3_60_twice": (lambda: fields(STD[0], *STD), "passed"),                 # a list: no mode
    "3_60_twice_no_compression": (lambda: fields(STD[0], *STD[:3]), "refused"),
    "layers_2": (lambda: fields((3, 60, b"\x02\x01"), *STD[1:]), "passed"),
    "no_width": (lambda: fields(STD[0], *STD[2:]), "passed"),
    "width_0": (lambda: fields(STD[0], (3, 20, b"\0\0"), *STD[2:]), "passed"),
    "width_of_6_bytes": (lambda: fields(STD[0], (3, 20, b"\xff\xff\0\0\0\x0c"), *STD[2:]), "read"),
    "no_compression": (lambda: fields(*STD[:3]), "refused"),                # KeyError -> OSError
    "compression_2": (lambda: fields(*STD[:3], (3, 120, b"\x02")), "refused"),
    "compression_twice": (lambda: fields(*STD, STD[3]), "passed"),           # TypeError
    "length_byte_133": (lambda: b"\x1c\x02\x05\x85\x00" + fields(*STD), "refused"),
    "length_byte_128": (lambda: b"\x1c\x02\x05\x80\x00" + fields(*STD), "read"),
    "length_byte_130": (lambda: b"\x1c\x02\x05\x82\x00\x00\x03abc" + fields(*STD), "read"),
    "record_10": (lambda: b"\x1c\x0a\x05\x00\x01a" + fields(*STD), "passed"),
    "no_image_record": (lambda: fields(*STD, image_data=None), "refused"),   # no tile
    "field_after_the_image": (lambda: fields(*STD) + cs.iptc_record(2, 5, b"title"), "read"),
    "nul_after_the_image": (lambda: fields(*STD) + bytes(9), "read"),
    "junk_after_the_image": (lambda: fields(*STD) + b"junk!", "refused"),
    "raw_short": (lambda: fields(*STD, image_data=G.tobytes()[:-1]), "refused"),
    "raw_long": (lambda: fields(*STD, image_data=G.tobytes() + b"more"), "read"),
    "jpeg_not_an_image": (lambda: fields(*STD[:3], (3, 120, b"\x05"), image_data=b"\x00" * 40), "refused"),
    "jpeg_cut": (lambda: fields(*STD[:3], (3, 120, b"\x05"), image_data=J[:len(J) // 2]), "refused"),
    "jpeg_of_another_size": (lambda: fields(*STD[:3], (3, 120, b"\x05"), image_data=jpeg(image(5, 7))), "read"),
    "band_past_rgb": (lambda: fields((3, 60, b"\x03\x01"), *STD[1:], (3, 65, b"\x05")), "refused"),
    "bomb": (lambda: fields(STD[0], (3, 20, struct.pack(">I", 10 ** 5)), (3, 30, struct.pack(">I", 10 ** 5)),
                            STD[3]), "refused"),
}


@pytest.mark.parametrize("case", sorted(IPTC_CASES))
def test_iptc_field_rules_as_pil(tmp_path, case):
    """No 3:60 (measured: UnidentifiedImageError), its data missing or too
    short, a tag given twice (a list: no mode, or a TypeError), no size:
    passed on; no compression or an unknown one, a length byte past 132,
    no image record, a field PIL cannot read after the image data, data
    PIL cannot open, a band past the bands: refused; a length byte of 128
    (no data) or 129 .. 132; an image of its own size (the inner image's)."""
    make, want = IPTC_CASES[case]
    data = make()
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


@pytest.mark.parametrize("mode", ["RGB", "CMYK"])
def test_iptc_colour_jpeg_under_mode_l_raises_naming_it(tmp_path, mode):
    """Mode L (layers 1) holding a colour JPEG: PIL's convert("L") keeps the
    JPEG's own mode (the image is copied, not converted), so the JAX
    package gets no grey; the port raises naming the case and A.6. As a
    band of RGB it is refused (PIL's merge takes single-band images)."""
    b = io.BytesIO()
    Image.fromarray(image(8, 12, 3)).convert(mode).save(b, "JPEG")
    data = cs.iptc_file(12, 8, b.getvalue(), compression=5)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    with Image.open(path) as im:
        assert im.convert("L").mode == mode
    with pytest.raises(NotImplementedError, match="IPTC.*ROADMAP A.6"):
        tdataset.decode_gray(path)
    banded = cs.iptc_file(12, 8, jpeg(image(8, 12, 3)), compression=5, layers=3, component=1, band=2)
    refused(tmp_path, banded)


def test_iptc_holding_a_png_raises_naming_it(tmp_path):
    """A PNG in the image records: PIL opens the joined buffer as PNG; the
    port reads a PNG only from a file's own bytes (``decode_png`` at an
    offset), not from such a buffer, and raises naming it and A.6."""
    path = tmp_path / "f.png"
    path.write_bytes(cs.iptc_file(12, 8, encode_png(G), compression=5))
    assert jdataset.decode_image(path, 8).any()
    with pytest.raises(NotImplementedError, match="IPTC image holding a PNG.*ROADMAP A.6"):
        tdataset.decode_gray(path)


@pytest.mark.parametrize("route", ["IPTC-RAW", "IPTC-JPEG"])
@pytest.mark.parametrize("part", range(2))
def test_iptc_damaged_files_read_as_pil(tmp_path, route, part):
    """The probe (``scripts/raster_probe.py``), 100 files a part."""
    counts = probe(tmp_path / "f.png", BASES[route](), 800 + part, 100)
    assert counts.get("IPTC", [0, 0])[0] > 0 and sum(c[1] for c in counts.values()) > 0


# -- PCD ----------------------------------------------------------------------

def pcd_planes(seed: int):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (512, 768)).astype(np.uint8),
            *(rs.randint(0, 256, (256, 384)).astype(np.uint8) for _ in range(2)))


@pytest.mark.parametrize("orientation", [0, 1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_pcd_reads_as_pil(tmp_path, orientation, seed):
    """Seeded luma and chroma (393,216 of the 2^24 (Y, Cb, Cr) triples a
    file), each orientation (1 and 3 rotated 90 and 270 degrees; 2 as 0),
    under .pcd and .png names."""
    reads(tmp_path, cs.pcd_file(*pcd_planes(seed), orientation), ("f.pcd", "f.png"))


def test_pcd_neutral_grey(tmp_path):
    """(Y, Cb, Cr) = (128, 156, 137), PhotoYCC's neutral chroma: grey 174."""
    path = tmp_path / "f.pcd"
    path.write_bytes(cs.pcd_file(np.full((512, 768), 128), np.full((256, 384), 156), np.full((256, 384), 137)))
    assert (tdataset.decode_gray(path) == 174).all()
    assert_port_reads_as_pil(path)


PCD_CASES = {
    "a_byte_short": (lambda d: d[:-1], "refused"),
    "image_data_missing": (lambda d: d[:96 * 2048], "refused"),
    "header_cut_at_3586": (lambda d: d[:2048 + 1538], "passed"),
    "header_cut_at_3587": (lambda d: d[:2048 + 1539], "refused"),
    "higher_resolutions_after": (lambda d: d + bytes(5000), "read"),
    "orientation_high_bits": (lambda d: d[:2048 + 1538] + bytes([0xFD]) + d[2048 + 1539:], "read"),
}


@pytest.mark.parametrize("case", sorted(PCD_CASES))
def test_pcd_rules_as_pil(tmp_path, case):
    """"PCD_" at 2048 with fewer than 1539 bytes from there passed on
    (IndexError); the base image whole or refused; data after it (the
    higher resolutions) ignored; the orientation's low 2 bits alone."""
    cut, want = PCD_CASES[case]
    data = cut(cs.pcd_file(*pcd_planes(2)))
    if want == "read":
        reads(tmp_path, data)
    else:
        refused(tmp_path, data, want)


def test_pcd_damaged_files_read_as_pil(tmp_path):
    """The probe (``scripts/raster_probe.py``), 40 files."""
    counts = probe(tmp_path / "f.png", BASES["PCD"](), 900, 40)
    assert counts.get("PCD", [0, 0])[0] > 0


def test_phase_12_pages_read_as_their_digests():
    """``chip_smoke.a6_header_pages`` (built without PIL) decode to the
    digests of PIL's grey that the fixtures keep (a6_pages.sha256), with
    the port and with PIL."""
    digests = dict(reversed(line.split()) for line in
                   (cs.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    from siggan_tpu_torch.data.native import loader as tnative
    pages = cs.a6_header_pages(cs.golden_arrays())
    assert len(pages) == 9
    for name, data in pages.items():
        got = tnative.decode(data, name)
        assert got.shape == ((512, 768) if name.startswith("pcd") else (500, 1200)), name
        assert cs.gray_digest(got) == digests[name], name
        with Image.open(io.BytesIO(data)) as im:
            assert cs.gray_digest(np.asarray(im.convert("L"))) == digests[name], name


def test_pcd_ycc_grey_is_pils(tmp_path):
    """``chip_smoke.pcd_ycc_grey`` (the grey phase 12's raster tree holds a
    PCD scan to, with no PIL on the card's host) is PIL's, tinted or not."""
    g = image(300, 500)
    for tint in (False, True):
        planes = cs.pcd_planes_of(g, tint)
        path = tmp_path / "f.pcd"
        path.write_bytes(cs.pcd_file(*planes))
        with Image.open(path) as im:
            np.testing.assert_array_equal(cs.pcd_ycc_grey(*planes), np.asarray(im.convert("L")))
