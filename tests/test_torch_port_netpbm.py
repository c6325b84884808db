"""Netpbm (ROADMAP A.6.29) in the port's host decoder (``data/native/decode.cpp``,
``pnm_head`` / ``decode_pnm``) against PIL, through the JAX package.

PIL's PpmImagePlugin: P1-P6 plain and raw, Pf, and Pillow's own P0CMYK,
PyP, PyRGBA and PyCMYK. A header token is read to whitespace, 10 bytes at
most, a comment skipped wherever it starts; its numbers are Python's int()
and float(). A maxval below 255 is scaled as Python rounds; one above 255
makes grey PIL's mode I, which ``convert("L")`` clips; a raw maxval of 65535
reads grey samples as they are. Pf is F, its rows bottom up, its scale's
sign the byte order. A plain sample past maxval, samples that end early, a
header PIL raises on are corrupt; a magic PIL does not know passes the file
to PIL's other plugins (P7 is none of them)."""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels

import chip_smoke as cs
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative

RS = np.random.RandomState(0)
G8, RGB, CMYK = RS.randint(0, 256, (7, 9)), RS.randint(0, 256, (7, 9, 3)), RS.randint(0, 256, (7, 9, 4))


def pil_grey(data: bytes):
    """PIL's ``convert("L")``, or None where PIL refuses the file."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            assert im.format == "PPM"
            return np.asarray(im.convert("L"))
    except Exception:
        return None


def holds(data: bytes, reads: bool):
    want = pil_grey(data)
    assert (want is not None) == reads
    if want is None:
        with pytest.raises(ValueError):
            tnative.decode(data)
    else:
        np.testing.assert_array_equal(tnative.decode(data), want)


@pytest.mark.parametrize("maxval", [1, 15, 100, 254, 255, 256, 1000, 65534, 65535])
@pytest.mark.parametrize("kind", ["P2", "P3", "P5", "P6", "P0CMYK", "PyCMYK", "PyRGBA", "PyP"])
def test_maxvals_read_as_pil(kind, maxval):
    """Every kind with a maxval, below, at and above 255 (grey past 255 is
    PIL's I, clipped; colour is scaled to 255)."""
    samples = {"P3": RGB, "P6": RGB}.get(kind, CMYK if kind in ("P0CMYK", "PyCMYK", "PyRGBA") else G8)
    holds(cs.pnm_file(kind, samples * maxval // 255, maxval), True)


def test_maxval_scaling_is_pils_rounding():
    """A P5 of maxval 100: 0, 50, 99, 100 read 0, 128, 252, 255 (Python's
    round, half to even); past maxval a raw sample is clipped to 255."""
    data = b"P5\n5 1\n100\n" + bytes([0, 50, 99, 100, 200])
    np.testing.assert_array_equal(tnative.decode(data), [[0, 128, 252, 255, 255]])
    holds(data, True)


FILES = {  # name -> (bytes, whether PIL reads it)
    "p1": (cs.pnm_file("P1", G8 > 128), True),
    "p4": (cs.pnm_file("P4", G8 > 128), True),
    "p4_width_17": (cs.pnm_file("P4", RS.randint(0, 2, (5, 17))), True),
    "p1_without_spaces": (b"P1\n4 2\n01101001\n", True),
    "p1_bad_character": (b"P1\n4 2\n0110 1002\n", False),
    "p1_bad_character_past_the_samples": (b"P1\n2 1\n01 2\n", False),
    "p2_long_token_past_the_samples": (b"P2\n2 1\n255\n1 2 12345678901", False),
    "p2_long_token_past_the_samples_then_space": (b"P2\n2 1\n255\n1 2 12345678901 ", True),
    "p2_comments": (b"P2 # c\n2#x\n 1 # y\n255\n1#z\n2 3\n", True),
    "p2_comment_joins_tokens": (b"P2\n2 1\n255\n1#c\n2 3\n", True),
    "p2_underscores_and_sign": (b"P2\n2 1\n2_55\n1_0 +5\n", True),
    "p2_negative": (b"P2\n2 1\n255\n-1 5\n", False),
    "p2_minus_zero": (b"P2\n2 1\n255\n-0 5\n", True),
    "p2_past_maxval": (cs.pnm_file("P2", G8, 100), False),
    "p2_short": (b"P2\n3 1\n255\n1 2\n", False),
    "p5_short": (b"P5\n3 2\n255\n" + bytes(5), False),
    "p6_16_bit_short": (b"P6\n3 2\n1000\n" + bytes(30), False),
    "p5_maxval_0": (b"P5\n2 1\n0\n\x00\x00", False),
    "p5_maxval_65536": (b"P5\n2 1\n65536\n" + bytes(4), False),
    "p5_token_too_long": (b"P5\n12345678901 1\n255\n", False),
    "p5_hash_inside_a_token": (b"P5\n2#x\n3 1\n255\n" + bytes(23), True),
    "p5_header_ends_at_the_file's_end": (b"P5\n2 1", False),
    "p5_cr_ends_a_comment": (b"P5\n1 1 #c\r255\n\x07", True),
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_netpbm_kind_reads_as_pil(name):
    data, reads = FILES[name]
    holds(data, reads)


@pytest.mark.parametrize("scale", [b"-1.0", b"1.0", b"-2.5e0", b"1_0.0", b"inf", b"0", b"nan", b"x"])
def test_pf_reads_as_pil(scale):
    """Pf: little-endian floats for a negative scale, rows bottom up, F ->
    L truncated and clipped (NaN 0); a zero, infinite or NaN scale, or one
    that is no number, refused."""
    vals = [-0.5, 0.5, 1.0, 1.5, 254.9, 255, 300, -3, 7.7, float("nan"), float("inf")] * 2
    le = scale.startswith(b"-")
    data = b"Pf\n11 2\n%s\n" % scale + struct.pack(("<" if le else ">") + "22f", *vals)
    holds(data, scale in (b"-1.0", b"1.0", b"-2.5e0", b"1_0.0"))


@pytest.mark.parametrize("data", [b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x01\x02",
                                  b"P5\n0 3\n255\n", b"P5\n-2 3\n255\n" + bytes(6), b"P55\n2 1\n255\n\x00\x01",
                                  b"Py\n1 1\n255\n\x07", b"Pf3\n1 1\n1\n" + bytes(4)])
def test_files_pil_identifies_as_nothing_are_corrupt(data):
    """P7 (PAM), no pixels, an unknown magic: PIL's PpmImagePlugin passes
    the file on and no other plugin takes it."""
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError):
        tnative.decode(data)


def test_damaged_netpbm_probe_reads_as_pil():
    """A.6.29's probe (seeded, 2000 files): every kind, bytes changed to
    digits, whitespace, '#' or any, the file cut, a byte put into the
    header; read bit-equal where PIL reads, corrupt where it refuses."""
    rs = np.random.RandomState(1)
    bases = [cs.pnm_file(k, s, mv) for k, s, mv in [
        ("P1", G8 > 100, 1), ("P2", G8, 255), ("P2", G8 * 4, 1020), ("P3", RGB, 255), ("P4", G8 > 100, 1),
        ("P5", G8, 255), ("P5", G8 * 4, 1020), ("P5", G8, 65535), ("P6", RGB, 255), ("P6", RGB * 3, 765),
        ("P0CMYK", CMYK, 255), ("PyRGBA", CMYK, 200)]]
    bases.append(b"Pf\n9 7\n-1.0\n" + rs.randn(63).astype("<f4").tobytes())
    verdicts = set()
    for i in range(2000):
        d, kind = bytearray(bases[i % len(bases)]), i % 3
        if kind == 0:
            for _ in range(rs.randint(1, 4)):
                d[rs.randint(0, len(d))] = rs.choice([rs.randint(0, 256), 32, 10, 35, 48, 49, 57, 45])
        elif kind == 1:
            d = d[:rs.randint(1, len(d))]
        else:
            j = rs.randint(0, min(len(d), 20))
            d[j:j] = bytes([rs.choice([32, 10, 35, 48, 55, 95, 43])])
        data = bytes(d)
        try:
            with Image.open(io.BytesIO(data)) as im:
                want = np.asarray(im.convert("L"))
        except Exception:
            want = None
        verdicts.add(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"file {i}")
    assert verdicts == {True, False}


def test_plain_pages_past_pils_1mb_blocks_read_as_pil():
    """PIL reads plain samples 1 MiB at a time; a token, and a comment, cut
    by a block's end read as PIL reads them."""
    grey = pixels(np.random.RandomState(2), (300, 1200)).astype(np.uint8)
    data = bytearray(cs.pnm_file("P2", grey))
    at = (1 << 20) + 11  # a comment across the first block's end
    data[at - 40:at - 40] = b"#" + b"c" * 60 + b"\n"
    assert len(data) > 1 << 20
    holds(bytes(data), True)


def test_datasets_read_pgm_named_png_as_jax(tmp_path, monkeypatch):
    """PGM files under .png names beside PNG scans: both packages'
    SignatureDatasets give the same arrays."""
    from siggan_tpu.data.native import loader as jnative
    monkeypatch.setattr(jnative, "available", lambda: False)
    for k in range(3):
        scan = pixels(np.random.RandomState(k), (30 + 4 * k, 40)).astype(np.uint8)
        Image.fromarray(scan).save(tmp_path / f"w0_{k}.png")
        (tmp_path / f"w0_p{k}.png").write_bytes(cs.pnm_file(["P5", "P2", "P5"][k], scan * (1 + k), 255 * (1 + k)))
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert len(t) == 6 and all(x.any() for x in t.images)
    np.testing.assert_array_equal(t.images, j.images)
    assert_port_reads_as_pil(tmp_path / "w0_p1.png")


def test_phase_12_pages_read_as_their_digests():
    """``chip_smoke.a6_gif_pnm_pages``' PGM pages (1200 x 500, built without
    PIL: raw at 8 and 16 bits, plain) decode to the digests of PIL's grey
    that the fixtures keep."""
    digests = dict(reversed(line.split()) for line in
                   (cs.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    pages = cs.a6_gif_pnm_pages(cs.golden_arrays())
    for name in ("p5_page.pgm", "p5_16bit_page.pgm", "p2_page.pgm"):
        assert cs.gray_digest(pil_grey(pages[name])) == digests[name]
        assert cs.gray_digest(tnative.decode(pages[name])) == digests[name]
