"""Lossless JPEG (SOF3, ROADMAP A.6.5) and arithmetic-coded JPEG (SOF9,
SOF10, A.6.6) against PIL, through the JAX package, from the writers of
``torch_port_jpeg_writers``. The arithmetic writer codes the quantized
coefficients of a PIL-written Huffman JPEG; each test first asserts that
PIL decodes the arithmetic file to the Huffman file's pixels, which proves
the writer, and only then holds the port to PIL. Also: libjpeg's rules
that PIL's reading shows (lossless colour spaces, restart intervals of
whole rows, a sequential frame ends after a scan of every component, a
sequential scan's Ss / Se / Ah / Al are a warning: C.13), damaged data,
and a dataset over a tree of every kind this slice reads. SOF11 (lossless
and arithmetic-coded) libjpeg does not decode, so PIL refuses it: corrupt
(C.16)."""

import io
import logging

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels
from test_torch_port_ojpeg import ojpeg_jif
from test_torch_port_progressive import cut_scans, pil_jpeg
from torch_port_jpeg_writers import (SCRIPT1, SCRIPT3, arith_jpeg, lossless_arith_jpeg, lossless_jpeg,
                                     seg)

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu_torch.data import dataset as tdataset


def pil_grey(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L"))


def refused_as_pil(path, what):
    """PIL refuses the file; both packages give a zero image and the port's
    ``decode_gray`` raises ValueError naming ``what``."""
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.convert("L")
    assert not jdataset.decode_image(path, 16).any()
    assert not tdataset.decode_image(path, 16).any()
    with pytest.raises(ValueError, match=what):
        tdataset.decode_gray(path)


# -- lossless ------------------------------------------------------------------

@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt,restart_rows", [(0, 0), (3, 1), (1, 2)])
def test_lossless_grey_matches_pil(tmp_path, psv, pt, restart_rows):
    """Every predictor, with and without a point transform and restarts
    (which start a row afresh)."""
    g = pixels(np.random.RandomState(psv), (13, 17)).astype(np.uint8)
    data = lossless_jpeg([g], psv=psv, pt=pt, restart_rows=restart_rows)
    assert np.array_equal(pil_grey(data), (g >> pt) << pt)
    (tmp_path / "l.jpg").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "l.jpg")


SAMPLINGS = {"444": [(1, 1)] * 3, "h2v2": [(2, 2), (1, 1), (1, 1)],
             "h2v1": [(2, 1), (1, 1), (1, 1)], "h1v2": [(1, 2), (1, 1), (1, 1)],
             "chroma_h2v2": [(1, 1), (2, 2), (1, 1)]}


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("kw", [dict(), dict(interleave=False), dict(restart_rows=1, psv=4),
                                dict(restart_rows=1, interleave=False, psv=6, pt=1)],
                         ids=["one_scan", "a_scan_each", "restarts", "a_scan_each_restarts"])
def test_lossless_three_components_match_pil(tmp_path, sampling, kw):
    """Three components (libjpeg-turbo takes them for RGB without a marker
    and converts no colour space of a lossless frame), any sampling (box
    upsampled: a lossless block is one sample), one interleaved scan or one
    scan a component, restarts (in a lone component's scan of v rows an
    iMCU row, libjpeg starts afresh the iMCU row in which a restart came)."""
    h, w = 13, 19
    samp = SAMPLINGS[sampling]
    hmax, vmax = max(s[0] for s in samp), max(s[1] for s in samp)
    rs = np.random.RandomState(len(kw) + hmax)
    planes = [pixels(rs, (-(-h * v // vmax), -(-w * s // hmax))).astype(np.uint8) for s, v in samp]
    data = lossless_jpeg(planes, samp, size=(w, h), **kw)
    (tmp_path / "l.jpg").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "l.jpg")


def test_lossless_cmyk_and_damaged_match_pil(tmp_path):
    """Four components (CMYK as PIL reads a JPEG's, inverted), and streams
    cut short (rows past the data start afresh from zero differences, until
    a restart)."""
    c4 = np.random.RandomState(1).randint(0, 256, (9, 11, 4)).astype(np.uint8)
    (tmp_path / "cmyk.jpg").write_bytes(lossless_jpeg([c4[..., i] for i in range(4)]))
    assert_port_reads_as_pil(tmp_path / "cmyk.jpg")
    g = pixels(np.random.RandomState(2), (24, 20)).astype(np.uint8)
    for restart_rows in (0, 3):
        data = lossless_jpeg([g], psv=5, restart_rows=restart_rows)
        scan = data.index(b"\xff\xda") + 10
        for cut in (scan + 5, scan + 90, scan + 230):
            (tmp_path / f"cut{restart_rows}_{cut}.jpg").write_bytes(data[:cut] + b"\xff\xd9")
            assert_port_reads_as_pil(tmp_path / f"cut{restart_rows}_{cut}.jpg")


def test_lossless_pil_refuses_is_a_zero_image(tmp_path):
    """YCbCr (a JFIF or an Adobe marker says so), no predictor (0) or one
    past 7, a restart interval not of whole rows, two components, 12 bits."""
    rgb = np.random.RandomState(3).randint(0, 256, (8, 10, 3)).astype(np.uint8)
    planes = [rgb[..., i] for i in range(3)]
    plain = lossless_jpeg(planes)

    def scan_byte(data, offset, value):
        d = bytearray(data)
        d[d.index(b"\xff\xda") + 5 + 2 * 3 + offset] = value
        return bytes(d)
    restart = bytearray(lossless_jpeg(planes[:1], restart_rows=1))
    restart[restart.index(b"\xff\xdd") + 5] = 5
    twelve = bytearray(lossless_jpeg(planes[:1]))
    twelve[twelve.index(b"\xff\xc3") + 4] = 12
    files = {"jfif": (lossless_jpeg(planes, jfif=True), "YCbCr"),
             "adobe_ycc": (plain[:2] + seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 1]))
                           + plain[2:], "YCbCr"),
             "predictor_0": (scan_byte(plain, 0, 0), "bad lossless JPEG scan"),
             "predictor_8": (scan_byte(plain, 0, 8), "bad lossless JPEG scan"),
             "restart_5_of_10": (bytes(restart), "whole number of rows"),
             "two_components": (lossless_jpeg(planes[:2]), "2-component"),
             "twelve_bits": (bytes(twelve), "12-bit")}
    for name, (data, what) in files.items():
        (tmp_path / f"{name}.jpg").write_bytes(data)
        refused_as_pil(tmp_path / f"{name}.jpg", what)


# -- arithmetic ----------------------------------------------------------------

SOURCES = {"grey": (None, (24, 32)), "444": (0, (37, 29)), "420": (2, (40, 48))}
DACS = {"default": (), "conditioned": ((0, 0x31), (16, 2))}   # DC L 1, U 3; AC K 2


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("dac", sorted(DACS))
def test_arithmetic_matches_pil(tmp_path, source, progressive, restart, dac):
    sub, shape = SOURCES[source]
    rs = np.random.RandomState(restart + 7 * progressive)
    img = pixels(rs, shape + (() if sub is None else (3,))).astype(np.uint8)
    huffman = pil_jpeg(img, quality=80, **({} if sub is None else {"subsampling": sub}))
    scans = (SCRIPT1 if sub is None else SCRIPT3) if progressive else None
    data = arith_jpeg(huffman, scans=scans, restart=restart, dac=DACS[dac])
    assert data[data.index(b"\xff\xc9" if not progressive else b"\xff\xca") + 1] in (0xC9, 0xCA)
    np.testing.assert_array_equal(pil_grey(data), pil_grey(huffman))   # the writer is right
    (tmp_path / "a.jpg").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "a.jpg")


def test_arithmetic_cut_and_smoothed_match_pil(tmp_path):
    """An arithmetic progressive file cut after 3 scans (libjpeg smooths its
    unrefined coefficients) and a sequential one cut inside its data."""
    img = pixels(np.random.RandomState(5), (40, 48, 3)).astype(np.uint8)
    prog = arith_jpeg(pil_jpeg(img, quality=85, subsampling=2), scans=SCRIPT3, restart=2)
    seq = arith_jpeg(pil_jpeg(img, quality=85), restart=0)
    files = {"cut_script.jpg": cut_scans(prog, 3),
             "cut_data.jpg": seq[:len(seq) // 2] + b"\xff\xd9"}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        assert_port_reads_as_pil(tmp_path / name)


@pytest.mark.parametrize("marker", [0xC9, 0xCA])
@pytest.mark.parametrize("seed", range(3))
def test_huffman_data_read_as_arithmetic_matches_pil(tmp_path, marker, seed):
    """PIL's Huffman-coded files with the frame marker swapped: libjpeg
    decodes the Huffman bits as arithmetic-coded data (magnitude and
    spectral overflows leave the rest alone), and so does the port; a
    progressive script under SOF9 and a sequential scan under SOF10 are
    refused by both."""
    img = np.random.RandomState(seed).randint(0, 256, (21, 27, 3)).astype(np.uint8)
    for i, kw in enumerate((dict(quality=85), dict(quality=60, subsampling=2),
                            dict(quality=90, progressive=True))):
        data = bytearray(pil_jpeg(img if i else img[..., 0], **kw))
        at = next(j for j in range(len(data) - 1)
                  if data[j] == 0xFF and data[j + 1] in (0xC0, 0xC2))
        data[at + 1] = marker
        (tmp_path / f"{i}.jpg").write_bytes(bytes(data))
        if marker == 0xC9 and kw.get("progressive"):
            refused_as_pil(tmp_path / f"{i}.jpg", "expects EOI")   # a second scan
        elif marker == 0xCA and not kw.get("progressive"):
            refused_as_pil(tmp_path / f"{i}.jpg", "bad progressive")   # Ss 0 with Se 63
        else:
            assert_port_reads_as_pil(tmp_path / f"{i}.jpg")


@pytest.mark.parametrize("kind", ["swapped", "qm_coded"])
def test_lossless_arithmetic_is_corrupt_as_pil_refuses_it(tmp_path, caplog, kind):
    """SOF11 (lossless, arithmetic-coded), C.16: libjpeg-turbo has a
    lossless decoder and an arithmetic one but none for both, so PIL
    refuses a SOF11 file whatever its data: Huffman-coded lossless data
    under the swapped marker, or differences really QM-coded
    (``lossless_arith_jpeg``). The JAX package gives a zero image; so does
    the port, and its ``decode_gray`` raises ``ValueError`` naming SOF11."""
    img = np.random.RandomState(5).randint(0, 256, (9, 13)).astype(np.uint8)
    if kind == "swapped":
        data = lossless_jpeg([img]).replace(b"\xff\xc3", b"\xff\xcb")
    else:
        data = lossless_arith_jpeg(img)
    path = tmp_path / f"sof11_{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.convert("L")
    assert not jdataset.decode_image(path, 16).any()
    with caplog.at_level(logging.WARNING):
        out = tdataset.decode_image(path, 16)
    assert "using zero image" in caplog.text
    np.testing.assert_array_equal(out, jdataset.decode_image(path, 16))
    with pytest.raises(ValueError, match="SOF11"):
        tdataset.decode_gray(path)


# -- libjpeg's sequential-scan rules (C.13) --------------------------------------

def test_sequential_scan_parameters_are_a_warning(tmp_path):
    """A baseline file with zeros (or any value) in its scan's Ss, Se, Ah
    and Al: libjpeg warns and decodes all 64 coefficients, as PIL shows; the
    port called such a file corrupt before (C.13)."""
    base = pil_jpeg(pixels(np.random.RandomState(6), (16, 24, 3)).astype(np.uint8), quality=85)
    sos = base.index(b"\xff\xda")
    at = sos + 5 + 2 * base[sos + 4]
    for params in (b"\x00\x00\x00", b"\x01\x3f\x21", b"\x00\x05\x00"):
        data = base[:at] + params + base[at + 3:]
        np.testing.assert_array_equal(pil_grey(data), pil_grey(base))
        (tmp_path / "s.jpg").write_bytes(data)
        assert_port_reads_as_pil(tmp_path / "s.jpg")


def test_second_scan_after_every_component_is_refused(tmp_path):
    """A sequential frame whose first scan codes every component ends
    there: libjpeg refuses a second scan (JERR_EOI_EXPECTED), as PIL shows
    on a progressive script under a baseline frame marker; the port read
    such a file before (C.13). A frame whose first scan leaves a component
    out takes more scans, and reads."""
    rgb = pixels(np.random.RandomState(7), (16, 24, 3)).astype(np.uint8)
    prog = bytearray(pil_jpeg(rgb, quality=85, progressive=True))
    prog[prog.index(b"\xff\xc2") + 1] = 0xC0
    (tmp_path / "two_scans.jpg").write_bytes(bytes(prog))
    refused_as_pil(tmp_path / "two_scans.jpg", "expects EOI")
    planes = [rgb[..., i] for i in range(3)]
    (tmp_path / "a_scan_each.jpg").write_bytes(lossless_jpeg(planes, interleave=False))
    assert_port_reads_as_pil(tmp_path / "a_scan_each.jpg")


@pytest.mark.parametrize("tail", [b"\xff\xda\xd9", b"\xff\xe1\x00\x10ab", b"\xff\xc4\x00",
                                  b"\xff\xdb\x00\x43\x00"], ids=["sos", "app1", "dht", "dqt"])
def test_markers_cut_after_the_last_scan_read_as_pil(tmp_path, tail):
    """A frame of one scan is whole once its scan is: a marker segment cut
    by the end of the data after it is where libjpeg's finish (under PIL's
    suspending source) stops, so PIL reads the file; the port called it
    corrupt before (C.13). Baseline, lossless and arithmetic-coded."""
    img = pixels(np.random.RandomState(8), (16, 24, 3)).astype(np.uint8)
    for i, base in enumerate((pil_jpeg(img, quality=80), lossless_jpeg([img[..., 0]]),
                              arith_jpeg(pil_jpeg(img, quality=80), restart=2))):
        (tmp_path / f"{i}.jpg").write_bytes(base[:-2] + tail)
        assert_port_reads_as_pil(tmp_path / f"{i}.jpg")


# -- a dataset over the new kinds -----------------------------------------------

def new_kinds_tree(root):
    """Two writers' folders of every kind this slice reads: old-style
    JPEG-in-TIFF, number TIFFs, lossless and arithmetic-coded JPEG."""
    for wi in range(2):
        d = root / f"w{wi}"
        d.mkdir(parents=True)
        rs = np.random.RandomState(40 + wi)
        rgb = pixels(rs, (30 + 6 * wi, 44, 3)).astype(np.uint8)
        h, w = rgb.shape[:2]
        grey = rgb[..., 0]
        files = {
            "ojpeg.tif": ojpeg_jif(pil_jpeg(rgb, quality=85, subsampling=2), w, h, 3),
            "float.tif": chip_smoke.tiff_numbers(grey * 1.5 - 40, "<f4", 3, compression=8,
                                                 predictor=3),
            "int16.tif": chip_smoke.tiff_numbers(grey.astype(np.int16) - 30, ">i2", 2,
                                                 compression=8),
            "lossless.jpg": lossless_jpeg([grey], psv=4 + wi),
            "arith.jpg": arith_jpeg(pil_jpeg(rgb, quality=80), restart=2),
        }
        for name, data in files.items():
            (d / f"w{wi}_{name}").write_bytes(data)


def test_datasets_read_the_new_kinds_as_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    new_kinds_tree(tmp_path / "raw")
    j = jdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    assert len(t) == 10 and all(x.any() for x in t.images)
    np.testing.assert_array_equal(t.images, j.images)


# -- C.13's last two findings, repaired: the end of the data, libtiff's tags --------

def test_scan_ending_without_eoi_reads_as_pil(tmp_path):
    """A baseline file whose EOI is replaced by one byte past its scan data:
    libjpeg never fills past the end before the last MCU, so PIL reads it."""
    img = np.random.RandomState(0).randint(0, 256, (16, 24, 3)).astype(np.uint8)
    data = pil_jpeg(img, quality=80)[:-2] + b"\x52"
    assert pil_grey(data).shape == (16, 24)
    (tmp_path / "tail.jpg").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "tail.jpg")


def test_libtiff_tag_type_rules_are_pils(tmp_path):
    """A Deflate grey TIFF (a kind read since A.6's first slices) whose
    RowsPerStrip entry carries an unknown type: PIL refuses it."""
    grey = pixels(np.random.RandomState(1), (20, 30)).astype(np.uint8)
    data = bytearray(chip_smoke.tiff_grey(grey, deflate=True))
    entry = data.index(bytes([0x16, 0x01, 0x04, 0x00]))   # tag 278, LONG
    data[entry + 2:entry + 4] = bytes([96, 0])
    (tmp_path / "rps.tif").write_bytes(bytes(data))
    refused_as_pil(tmp_path / "rps.tif", "libtiff refuses")
