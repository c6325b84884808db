"""Progressive JPEG (SOF2) in the port's decoder against PIL, through the
JAX package.

PIL-written progressive files (grey, 4:4:4, 4:2:2, 4:2:0, odd sizes,
optimised tables, restart intervals) read bit-equal with PIL's
``convert("L")`` through ``decode_gray``, ``load_canvas`` and
``decode_image``, and equal their baseline twins (the same pixels at the
same quality and subsampling give the same quantized coefficients). Scan
scripts PIL does not write come from ``progressive_bytes`` here: DC scans
interleaved or not, at Al 0 or 1, with or without their refinement, AC
bands with end-of-block runs, components left out. Where libjpeg smooths
between blocks (some of the first ten coefficients unrefined,
``jdcoefct.c::smoothing_ok``) the port smooths as libjpeg-turbo 3's
``decompress_smooth_data`` does, bit-equal with PIL too."""

import io
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image
from test_torch_port_decode import (SETTINGS, _STD_BITS, _STD_VALS, _ZIGZAG, _codes,
                                    assert_port_reads_as_pil, pil_gray, pixels, quantized_blocks)

from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative

SUBSAMPLING = {0: ((1, 1), (1, 1), (1, 1)), 1: ((2, 1), (1, 1), (1, 1)),
               2: ((2, 2), (1, 1), (1, 1)), "grey": ((1, 1),)}


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def scan_offsets(data: bytes) -> list:
    """Where each SOS marker starts (entropy data stuffs FF as FF 00, so FF
    DA is only ever a marker)."""
    return [i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


def cut_scans(data: bytes, keep: int) -> bytes:
    """The file's first ``keep`` scans, then EOI."""
    return data[:scan_offsets(data)[keep]] + b"\xff\xd9"


# -- a progressive encoder for scan scripts PIL does not write ---------------------

# AC symbols: every (run, size) of 8-bit data, EOBn for n < 15 and ZRL, each
# an 8-bit code (176 of 256, so no code is all ones).
_AC_SYMBOLS = bytes(sorted({(r << 4) | s for r in range(16) for s in range(1, 11)}
                           | {r << 4 for r in range(15)} | {0xF0}))
_AC_BITS = [0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8


def _magnitude(v: int):
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def progressive_bytes(img: np.ndarray, sampling, quality: int, script, restart: int = 0) -> bytes:
    """A progressive JPEG of ``img`` coded by ``script``: scans (components,
    Ss, Se, Ah, Al) with Ah > 0 only for DC (libjpeg's jcphuff.c rules:
    DC point transform by arithmetic shift, AC by shifting the magnitude,
    end-of-block runs, restart markers every ``restart`` MCUs)."""
    q, blocks, (mcux, mcuy) = quantized_blocks(img, sampling, quality)
    zz = [b[..., _ZIGZAG] for b in blocks]
    dc_codes = _codes(_STD_BITS[("dc", 0)], _STD_VALS[("dc", 0)])
    ac_codes = _codes(_AC_BITS, _AC_SYMBOLS)
    h, w = img.shape[:2]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body
    out = bytearray(b"\xff\xd8" + seg(0xDB, bytes([0]) + q[_ZIGZAG].astype(np.uint8).tobytes()))
    out += seg(0xC2, struct.pack(">BHHB", 8, h, w, len(blocks)) + b"".join(
        bytes([i + 1, (sh << 4) | sv, 0]) for i, (sh, sv) in enumerate(sampling)))
    out += seg(0xC4, bytes([0x00] + _STD_BITS[("dc", 0)]) + _STD_VALS[("dc", 0)]
               + bytes([0x10] + _AC_BITS) + _AC_SYMBOLS)
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    for comps, ss, se, ah, al in script:
        out += seg(0xDA, bytes([len(comps)]) + b"".join(bytes([c + 1, 0]) for c in comps)
                   + bytes([ss, se, (ah << 4) | al]))
        acc, nacc, data = 0, 0, bytearray()

        def put(v, n):
            nonlocal acc, nacc
            acc, nacc = (acc << n) | (v & ((1 << n) - 1)), nacc + n
            while nacc >= 8:
                byte = (acc >> (nacc - 8)) & 0xFF
                data.append(byte)
                if byte == 0xFF:
                    data.append(0)
                nacc -= 8
        eobrun = 0

        def flush_eob():
            nonlocal eobrun
            if eobrun:
                n = eobrun.bit_length() - 1
                put(*ac_codes[n << 4])
                put(eobrun - (1 << n), n)
                eobrun = 0
        if len(comps) == 1:
            c = comps[0]
            cw, ch = -(-w * sampling[c][0] // hmax), -(-h * sampling[c][1] // vmax)
            mcus = [[(c, r, x)] for r in range(-(-ch // 8)) for x in range(-(-cw // 8))]
        else:
            mcus = [[(c, my * sampling[c][1] + v, mx * sampling[c][0] + u) for c in comps
                     for v in range(sampling[c][1]) for u in range(sampling[c][0])]
                    for my in range(mcuy) for mx in range(mcux)]
        preds = {c: 0 for c in comps}
        for i, mcu in enumerate(mcus):
            if restart and i and i % restart == 0:
                flush_eob()
                if nacc % 8:
                    put((1 << (8 - nacc % 8)) - 1, 8 - nacc % 8)
                data += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                preds = {c: 0 for c in comps}
            for c, r, x in mcu:
                blk = zz[c][r, x]
                if ss == 0 and ah:
                    put((int(blk[0]) >> al) & 1, 1)
                elif ss == 0:
                    v = int(blk[0]) >> al
                    s, bits = _magnitude(v - preds[c])
                    preds[c] = v
                    put(*dc_codes[s])
                    put(bits, s)
                else:
                    band = [(abs(int(a)) >> al) * (1 if a >= 0 else -1) for a in blk[ss:se + 1]]
                    if not any(band):
                        eobrun += 1
                        if eobrun == 0x7FFF:
                            flush_eob()
                        continue
                    flush_eob()
                    run = 0
                    for a in band:
                        if a == 0:
                            run += 1
                            continue
                        while run > 15:
                            put(*ac_codes[0xF0])
                            run -= 16
                        s, bits = _magnitude(a)
                        put(*ac_codes[(run << 4) | s])
                        put(bits, s)
                        run = 0
                    if run:
                        eobrun += 1
        flush_eob()
        if nacc % 8:
            put((1 << (8 - nacc % 8)) - 1, 8 - nacc % 8)
        out += data
    return bytes(out + b"\xff\xd9")


def libjpeg_smooths(script, ncomp: int) -> bool:
    """``jdcoefct.c::smoothing_ok`` of libjpeg-turbo 3 after ``script``
    (quantization values are never 0 here): every component's DC coded,
    and some component's zig-zag coefficient 1-9 not fully refined."""
    bits = np.full((ncomp, 64), -1)
    for comps, ss, se, _, al in script:
        for c in comps:
            bits[c, ss:se + 1] = al
    return bool((bits[:, 0] >= 0).all() and (bits[:, 1:10] != 0).any())


# -- PIL's progressive files ---------------------------------------------------

@settings(max_examples=40, **SETTINGS)
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(30, 100),
       sub=st.sampled_from(["grey", 0, 1, 2]), restart=st.sampled_from([0, 1, 3]),
       optimize=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_pil_progressive_jpeg_matches_pil(tmp_path, h, w, quality, sub, restart, optimize, seed):
    """Grey, 4:4:4, 4:2:2 and 4:2:0 at odd sizes, quality 30-100, with and
    without optimised tables (each scan then carries its own DHT) and
    restart intervals (which reset the DC predictors and EOB runs)."""
    rs = np.random.RandomState(seed)
    img = pixels(rs, (h, w) if sub == "grey" else (h, w, 3)).astype(np.uint8)
    kw = dict(quality=quality, optimize=optimize, restart_marker_blocks=restart, progressive=True)
    if sub != "grey":
        kw["subsampling"] = sub
    path = tmp_path / "p.jpg"
    path.write_bytes(pil_jpeg(img, **kw))
    with Image.open(path) as im:
        assert im.info.get("progressive")
    assert_port_reads_as_pil(path)


@settings(max_examples=16, **SETTINGS)
@given(h=st.integers(1, 60), w=st.integers(1, 60), quality=st.integers(40, 100),
       sub=st.sampled_from(["grey", 0, 1, 2]), restart=st.sampled_from([0, 2]),
       optimize=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_progressive_equals_its_baseline_twin(h, w, quality, sub, restart, optimize, seed):
    """The same pixels, quality and subsampling give the same quantized
    coefficients, so the progressive file decodes to the baseline's grey."""
    rs = np.random.RandomState(seed)
    img = pixels(rs, (h, w) if sub == "grey" else (h, w, 3)).astype(np.uint8)
    kw = dict(quality=quality, optimize=optimize, restart_marker_blocks=restart)
    if sub != "grey":
        kw["subsampling"] = sub
    base = tnative.decode(pil_jpeg(img, **kw))
    np.testing.assert_array_equal(tnative.decode(pil_jpeg(img, progressive=True, **kw)), base)


def test_scan_sized_progressive_pages_match_pil(tmp_path):
    """A 1200 x 500 scan at each PIL sampling, progressive."""
    rs = np.random.RandomState(0)
    img = pixels(rs, (500, 1200, 3)).astype(np.uint8)
    for sub in (0, 1, 2):
        path = tmp_path / f"scan{sub}.jpg"
        Image.fromarray(img).save(path, quality=90, subsampling=sub, progressive=True)
        np.testing.assert_array_equal(tdataset.decode_gray(path), pil_gray(path))


@pytest.mark.parametrize("sub", ["grey", 2])
def test_cut_pil_script_raises_where_libjpeg_smooths(tmp_path, sub):
    """Every cut of PIL's scan script (6 scans grey, 10 in colour) leaves
    some of the first ten coefficients unrefined: PIL then smooths between
    blocks (the DC too after the first scan, which codes no AC), and so does
    the port, bit-equal; 4:2:0 at 40 rows has a padding block row that the
    smoothing of the row two above it reads."""
    rs = np.random.RandomState(11)
    img = pixels(rs, (40, 56) if sub == "grey" else (40, 56, 3)).astype(np.uint8)
    kw = {} if sub == "grey" else {"subsampling": sub}
    data = pil_jpeg(img, quality=80, progressive=True, **kw)
    n = len(scan_offsets(data))
    assert n == (6 if sub == "grey" else 10)
    full = tnative.decode(data)
    for keep in range(1, n):
        path = tmp_path / f"cut{keep}.jpg"
        path.write_bytes(cut_scans(data, keep))
        assert libjpeg_smooths(pil_script(data, keep), 1 if sub == "grey" else 3)
        assert not np.array_equal(pil_gray(path), full)   # PIL reads it, not as the whole file
        assert_port_reads_as_pil(path)


def test_cut_progressive_page_matches_pil():
    """The page ``chip_smoke.py`` phase 12 decodes and times: the committed
    1200 x 500 progressive page cut after 6 of its 10 scans, bit-equal with
    PIL; the card's machine has no PIL, so it holds the page to the digest
    of PIL's grey that the fixtures keep."""
    from test_torch_port_decode import FIXTURES, gray_digest
    data = cut_scans((FIXTURES / "progressive_page.jpg").read_bytes(), 6)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(tnative.decode(data), want)
    assert (FIXTURES / "progressive_cut_page.sha256").read_text().split() == [gray_digest(want)]


def pil_script(data: bytes, keep: int) -> list:
    """The first ``keep`` scans of a file as (components, Ss, Se, Ah, Al)."""
    script = []
    for at in scan_offsets(data)[:keep]:
        ns = data[at + 4]
        comps = tuple(data[at + 5 + 2 * i] - 1 for i in range(ns))
        ss, se, ahl = data[at + 5 + 2 * ns:at + 8 + 2 * ns]
        script.append((comps, ss, se, ahl >> 4, ahl & 15))
    return script


# -- scan scripts of this file's encoder -------------------------------------------

def _script(draw, ncomp):
    """DC scans (interleaved or per component, Al 0 or 1, refined or not),
    then AC bands per component (Al 0) that may stop short of 63; a
    component may be left out altogether."""
    comps = list(range(ncomp))
    if ncomp > 1 and draw(st.booleans()):
        comps.remove(draw(st.sampled_from(comps)))
    al = draw(st.sampled_from([0, 1]))
    script = ([(tuple(comps), 0, 0, 0, al)] if draw(st.booleans())
              else [((c,), 0, 0, 0, al) for c in comps])
    for c in comps:
        cuts = sorted(draw(st.sets(st.integers(2, 63), max_size=3)))
        bands = list(zip([1] + cuts, [k - 1 for k in cuts] + [63]))
        keep = draw(st.integers(0, len(bands)))
        script += [((c,), ss, se, 0, 0) for ss, se in bands[:keep]]
    if al and draw(st.booleans()):
        script.append((tuple(comps), 0, 0, 1, 0))
    return script


@settings(max_examples=30, **SETTINGS)
@given(data=st.data(), h=st.integers(1, 40), w=st.integers(1, 40),
       sub=st.sampled_from(["grey", 0, 1, 2]), restart=st.sampled_from([0, 1, 3]),
       seed=st.integers(0, 2 ** 16))
def test_written_scan_scripts_match_pil_or_raise(tmp_path, data, h, w, sub, restart, seed):
    """Drawn scan scripts: bit-equal with PIL, whether libjpeg smooths
    between blocks (``libjpeg_smooths``) or not."""
    sampling = SUBSAMPLING[sub]
    script = _script(data.draw, len(sampling))
    rs = np.random.RandomState(seed)
    img = pixels(rs, (h, w) if sub == "grey" else (h, w, 3)).astype(np.uint8)
    path = tmp_path / "s.jpg"
    path.write_bytes(progressive_bytes(img, sampling, 75, script, restart))
    assert_port_reads_as_pil(path)


# The DC scans, then each component's AC bands.
_DC0 = [((0, 1, 2), 0, 0, 0, 0)]
_AC = [((c,), 1, 9, 0, 0) for c in range(3)] + [((c,), 10, 63, 0, 0) for c in range(3)]


@pytest.mark.parametrize("name,script,smooths", [
    ("only coefficients past the ninth missing", _DC0 + _AC[:3], False),
    ("everything coded", _DC0 + _AC, False),
    ("DC at Al 1, never refined, ACs whole", [((0, 1, 2), 0, 0, 0, 1)] + _AC, False),
    ("one component never coded", [((0, 1), 0, 0, 0, 0)] + _AC[:2], False),
    ("DC alone", _DC0, True),
    ("AC 6-9 of one component missing", _DC0 + [((0,), 1, 5, 0, 0)] + _AC[1:3], True),
    ("AC 1-9 at Al 1", _DC0 + [((c,), 1, 9, 0, 1) for c in range(3)] + _AC[3:], True),
])
def test_named_scan_scripts(tmp_path, name, script, smooths):
    """The edges of libjpeg's rule: it looks at AC 1-9 only, and only once
    every component's DC is known; smoothed or not, the port reads the file
    as PIL does."""
    assert libjpeg_smooths(script, 3) == smooths
    img = pixels(np.random.RandomState(12), (27, 35, 3)).astype(np.uint8)
    path = tmp_path / "n.jpg"
    path.write_bytes(progressive_bytes(img, SUBSAMPLING[2], 80, script))
    assert_port_reads_as_pil(path)


@pytest.mark.parametrize("sampling,h", [(((1, 2),), 18), (((1, 2),), 28), (((1, 4),), 35),
                                        (((1, 2), (1, 1), (1, 1)), 22),
                                        (((2, 2), (1, 1), (1, 1)), 40),
                                        (((2, 2), (1, 1), (1, 1), (2, 2)), 19)])
def test_smoothing_picks_neighbour_rows_as_libjpeg(tmp_path, sampling, h):
    """Block smoothing of DC-only scans (the DC smoothed too) where the
    luma has 2 or 4 block rows an iMCU row: libjpeg-turbo counts a row's
    neighbours in rows of its own iMCU row's height, so in a short last
    iMCU row the row two above can be the row above, and the row two below
    can be an MCU-padding row; the port picks the same rows."""
    n = len(sampling)
    rs = np.random.RandomState(h)
    img = rs.randint(0, 256, (h, 27) if n == 1 else (h, 27, 3)).astype(np.uint8)
    if n == 4:
        img = np.dstack([img, img[..., :1]])
    path = tmp_path / "s.jpg"
    path.write_bytes(progressive_bytes(img, sampling, 50, [(tuple(range(n)), 0, 0, 0, 0)]))
    assert_port_reads_as_pil(path)


# -- what still raises, and truncation --------------------------------------------

@pytest.mark.parametrize("marker,kind", [(0xC6, "hierarchical JPEG"),
                                         (0xCA, "arithmetic-coded JPEG"),
                                         (0xCE, "hierarchical JPEG")])
def test_other_frames_raise_naming_their_kind(tmp_path, marker, kind):
    """Arithmetic coding (SOF10): libjpeg decodes this Huffman data as
    arithmetic-coded, and so does the port since A.6.6, bit-equal with PIL.
    libjpeg refuses hierarchical frames (SOF6, SOF14), so PIL fails and both
    packages' ``decode_image`` give the zero image; the port calls the file
    corrupt (ValueError), naming its kind."""
    data = bytearray(pil_jpeg(np.full((16, 16), 128, np.uint8), progressive=True))
    at = data.index(b"\xff\xc2")
    data[at + 1] = marker
    path = tmp_path / "h.jpg"
    path.write_bytes(bytes(data))
    if kind == "arithmetic-coded JPEG":
        assert_port_reads_as_pil(path)
        return
    with pytest.raises(ValueError, match=kind.split()[0]):
        tnative.decode(bytes(data))
    assert not jdataset.decode_image(path, 16).any()
    np.testing.assert_array_equal(tdataset.decode_image(path, 16), jdataset.decode_image(path, 16))


def test_progressive_scan_without_its_huffman_table_is_corrupt(tmp_path):
    """libjpeg installs the default Huffman tables for sequential scans
    only: a progressive file without DHT fails in PIL (the datasets take a
    zero image) and is corrupt here, where its twin with the tables reads."""
    img = pixels(np.random.RandomState(18), (24, 24)).astype(np.uint8)
    data = progressive_bytes(img, SUBSAMPLING["grey"], 90, [((0,), 0, 0, 0, 0),
                                                            ((0,), 1, 63, 0, 0)])
    at = data.index(b"\xff\xc4")
    for name, blob in (("with.jpg", data),
                       ("without.jpg", data[:at] + data[at + 2 + struct.unpack(
                           ">H", data[at + 2:at + 4])[0]:])):
        (tmp_path / name).write_bytes(blob)
    assert_port_reads_as_pil(tmp_path / "with.jpg")
    assert not jdataset.decode_image(tmp_path / "without.jpg", 16).any()
    with pytest.raises(ValueError, match="undefined Huffman table"):
        tdataset.decode_gray(tmp_path / "without.jpg")


@pytest.mark.parametrize("sub", ["grey", 2])
def test_scan_cut_short_at_a_marker_matches_pil(tmp_path, sub):
    """A scan whose data stops at the next marker: libjpeg reads zero bits
    for what the MCU in hand still needs and leaves the scan's remaining
    blocks as they are (a DC first scan's too: no prediction from a zero
    difference); so does the port. Each scan of a whole script loses the
    second half of its data. This encoder's tables give the zero bits
    end-of-block and a zero difference; the garbage blocks other tables
    decode from them can read otherwise in PIL (ROADMAP A.6, known
    differences on damaged files)."""
    sampling = SUBSAMPLING[sub]
    img = pixels(np.random.RandomState(19), (45, 61) if sub == "grey" else (45, 61, 3))
    script = [(tuple(range(len(sampling))), 0, 0, 0, 0)] + [
        ((c,), ss, se, 0, 0) for c in range(len(sampling)) for ss, se in ((1, 9), (10, 63))]
    data = progressive_bytes(img.astype(np.uint8), sampling, 85, script)
    offs = scan_offsets(data) + [len(data) - 2]
    for k, at in enumerate(offs[:-1]):
        start = at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
        mid = (start + offs[k + 1]) // 2
        mid -= data[mid - 1] == 0xFF
        path = tmp_path / f"short{k}.jpg"
        path.write_bytes(data[:mid] + data[offs[k + 1]:])
        assert_port_reads_as_pil(path)


def test_truncated_progressive_is_corrupt(tmp_path):
    """Data that ends inside a scan or between scans is corrupt (PIL: "image
    file is truncated"): ValueError here, a zero image in the datasets."""
    img = pixels(np.random.RandomState(13), (40, 48, 3)).astype(np.uint8)
    data = pil_jpeg(img, quality=85, progressive=True)
    offs = scan_offsets(data)
    for cut in (offs[3] + 40, offs[7], len(data) - 2):
        path = tmp_path / f"t{cut}.jpg"
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError):
            tdataset.decode_gray(path)
        assert not jdataset.decode_image(path, 16).any()
        assert not tdataset.decode_image(path, 16).any()
