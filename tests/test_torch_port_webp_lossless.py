"""Lossless WebP (VP8L, ROADMAP A.6.30) in the port's host decoder
(``data/native/webp.cpp``) against PIL, through the JAX package.

PIL reads a WebP file through libwebp's animation decoder: the first frame
on a zeroed RGBA canvas, then ``convert("L")`` on its RGB. Each case is
held to PIL's grey and to ``siggan_tpu.data.dataset.decode_image``, or to
both refusals (``ValueError`` in the port, a zero image in the JAX
package). Pillow's encoder writes the files of the first tests; the
writers of ``tests/torch_port_webp_writers.py`` write what it does not
(each transform and order, every colour-cache size, both code forms, the
meta Huffman image, LZ77 plane codes, streams libwebp refuses). Also: a
seeded sample of the damaged-file probe, the datasets and
``cli.preprocess`` on WebP scans under other formats' names, phase 12's
pages, and the library's build key over both of its sources."""

import io
import json

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import pixels
from torch_port_webp_writers import argb, vp8l_file, vp8l_stream

import chip_smoke as cs
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu.verify import pairs as jpairs
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative
from siggan_tpu_torch.ops.kernels import build
from siggan_tpu_torch.verify import pairs as tpairs

RS = np.random.RandomState(23)
SCAN = np.asarray(Image.open(cs.FIXTURES / "scan_420.jpg").convert("RGB"))
CROP = SCAN[200:236, 500:547]                      # 36 x 47: odd width
RGBA = np.dstack([CROP, pixels(RS, CROP.shape[:2]).astype(np.uint8)])
RGBA[::3, ::2, 3] = 0                              # transparent pixels keep their RGB only with exact


def pil_grey(data: bytes):
    """PIL's ``convert("L")``, or None where PIL refuses the file."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("L"))
    except Exception:
        return None


def holds(data: bytes, tmp_path=None, read=None):
    """The port reads ``data`` bit-equal with PIL's grey, or calls it
    corrupt where PIL refuses it (``read``: whether PIL must read it); with
    ``tmp_path``, ``decode_image`` of the file equals the JAX package's."""
    want = pil_grey(data)
    if read is not None:
        assert (want is not None) == read
    if want is None:
        with pytest.raises(ValueError):
            tnative.decode(data)
    else:
        np.testing.assert_array_equal(tnative.decode(data), want)
    if tmp_path is not None:
        path = tmp_path / "case.webp"
        path.write_bytes(data)
        np.testing.assert_array_equal(tdataset.decode_image(path, 16), jdataset.decode_image(path, 16))
        assert jdataset.decode_image(path, 16).any() == (want is not None and want.any())


def pillow(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


# -- Pillow's lossless files ---------------------------------------------------

@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("quality", [0, 50, 100])
@pytest.mark.parametrize("method", range(7))
def test_pillow_lossless_reads_as_pil(tmp_path, method, quality, exact):
    """Pillow's lossless RGBA at every method, at three qualities, with and
    without ``exact`` (the RGB of transparent pixels kept or changed)."""
    data = pillow(RGBA, lossless=True, method=method, quality=quality, exact=exact)
    assert data[12:16] == b"VP8X" or data[12:16] == b"VP8L"
    holds(data, tmp_path, read=True)


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 256])
def test_palette_reads_as_pil(colours):
    """Few colours: Pillow's encoder takes the colour-indexing transform,
    pixels bundled 8, 4, 2 or 1 to a byte."""
    palette = RS.randint(0, 256, (colours, 3)).astype(np.uint8)
    img = palette[RS.randint(0, colours, (23, 29))]
    holds(pillow(img, lossless=True), read=True)
    holds(pillow(img, lossless=True, method=6, quality=100), read=True)


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (9, 1), (2, 3), (13, 17), (33, 31)])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_modes_and_odd_sizes_read_as_pil(mode, size):
    h, w = size
    im = Image.fromarray(np.resize(RGBA, (h, w, 4)), "RGBA").convert(mode)
    buf = io.BytesIO()
    im.save(buf, "WEBP", lossless=True)
    holds(buf.getvalue(), read=True)


# -- hand-built streams --------------------------------------------------------

def image(h, w, colours=None, alpha=True):
    """An ARGB image, of ``colours`` distinct values when given."""
    if colours is not None:
        pal = [argb(RS.randint(256) if alpha else 255, *RS.randint(0, 256, 3)) for _ in range(colours)]
        return np.array(pal, np.int64)[RS.randint(0, colours, (h, w))], pal
    return np.array([[argb(RS.randint(256) if alpha else 255, *RS.randint(0, 256, 3))
                      for _ in range(w)] for _ in range(h)], np.int64)


IMG = image(11, 13)
REPEATS = np.tile(image(3, 5), (4, 3))             # rows and runs LZ77 copies
PAL5_IMG, PAL5 = image(9, 14, colours=5)
TILES = ((11 + 3) // 4, (13 + 3) // 4)
STREAMS = {
    **{f"predictor_mode_{m}": (IMG, dict(transforms=[("predictor", 2, np.full(TILES, m))]))
       for m in range(16)},                                   # 14 and 15: black
    "predictor_modes_by_tile": (IMG, dict(transforms=[("predictor", 2, RS.randint(0, 14, TILES))])),
    "predictor_bits_9": (IMG, dict(transforms=[("predictor", 9, [[11]])])),
    "cross_colour_negative": (IMG, dict(transforms=[("cross", 2, RS.randint(128, 256, TILES + (3,)))])),
    "cross_colour_by_tile": (IMG, dict(transforms=[("cross", 3, RS.randint(0, 256, (2, 2, 3)))])),
    "subtract_green": (IMG, dict(transforms=[("green",)])),
    "libwebp_order": (IMG, dict(transforms=[("green",), ("predictor", 2, RS.randint(0, 14, TILES)),
                                            ("cross", 2, RS.randint(0, 256, TILES + (3,)))])),
    "reversed_order": (IMG, dict(transforms=[("cross", 2, RS.randint(0, 256, TILES + (3,))),
                                             ("predictor", 3, RS.randint(0, 14, (2, 2))), ("green",)])),
    "palette_then_predictor": (PAL5_IMG, dict(transforms=[("palette", PAL5),
                                                          ("predictor", 2, RS.randint(0, 14, (3, 2)))])),
    **{f"palette_{n}_colours": (lambda n: (lambda im, pal: (im, dict(transforms=[("palette", pal)])))(
        *image(7, 11, colours=n)))(n) for n in (1, 2, 3, 4, 5, 16, 17, 256)},
    **{f"colour_cache_{b}_bits": (REPEATS, dict(cache_bits=b)) for b in range(1, 12)},
    "lz77_plane_codes": (REPEATS, dict(lz77=True)),
    "lz77_with_cache": (REPEATS, dict(lz77=True, cache_bits=5)),
    "lz77_width_1": (np.tile(image(3, 1), (5, 1)), dict(lz77=True)),
    "lz77_long_runs": (np.full((40, 130), argb(255, 1, 2, 3), np.int64), dict(lz77=True)),
    "meta_groups": (IMG, dict(meta=(2, RS.randint(0, 4, TILES)))),
    "meta_group_numbers_past_1000": (IMG, dict(meta=(2, RS.choice([0, 3, 1001, 1700], TILES)))),
    "meta_with_cache_and_lz77": (REPEATS, dict(meta=(3, [[0, 2]] * 2), cache_bits=4, lz77=True)),
    "normal_codes_only": (IMG, dict(simple=False)),
    "code_lengths_with_max_symbol": (IMG, dict(simple=False, max_symbol=True)),
    "one_colour": (np.full((6, 9), argb(255, 9, 8, 7), np.int64), dict()),   # every code one symbol
    "one_colour_normal_codes": (np.full((6, 9), argb(0, 0, 1, 0), np.int64), dict(simple=False)),
    "two_colours_simple_codes": (np.array([[argb(255, 0, 1, 0), argb(0, 7, 200, 9)] * 4] * 3), dict()),
    "alpha_hint_set": (IMG, dict(alpha_hint=True)),
    "sixteen_k_wide": (image(1, 5)[:, [0, 1, 2, 3, 4] * 3277][:, :16384], dict(lz77=True)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_hand_built_stream_reads_as_pil(tmp_path, name):
    """Each stream decodes in PIL to the image it was written from, and in
    the port to PIL's grey."""
    img, kw = STREAMS[name]
    img = np.asarray(img, np.int64)
    data = vp8l_file(img, **kw)
    rgb = np.stack([(img >> 16) & 255, (img >> 8) & 255, img & 255], -1)
    want = (19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000) >> 16
    np.testing.assert_array_equal(pil_grey(data), want)
    holds(data, tmp_path if name.startswith("predictor_mode_1") else None, read=True)


def with_bits(stream: bytes, at: int, nbits: int, value: int) -> bytes:
    """``stream`` with the ``nbits`` bits from bit ``at`` set to ``value``."""
    v = int.from_bytes(stream, "little")
    v = (v & ~(((1 << nbits) - 1) << at)) | (value << at)
    return v.to_bytes(len(stream), "little")


def riff(stream: bytes) -> bytes:
    return cs.riff_webp([cs.webp_chunk(b"VP8L", stream)])


BASE = vp8l_stream(IMG)
# name -> file; PIL refuses each
REFUSED = {
    "transform_given_twice": lambda: vp8l_file(IMG, transforms=[("green",), ("green",)]),
    # the header's 40 bits (the version at bit 37), no transform, a cache of 3
    # bits whose size field (bits 42-45) is then changed
    "colour_cache_0_bits": lambda: riff(with_bits(vp8l_stream(IMG, cache_bits=3), 42, 4, 0)),
    "colour_cache_12_bits": lambda: riff(with_bits(vp8l_stream(IMG, cache_bits=3), 42, 4, 12)),
    "version_1": lambda: riff(with_bits(BASE, 37, 3, 1)),
    "signature": lambda: riff(b"\x2e" + BASE[1:]),
    "header_only": lambda: riff(BASE[:5]),
    "data_cut": lambda: riff(BASE[:len(BASE) * 2 // 3]),
    # two bytes: one byte less makes an odd chunk, whose pad byte libwebp
    # reads as the stream's last
    "last_two_bytes_cut": lambda: riff(vp8l_stream(image(5, 40))[:-2]),
    "copy_before_the_start": lambda: riff(bad_copy()),
    "incomplete_code": lambda: riff(incomplete_code()),
}


def bad_copy() -> bytes:
    """A stream whose first symbol is a copy: no pixel to copy from."""
    bw = cs.BitFields()
    cs.vp8l_header(bw, 4, 2)
    for bits, n in ((0, 1), (0, 1), (0, 1)):  # no transform, no cache, no meta image
        bw.put(bits, n)
    green = np.zeros(280, np.int64)
    green[256] = green[7] = 1                # a copy of length 1 and a literal
    codes, lens = cs.vp8l_prefix_code(bw, green, simple=False)
    for size in (256, 256, 256, 40):
        cs.vp8l_prefix_code(bw, np.eye(size, dtype=np.int64)[0])
    bw.code(int(codes[256]), int(lens[256]))
    bw.put(0, 8)
    return bw.tobytes()


def incomplete_code() -> bytes:
    """A green code of lengths 1, 2 and 2 and one more of 2: over-full."""
    bw = cs.BitFields()
    cs.vp8l_header(bw, 3, 1)
    for bits, n in ((0, 1), (0, 1), (0, 1)):
        bw.put(bits, n)
    green = np.zeros(280, np.int64)
    green[:4] = (1, 2, 2, 2)
    cs.vp8l_prefix_code(bw, green, simple=False)
    bw.put(0, 64)
    return bw.tobytes()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_stream_libwebp_refuses_is_corrupt(tmp_path, name):
    holds(REFUSED[name](), tmp_path, read=False)


# -- the damaged-file probe ----------------------------------------------------

def damage(rs, data: bytes) -> bytes:
    """One of eight damages: a bit flipped past byte 20, bytes changed, the
    file cut (its RIFF size kept or fixed), a chunk's size changed, a VP8X
    flag or the RIFF size changed, a byte of an image chunk's first 40,
    bytes appended (the RIFF size kept or grown), three bytes replaced."""
    d, kind = bytearray(data), rs.randint(8)
    chunks, i = [], 12
    while i + 8 <= len(d):
        n = int.from_bytes(d[i + 4:i + 8], "little")
        chunks.append((i, bytes(d[i:i + 4])))
        i += 8 + n + (n & 1)
    if kind == 0:
        i = rs.randint(20, len(d))
        d[i] ^= 1 << rs.randint(8)
    elif kind == 1:
        for _ in range(rs.randint(1, 4)):
            d[rs.randint(12, len(d))] = rs.randint(256)
    elif kind == 2:
        d = d[:rs.randint(12, len(d))]
        if rs.randint(2):
            d[4:8] = (len(d) - 8).to_bytes(4, "little")
    elif kind == 3 and chunks:
        at = chunks[rs.randint(len(chunks))][0]
        n = int.from_bytes(d[at + 4:at + 8], "little")
        n = max(0, n + rs.randint(-6, 7)) if rs.randint(3) else rs.randint(0, 1 << 20)
        d[at + 4:at + 8] = n.to_bytes(4, "little")
    elif kind == 4:
        if d[12:16] == b"VP8X":
            d[20] ^= 1 << rs.randint(8)
        else:
            n = int.from_bytes(d[4:8], "little") + rs.randint(-3, 4)
            d[4:8] = max(0, n).to_bytes(4, "little")
    elif kind == 5:
        images = [at for at, tag in chunks if tag in (b"VP8 ", b"VP8L", b"ALPH", b"ANMF")]
        if images:
            i = images[rs.randint(len(images))] + 8 + rs.randint(0, 40)
            if i < len(d):
                d[i] = rs.randint(256)
    elif kind == 6:
        d += bytes(rs.randint(0, 256, rs.randint(1, 12)).astype(np.uint8))
        if rs.randint(2):
            d[4:8] = (len(d) - 8).to_bytes(4, "little")
    else:
        i = rs.randint(len(d) // 2, len(d))
        d[i:i + 3] = bytes(rs.randint(0, 256, 3).astype(np.uint8))
    return bytes(d)


def probe(bases, seed: int, n: int):
    """``n`` damaged files of ``bases`` in turns, each read as PIL reads it
    or refused where PIL refuses it; both verdicts must occur."""
    rs = np.random.RandomState(seed)
    verdicts = set()
    for i in range(n):
        data = damage(rs, bases[i % len(bases)])
        want = pil_grey(data)
        verdicts.add(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"file {i}")
    assert verdicts == {True, False}


@pytest.mark.parametrize("part", range(2))
def test_damaged_lossless_probe_reads_as_pil(part):
    """A.6.30's probe, 800 files a part (seeded): Pillow's lossless files
    (RGB, a palette, RGBA with alpha) and hand-built streams (transforms,
    a colour cache, LZ77, meta codes), damaged. Offline, 100,000 such files
    of Pillow's and 10,000 of the writers' read as PIL (PERF.md)."""
    crop = SCAN[300:340, 700:760]
    bases = [pillow(crop, lossless=True), pillow(crop // 64 * 64, lossless=True),
             pillow(np.dstack([crop, crop[..., 2]]), lossless=True),
             vp8l_file(REPEATS, lz77=True, cache_bits=4, transforms=[("green",)]),
             vp8l_file(IMG, transforms=[("predictor", 2, RS.randint(0, 14, TILES))],
                       meta=(2, RS.randint(0, 3, TILES)))]
    probe(bases, 300 + part, 800)


# -- the datasets, the CLI, phase 12, the build key ---------------------------

def webp_tree(root):
    """Two writers' folders of WebP scans under .jpg and .png names
    (Pillow's lossless, lossy, lossy with alpha; the grey writer's), beside
    a PNG scan each."""
    rs = np.random.RandomState(5)
    for wi in range(2):
        d = root / f"w{wi}"
        d.mkdir(parents=True)
        for k in range(5):
            h, w = 50 + 7 * k + wi, 80 - 4 * k
            page = rs.randint(215, 256, (h, w)).astype(np.uint8)
            for _ in range(8):
                y, x = rs.randint(3, h - 3), rs.randint(3, w - 18)
                page[y - 2:y + 2, x:x + 15] = rs.randint(0, 80)
            rgb = np.dstack([page, page, np.clip(page.astype(int) + 6, 0, 255)]).astype(np.uint8)
            name = d / f"w{wi}_{k}"
            if k == 0:
                Image.fromarray(page).save(f"{name}.png")
            elif k == 1:
                name.with_suffix(".jpg").write_bytes(pillow(rgb, lossless=True))
            elif k == 2:
                name.with_suffix(".png").write_bytes(pillow(rgb, quality=70))
            elif k == 3:
                name.with_suffix(".jpg").write_bytes(pillow(np.dstack([rgb, page]), quality=80))
            else:
                name.with_suffix(".png").write_bytes(cs.vp8l_grey_file(page))


def test_datasets_and_preprocess_read_webp_named_jpg_and_png_as_jax(tmp_path, monkeypatch):
    """WebP scans under .jpg and .png names: the JAX package globs them and
    reads each through PIL by its content, and so does the port:
    SignatureDataset, PairDataset and cli.preprocess give the same."""
    from siggan_tpu.cli import preprocess as jcli
    from siggan_tpu.core import platform as jplatform
    from siggan_tpu_torch.cli import preprocess as tcli
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(jplatform, "setup", lambda *a, **k: None)
    raw = tmp_path / "raw"
    webp_tree(raw)
    j = jdataset.SignatureDataset(raw, 32, use_cache=False)
    t = tdataset.SignatureDataset(raw, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 10
    assert j.images.reshape(10, -1).std(1).min() > 0    # PIL read every file
    np.testing.assert_array_equal(t.images, j.images)
    jp = jpairs.PairDataset(raw, pairs_per_user=4, image_size=32, seed=2)
    tp = tpairs.PairDataset(raw, pairs_per_user=4, image_size=32, seed=2)
    assert [(a.name, b.name, lab) for a, b, lab in tp.pairs] == \
        [(a.name, b.name, lab) for a, b, lab in jp.pairs]
    np.testing.assert_array_equal(tp.img1, jp.img1)
    np.testing.assert_array_equal(tp.img2, jp.img2)
    flags = ["--canvas_size", "128", "--batch_size", "4"]
    assert jcli.main(["--input_dir", str(raw), "--output_dir", str(tmp_path / "j")] + flags) == 0
    assert tcli.main(["--input_dir", str(raw), "--output_dir", str(tmp_path / "t"),
                      "--device", "cpu"] + flags) == 0
    want = json.loads((tmp_path / "j" / "preprocess_report.json").read_text())
    assert json.loads((tmp_path / "t" / "preprocess_report.json").read_text()) == want
    assert len(want["processed"]) + len(want["invalid"]) == 10
    for path in sorted(raw.rglob("*.*")):
        np.testing.assert_array_equal(tcli.load_canvas(path, 128)[0],
                                      jcli.load_canvas(path, 128)[0], err_msg=path.name)


def test_phase_12_webp_pages_read_as_their_digests():
    """The three WebP pages phase 12 decodes (Pillow's, 1200 x 500, in
    ``chip_smoke.WEBP_PAGES``) read as the digests of PIL's grey that
    ``a6_pages.sha256`` keeps."""
    digests = dict(reversed(line.split()) for line in
                   (cs.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    for name in cs.WEBP_PAGES_NAMES:
        data = (cs.WEBP_PAGES / name).read_bytes()
        assert cs.gray_digest(pil_grey(data)) == digests[name]
        assert cs.gray_digest(tnative.decode(data)) == digests[name]


def test_webp_pages_writer_makes_the_committed_bytes(tmp_path):
    """``write_webp_pages`` (run with the fixtures' writer) makes the
    committed pages byte for byte."""
    from test_torch_port_decode import write_webp_pages
    pages = write_webp_pages(cs.FIXTURES / "scan_420.jpg", tmp_path)
    assert sorted(pages) == sorted(cs.WEBP_PAGES_NAMES)
    for name, data in pages.items():
        assert data == (cs.WEBP_PAGES / name).read_bytes()


def test_grey_scan_writer_reads_as_its_grey():
    """``chip_smoke.vp8l_grey_file`` (phase 12's WebP scans, written without
    PIL) is lossless: PIL and the port read back the grey it was given."""
    for shape in ((1, 1), (5, 300), (61, 83)):
        grey = pixels(np.random.RandomState(shape[1]), shape).astype(np.uint8)
        data = cs.vp8l_grey_file(grey)
        np.testing.assert_array_equal(pil_grey(data), grey)
        np.testing.assert_array_equal(tnative.decode(data), grey)


def test_library_name_hashes_every_source(tmp_path):
    """The decoder library is built from decode.cpp and webp.cpp; its name
    carries a hash of both, so an edit to webp.cpp alone builds a new one
    (a stale library is never loaded)."""
    assert [p.name for p in tnative.SOURCES] == ["decode.cpp", "webp.cpp"]
    copies = [tmp_path / p.name for p in tnative.SOURCES]
    for src, dst in zip(tnative.SOURCES, copies):
        dst.write_bytes(src.read_bytes())
    before = build.host_library_path(copies)
    assert before.name.startswith("libdecode_") and before == build.host_library_path(copies)
    copies[1].write_bytes(copies[1].read_bytes() + b"\n// edited\n")
    assert build.host_library_path(copies) != before
    assert build.host_library_path(copies[:1]) != build.host_library_path(copies)
