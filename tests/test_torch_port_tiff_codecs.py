"""Deflate and JPEG-in-TIFF in the port's decoder against PIL, through the
JAX package, and the datasets on a tree of every kind A.6 added.

Deflate (compression 8 and 32946, the port's own inflate) with predictor 1
or 2, JPEG-in-TIFF (compression 7, photometric 1, 2 and 6): bit-equal with
PIL's ``convert("L")`` through ``decode_gray``, ``load_canvas`` and
``decode_image``, on files PIL writes (libtiff) and, for what PIL does not
write (tiles, big-endian 16-bit, stored and fixed-Huffman blocks, YCbCr
subsampled 2 x 1 and 2 x 2, RGB streams taken as they are, several
abbreviated streams sharing JPEGTables), on files of this module's writers
around stdlib ``zlib`` and PIL's JPEG streams. ``SignatureDataset``,
``cli.preprocess --device cpu`` and the verifier's ``PairDataset`` on a
tree holding a progressive JPEG, Deflate and JPEG-in-TIFF scans equal the
JAX package's (its PIL path)."""

import io
import json
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image
from test_torch_port_decode import (SETTINGS, _pack, assert_port_reads_as_pil, chunks_of,
                                    jpeg_bytes, layout_tags, pixels, tiff_file)

from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu.verify import pairs as jpairs
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.verify import pairs as tpairs


def deflate_tiff(samples: np.ndarray, bits: int, photometric: int, *, predictor=1, be=False,
                 tile=None, rows_per_strip=None, compression=8, level=6, strategy=None) -> bytes:
    """(h, w, spp) samples in Deflate strips or tiles, horizontally
    differenced first with ``predictor`` 2 (modulo the sample size)."""
    h, w, spp = samples.shape
    blobs = []
    for c in chunks_of(samples.astype(np.int64), tile, rows_per_strip):
        if predictor == 2:
            c = c.copy()
            c[:, 1:] = (c[:, 1:] - c[:, :-1]) % (1 << bits)
        raw = (c.reshape(c.shape[0], -1).astype((">" if be else "<") + "u2").tobytes()
               if bits == 16 else _pack(c, bits).tobytes())
        z = zlib.compressobj(level, zlib.DEFLATED, 15, 8,
                             zlib.Z_DEFAULT_STRATEGY if strategy is None else strategy)
        blobs.append(z.compress(raw) + z.flush())
    tags = [(258, 3, [bits] * spp), (259, 3, [compression]), (262, 3, [photometric]),
            (277, 3, [spp]), (317, 3, [predictor])]
    return tiff_file(w, h, blobs, tags + layout_tags(tile, rows_per_strip, h), be)


def _jpeg_segments(stream: bytes):
    """A JPEG stream's marker segments before its first SOS, and the rest."""
    segs, i = [], 2
    while stream[i + 1] != 0xDA:
        n = struct.unpack(">H", stream[i + 2:i + 4])[0]
        segs.append((stream[i + 1], stream[i:i + 2 + n]))
        i += 2 + n
    return segs, stream[i:]


def jpeg_tiff(img: np.ndarray, photometric: int, *, tile=None, rows_per_strip=None, sub=2,
              quality=80, abbreviate=False, progressive=False, encode=None) -> bytes:
    """JPEG-in-TIFF: each strip or tile a JPEG stream of its own pixels
    (PIL's, subsampling ``sub`` for colour, or ``encode(chunk)``); with
    ``abbreviate`` the streams leave their tables to JPEGTables (PIL's
    tables are the same in every stream unless optimised)."""
    h, w = img.shape[:2]
    streams = []
    for c in chunks_of(img, tile, rows_per_strip):
        if encode is not None:
            streams.append(encode(c))
            continue
        kw = dict(quality=quality, progressive=progressive)
        if img.ndim == 3:
            kw["subsampling"] = sub
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(c)).save(buf, "JPEG", **kw)
        streams.append(buf.getvalue())
    spp = 1 if img.ndim == 2 else 3
    tags = [(258, 3, [8] * spp), (259, 3, [7]), (262, 3, [photometric]), (277, 3, [spp]),
            (284, 3, [1])]
    if abbreviate:
        split = [_jpeg_segments(s) for s in streams]
        tables = [seg for m, seg in split[0][0] if m in (0xC4, 0xDB)]
        streams = [b"\xff\xd8" + b"".join(seg for m, seg in segs if m not in (0xC4, 0xDB)) + rest
                   for segs, rest in split]
        tags.append((347, 7, b"\xff\xd8" + b"".join(tables) + b"\xff\xd9"))
    if photometric == 6:
        tags.append((530, 3, {0: [1, 1], 1: [2, 1], 2: [2, 2]}[sub]))
    return tiff_file(w, h, streams, tags + layout_tags(tile, rows_per_strip, h))


def pil_tiff(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


# -- Deflate -------------------------------------------------------------------

PIL_DEFLATE = ["adobe_L", "adobe_RGB_pred2", "adobe_I16_pred2", "adobe_RGBA", "adobe_1",
               "deflate_L_pred2", "deflate_RGB", "deflate_I16", "deflate_LA_pred2", "deflate_P"]


@pytest.mark.parametrize("kind", PIL_DEFLATE)
@settings(max_examples=4, **SETTINGS)
@given(h=st.integers(1, 45), w=st.integers(1, 45), seed=st.integers(0, 2 ** 16))
def test_pil_deflate_tiff_matches_pil(tmp_path, kind, h, w, seed):
    """PIL's Deflate files: both compression tags (8 "tiff_adobe_deflate",
    32946 "tiff_deflate"), predictors 1 and 2, 8- and 16-bit grey, RGB,
    RGBA, grey + alpha, bilevel and palette."""
    rs = np.random.RandomState(seed)
    rgb = pixels(rs, (h, w, 3)).astype(np.uint8)
    parts = kind.split("_")
    im = {"L": Image.fromarray(rgb[..., 0]), "RGB": Image.fromarray(rgb),
          "I16": Image.fromarray(rs.randint(0, 65536, (h, w)).astype(np.uint16)
                                 // rs.choice([1, 300], (h, w)).astype(np.uint16)),
          "RGBA": Image.fromarray(np.dstack([rgb, rgb[..., :1]])),
          "1": Image.fromarray(rgb[..., 0] > 128), "LA": Image.fromarray(rgb[..., :2]),
          "P": Image.fromarray(rgb).quantize(50)}[parts[1]]
    kw = {"compression": "tiff_adobe_deflate" if parts[0] == "adobe" else "tiff_deflate"}
    if parts[-1] == "pred2":
        kw["tiffinfo"] = {317: 2}
    path = tmp_path / f"{kind}.tif"
    path.write_bytes(pil_tiff(im, **kw))
    assert_port_reads_as_pil(path)


WRITTEN_DEFLATE = ["grey8_tiles_pred2", "rgb16_be_tiles_pred2", "grey16_be_pred2", "grey4_strips",
                   "rgb8_stored", "grey8_fixed", "rgb8_strips_pred2_32946"]


@pytest.mark.parametrize("kind", WRITTEN_DEFLATE)
@settings(max_examples=4, **SETTINGS)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2 ** 16))
def test_written_deflate_tiff_matches_pil(tmp_path, kind, h, w, seed):
    """Deflate that PIL does not write: tiles, big-endian 16-bit samples
    under predictor 2, 4-bit grey, stored blocks (level 0), fixed-Huffman
    blocks, several strips."""
    rs = np.random.RandomState(seed)
    rgb = pixels(rs, (h, w, 3)).astype(np.int64)
    wide = rs.randint(0, 65536, (h, w, 3)) // rs.choice([1, 300], (h, w, 3))
    data = {
        "grey8_tiles_pred2": lambda: deflate_tiff(rgb[..., :1], 8, 1, predictor=2, tile=(16, 16)),
        "rgb16_be_tiles_pred2": lambda: deflate_tiff(wide, 16, 2, predictor=2, be=True,
                                                     tile=(32, 16)),
        "grey16_be_pred2": lambda: deflate_tiff(wide[..., :1], 16, 1, predictor=2, be=True,
                                                rows_per_strip=7),
        "grey4_strips": lambda: deflate_tiff(rgb[..., :1] >> 4, 4, 1, rows_per_strip=3),
        "rgb8_stored": lambda: deflate_tiff(rgb, 8, 2, level=0, rows_per_strip=5),
        "grey8_fixed": lambda: deflate_tiff(rgb[..., :1], 8, 1, strategy=zlib.Z_FIXED),
        "rgb8_strips_pred2_32946": lambda: deflate_tiff(rgb, 8, 2, predictor=2, compression=32946,
                                                        rows_per_strip=4),
    }[kind]()
    path = tmp_path / f"{kind}.tif"
    path.write_bytes(data)
    assert_port_reads_as_pil(path)


def test_deflate_stops_at_the_strip_and_refuses_what_libtiff_refuses(tmp_path):
    """Bytes after a strip's stream are not read; a stream that ends short,
    a bad zlib header and predictor 3 on integer samples (libtiff's
    PredictorSetup refuses it) are corrupt (PIL fails, the datasets take a
    zero image); predictor 3 on float samples, which PIL reads, reads as
    PIL reads it (since A.6.4)."""
    img = pixels(np.random.RandomState(14), (30, 44, 1)).astype(np.int64)
    z = zlib.compress(np.diff(img[..., 0], prepend=0, axis=1).astype(np.uint8).tobytes())
    tags = [(258, 3, [8]), (259, 3, [8]), (262, 3, [1]), (277, 3, [1]), (317, 3, [2]),
            (273, 4, None), (278, 4, [30]), (279, 4, None)]
    assert tiff_file(44, 30, [z], tags) == deflate_tiff(img, 8, 1, predictor=2)
    path = tmp_path / "trailing.tif"
    path.write_bytes(tiff_file(44, 30, [z + b"junk after the stream"], tags))
    assert_port_reads_as_pil(path)
    (tmp_path / "float.tif").write_bytes(deflate_tiff(img, 8, 1).replace(
        struct.pack("<HHII", 317, 3, 1, 1), struct.pack("<HHII", 317, 3, 1, 3)))
    for name, blob in (("short.tif", z[:len(z) // 2]), ("header.tif", b"\x78\x9d" + z[2:]),
                       ("float.tif", None)):
        path = tmp_path / name
        if blob is not None:
            path.write_bytes(tiff_file(44, 30, [blob], tags))
        assert not jdataset.decode_image(path, 16).any()
        assert not tdataset.decode_image(path, 16).any()
        with pytest.raises(ValueError):
            tdataset.decode_gray(path)
    path = tmp_path / "float32.tif"
    Image.fromarray(img[..., 0].astype(np.float32)).save(path, "TIFF",
                                                         compression="tiff_adobe_deflate",
                                                         tiffinfo={317: 3})
    assert jdataset.decode_image(path, 16).any()      # PIL reads it
    assert_port_reads_as_pil(path)


# -- JPEG-in-TIFF ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "RGB", "YCbCr"])
@settings(max_examples=5, **SETTINGS)
@given(h=st.integers(1, 60), w=st.integers(1, 60), quality=st.integers(30, 100),
       strips=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_pil_jpeg_tiff_matches_pil(tmp_path, mode, h, w, quality, strips, seed):
    """PIL's JPEG-in-TIFF (libtiff: abbreviated streams, JPEGTables):
    photometric 1 (L), 2 (RGB, components taken as they are) and 6 (YCbCr,
    converted by libjpeg), in one strip or strips of 8 rows."""
    rs = np.random.RandomState(seed)
    im = Image.fromarray(pixels(rs, (h, w, 3)).astype(np.uint8)).convert(mode)
    kw = dict(compression="jpeg", quality=quality)
    if strips:
        kw["strip_size"] = 8 * w * len(mode if mode != "YCbCr" else "RGB")
    path = tmp_path / f"{mode}.tif"
    path.write_bytes(pil_tiff(im, **kw))
    with Image.open(path) as back:
        assert back.tag_v2[262] == {"L": 1, "RGB": 2, "YCbCr": 6}[mode]
    assert_port_reads_as_pil(path)


WRITTEN_JPEG = ["ycbcr420_strips", "ycbcr422_strips", "ycbcr444_odd_strips",
                "ycbcr420_abbreviated", "ycbcr420_tiles", "ycbcr420_progressive",
                "rgb_as_is_tiles", "rgb_ycc_stream_as_is", "grey_progressive_strips"]


@pytest.mark.parametrize("kind", WRITTEN_JPEG)
@settings(max_examples=4, **SETTINGS)
@given(h=st.integers(1, 50), w=st.integers(1, 50), seed=st.integers(0, 2 ** 16))
def test_written_jpeg_tiff_matches_pil(tmp_path, kind, h, w, seed):
    """JPEG-in-TIFF that PIL does not write: YCbCr subsampled 2 x 2 and
    2 x 1 (each stream upsampled on its own, so nothing crosses a strip's
    edge), strips of any height with a short last one, tiles cropped at the
    image's edge, abbreviated streams, progressive streams, and RGB streams
    whose components are taken as they are (photometric 2: R, G, B ids, or
    a YCbCr-coded stream left unconverted, as libtiff leaves it)."""
    rs = np.random.RandomState(seed)
    rgb = pixels(rs, (h, w, 3)).astype(np.uint8)
    rps = int(rs.randint(1, 20))
    data = {
        "ycbcr420_strips": lambda: jpeg_tiff(rgb, 6, rows_per_strip=16, sub=2),
        "ycbcr422_strips": lambda: jpeg_tiff(rgb, 6, rows_per_strip=rps, sub=1),
        "ycbcr444_odd_strips": lambda: jpeg_tiff(rgb, 6, rows_per_strip=rps, sub=0),
        "ycbcr420_abbreviated": lambda: jpeg_tiff(rgb, 6, rows_per_strip=8, abbreviate=True),
        "ycbcr420_tiles": lambda: jpeg_tiff(rgb, 6, tile=(16, 32), quality=60),
        "ycbcr420_progressive": lambda: jpeg_tiff(rgb, 6, rows_per_strip=rps, progressive=True),
        "rgb_as_is_tiles": lambda: jpeg_tiff(rgb, 2, tile=(16, 16), encode=lambda c: jpeg_bytes(
            c, ((1, 1),) * 3, 85, rgb_ids=True)),
        "rgb_ycc_stream_as_is": lambda: jpeg_tiff(rgb, 2, rows_per_strip=rps, sub=0),
        "grey_progressive_strips": lambda: jpeg_tiff(rgb[..., 0], 1, rows_per_strip=rps,
                                                     progressive=True, quality=70),
    }[kind]()
    path = tmp_path / f"{kind}.tif"
    path.write_bytes(data)
    assert_port_reads_as_pil(path)


def test_jpeg_tiff_refusals(tmp_path):
    """Planar YCbCr (which libtiff's JPEG codec refuses: C.16), a stream
    whose sampling is not the file's (4:2:0 in an RGB file), or that is
    taller than its strip and not the last, is corrupt, as libtiff has it
    (PIL fails; the datasets take a zero image); so is this file marked
    old-style JPEG-in-TIFF
    (compression 6, read since A.6.3), whose 8-row strips are not whole
    rows of its 4:2:0 MCUs."""
    rgb = pixels(np.random.RandomState(15), (24, 40, 3)).astype(np.uint8)
    good = jpeg_tiff(rgb, 6, rows_per_strip=8)

    def stream(rows):
        buf = io.BytesIO()
        Image.fromarray(rows).save(buf, "JPEG", quality=80, subsampling=2)
        return buf.getvalue()
    tall = tiff_file(40, 16, [stream(rgb[:16]), stream(rgb[8:16])],
                     [(258, 3, [8] * 3), (259, 3, [7]), (262, 3, [6]), (277, 3, [3]),
                      (284, 3, [1]), (273, 4, None), (278, 4, [8]), (279, 4, None)])
    short = struct.pack("<HHI", 259, 3, 1)
    planar = struct.pack("<HHI", 284, 3, 1)
    cases = {"old.tif": (good.replace(short + struct.pack("<I", 7), short + struct.pack("<I", 6)),
                         ValueError, "old-style JPEG-in-TIFF strips not whole MCU rows"),
             "planar.tif": (good.replace(planar + struct.pack("<I", 1),
                                         planar + struct.pack("<I", 2)),
                            ValueError, "YCbCr TIFF of JPEG in planes"),
             "sampling.tif": (jpeg_tiff(rgb, 2, rows_per_strip=8, sub=2), ValueError,
                              "sampling factors"),
             "tall.tif": (tall, ValueError, "wrong size")}
    for name, (data, exc, match) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(exc, match=match):
            tdataset.decode_gray(path)
        if exc is ValueError:
            assert not jdataset.decode_image(path, 16).any()


# -- the datasets on every new kind ----------------------------------------------

def new_kinds_tree(root, rs):
    """Two writers' folders of the kinds A.6 added (progressive JPEG,
    Deflate TIFF with predictor 2, JPEG-in-TIFF YCbCr 4:2:0 and grey) and a
    PNG, scans of mixed sizes with pen strokes on paper."""
    for wi in range(2):
        d = root / f"w{wi}"
        d.mkdir(parents=True)
        for k in range(5):
            h, w = 60 + 9 * k + wi, 90 - 5 * k
            page = rs.randint(215, 256, (h, w)).astype(np.uint8)
            for _ in range(10):
                y, x = rs.randint(4, h - 4), rs.randint(4, w - 20)
                page[y - 2:y + 2, x:x + 16] = rs.randint(0, 80)
            rgb = np.dstack([page, page, np.clip(page.astype(int) + 8, 0, 255)]).astype(np.uint8)
            name = d / f"w{wi}_{k}"
            if k == 0:
                Image.fromarray(rgb).save(f"{name}.jpg", quality=85, progressive=True)
            elif k == 1:
                name.with_suffix(".tif").write_bytes(
                    pil_tiff(Image.fromarray(page), compression="tiff_adobe_deflate",
                             tiffinfo={317: 2}))
            elif k == 2:
                name.with_suffix(".tiff").write_bytes(jpeg_tiff(rgb, 6, rows_per_strip=16))
            elif k == 3:
                name.with_suffix(".tif").write_bytes(
                    pil_tiff(Image.fromarray(page), compression="jpeg", quality=90))
            else:
                Image.fromarray(page).save(f"{name}.png")


def test_datasets_read_the_new_kinds_as_jax(tmp_path, monkeypatch):
    """SignatureDataset, PairDataset and cli.preprocess on the tree, equal
    to the JAX package's (its PIL path: the native decoder off)."""
    from siggan_tpu.cli import preprocess as jcli
    from siggan_tpu.core import platform as jplatform
    from siggan_tpu_torch.cli import preprocess as tcli
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(jplatform, "setup", lambda *a, **k: None)
    raw = tmp_path / "raw"
    new_kinds_tree(raw, np.random.RandomState(16))
    j = jdataset.SignatureDataset(raw, 32, use_cache=False)
    t = tdataset.SignatureDataset(raw, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 10
    assert j.images.reshape(10, -1).std(1).min() > 0    # PIL read every file
    np.testing.assert_array_equal(t.images, j.images)
    jp = jpairs.PairDataset(raw, pairs_per_user=4, image_size=32, seed=1)
    tp = tpairs.PairDataset(raw, pairs_per_user=4, image_size=32, seed=1)
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
