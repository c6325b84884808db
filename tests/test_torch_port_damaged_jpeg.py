"""Damaged JPEG data in the port's decoder against PIL, through the JAX
package: read as libjpeg-turbo reads it, bit-equal with PIL's grey.

- Restart markers out of place: libjpeg's ``jpeg_resync_to_restart`` (the
  marker consumed, skipped for the next, or left for an interval read as
  empty) and the entropy decoder's rule once a segment runs out of data
  (that MCU from zero bits, the rest of the interval zero, predictors
  reset at the next restart).
- A bad Huffman code: 17 bits taken, a zero symbol (``jdhuff.c``).
- Coefficients that dequantize past the range of valid data: the arithmetic
  of libjpeg-turbo's SIMD islow IDCT (16-bit lanes, saturating packs), held
  on a file's quantization tables overwritten with q (8-bit, and 16-bit up
  to 65535).
- A JPEG-in-TIFF strip cut short: libtiff hands libjpeg an EOI.
- Random garbage in entropy data, sequential and progressive.

The datasets take these files as the JAX package does, and a dataset cache
of the decoder version before these repairs (d2) is not read."""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import FIXTURES, assert_port_reads_as_pil, load_golden, pixels, \
    tiff_file, with_quantizers

from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative


def pil_l(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L"))


def same_as_pil(data: bytes):
    """Bit-equal with PIL where PIL reads the bytes, corrupt where it fails."""
    try:
        want = pil_l(data)
    except OSError:
        with pytest.raises(ValueError):
            tnative.decode(data)
        return
    np.testing.assert_array_equal(tnative.decode(data), want)


def markers(data: bytes) -> list:
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


def restart_scan(interval: int = 4) -> bytes:
    """scan_420.jpg's page (its own pixels) saved again with restart markers."""
    with Image.open(FIXTURES / "scan_420.jpg") as im:
        rgb = np.asarray(im.convert("RGB"))[:160, :480]
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=90, subsampling=2,
                              restart_marker_blocks=interval)
    return buf.getvalue()


@pytest.mark.parametrize("q", [2, 4, 8, 16, 64, 255])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_out_of_range_quantizers_match_pil(q, mode):
    """Noise at quality 100 (every quantizer 1) with its tables set to q:
    the same coefficients dequantize far out of range, and every q reads
    as PIL's libjpeg-turbo reads it."""
    rs = np.random.RandomState(q)
    for size in (32, 48):
        img = rs.randint(0, 256, (size, size) if mode == "L" else (size, size, 3))
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", quality=100, subsampling=0)
        same_as_pil(with_quantizers(buf.getvalue(), q))


def with_16bit_quantizers(data: bytes, q) -> bytes:
    """The file's quantization tables rewritten at 16-bit precision as q
    (one value, or 64 in zig-zag order)."""
    out, i = bytearray(data[:2]), 2
    while True:
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        if data[i + 1] == 0xDB:
            body = bytearray()
            for j in range(i + 4, i + 2 + n, 65):
                body.append(0x10 | (data[j] & 15))
                body += b"".join(struct.pack(">H", int(v)) for v in np.broadcast_to(q, (64,)))
            out += b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body
        elif data[i + 1] == 0xDA:
            return bytes(out + data[i:])
        else:
            out += data[i:i + 2 + n]
        i += 2 + n


@pytest.mark.parametrize("q", [300, 4097, 32768, 65535, "random"])
def test_16bit_quantizers_wrap_as_in_pil(q):
    """Quantizers past 8 bits, to 65535: the dequantized products and the
    sums in the IDCT wrap to 16 bits as libjpeg-turbo's lanes do."""
    rs = np.random.RandomState(7)
    for mode, quality in (("L", 100), ("RGB", 60)):
        img = rs.randint(0, 256, (32, 40) if mode == "L" else (32, 40, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality, subsampling=0)
        qq = rs.randint(1, 65536, 64) if q == "random" else q
        same_as_pil(with_16bit_quantizers(buf.getvalue(), qq))


@pytest.mark.parametrize("damage", ["first", "middle", "last", "two", "three", "renumber_1",
                                    "renumber_2", "renumber_4", "renumber_6", "renumber_7"])
def test_restart_marker_damage_matches_pil(damage):
    """Restart markers removed (one, two or three in a row: the next is one
    or two ahead, or too far) or renumbered (1, 2 ahead, 4 off, 2 or 1
    behind): each of jpeg_resync_to_restart's three actions."""
    data = restart_scan()
    rst = markers(data)
    d = bytearray(data)
    k = {"first": 0, "last": len(rst) - 1}.get(damage, len(rst) // 2)
    if damage.startswith("renumber"):
        d[rst[k] + 1] = 0xD0 + ((d[rst[k] + 1] - 0xD0 + int(damage[-1])) & 7)
    else:
        for i in sorted(rst[k:k + {"two": 2, "three": 3}.get(damage, 1)], reverse=True):
            del d[i:i + 2]
    assert bytes(d) != data
    same_as_pil(bytes(d))


@pytest.mark.parametrize("at", [600, 3000, 9000])
def test_overwritten_entropy_bytes_match_pil(at):
    """Eight entropy bytes overwritten by 0xFE, with and without restarts."""
    for interval in (0, 4):
        data = bytearray(restart_scan(interval))
        sos = data.index(b"\xff\xda")
        data[sos + at:sos + at + 8] = b"\xfe" * 8
        same_as_pil(bytes(data))


@pytest.mark.parametrize("kind", ["baseline", "progressive", "restarts"])
def test_bad_huffman_code_matches_pil(kind):
    """Twenty-four 1 bits (FF 00 three times, no code of any table): libjpeg
    takes 17 bits and a zero symbol, and goes on."""
    rs = np.random.RandomState(5)
    img = pixels(rs, (64, 96, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80, progressive=kind == "progressive",
                              restart_marker_blocks=3 if kind == "restarts" else 0)
    data = buf.getvalue()
    sos = data.rindex(b"\xff\xda") if kind == "progressive" else data.index(b"\xff\xda")
    for off in (40, 300, 700):
        at = min(sos + off, len(data) - 10)
        at -= data[at - 1] == 0xFF
        same_as_pil(data[:at] + b"\xff\x00" * 3 + data[at:])


@pytest.mark.parametrize("seed", range(6))
def test_random_garbage_matches_pil(seed):
    """A few runs of random bytes in the entropy data of baseline,
    restart-interval and progressive files: PIL's grey, or both fail."""
    rs = np.random.RandomState(100 + seed)
    img = pixels(rs, (48, 72, 3)).astype(np.uint8)
    for kw in (dict(), dict(restart_marker_blocks=2), dict(progressive=True)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, **kw)
        d = bytearray(buf.getvalue())
        sos = d.index(b"\xff\xda")
        for _ in range(rs.randint(1, 4)):
            o, n = rs.randint(sos + 20, len(d) - 10), rs.randint(1, 10)
            d[o:o + n] = rs.randint(0, 256, n).astype(np.uint8).tobytes()
        same_as_pil(bytes(d))


@pytest.mark.parametrize("cut", [0.2, 0.6, 0.99])
def test_jpeg_tiff_strip_cut_short_decodes_as_pil(tmp_path, cut):
    """A JPEG-in-TIFF strip whose stream stops early in its entropy data
    (its byte count cut): libtiff supplies an EOI, PIL decodes the strip,
    and so does the port."""
    rgb = pixels(np.random.RandomState(8), (40, 48, 3)).astype(np.uint8)
    for photometric, img in ((6, rgb), (1, rgb[..., 0])):
        streams = []
        for y in (0, 16, 32):
            buf = io.BytesIO()
            kw = {"subsampling": 2} if img.ndim == 3 else {}
            Image.fromarray(img[y:y + 16]).save(buf, "JPEG", quality=85, **kw)
            streams.append(buf.getvalue())
        sos = streams[1].index(b"\xff\xda")
        streams[1] = streams[1][:sos + int((len(streams[1]) - sos) * cut)]
        spp = 3 if img.ndim == 3 else 1
        tags = [(258, 3, [8] * spp), (259, 3, [7]), (262, 3, [photometric]), (277, 3, [spp]),
                (284, 3, [1]), (273, 4, None), (278, 4, [16]), (279, 4, None)]
        if photometric == 6:
            tags.append((530, 3, [2, 2]))
        path = tmp_path / f"cut{photometric}.tif"
        path.write_bytes(tiff_file(48, 40, streams, tags))
        assert_port_reads_as_pil(path)


def test_damaged_fixtures_and_tiled_page_match_pil():
    """The committed fixtures (a restart marker missing, a bad code, out of
    range quantizers) read as their golden arrays, and ``chip_smoke.
    tile_jpeg``'s page of restart intervals, renumbered 4 ahead now and
    then, reads in PIL as ``tile_golden`` says: the card's restart-damaged
    page needs no golden array of its own."""
    import chip_smoke
    golden = load_golden()
    for name in ("restart_damaged.jpg", "bad_code.jpg", "dqt_q64.jpg", "restart_444.jpg"):
        np.testing.assert_array_equal(tnative.decode((FIXTURES / name).read_bytes()),
                                      golden[name], err_msg=name)
    source = (FIXTURES / "restart_444.jpg").read_bytes()
    pick = chip_smoke.page_pick
    page = chip_smoke.tile_jpeg(source, 400, 100, pick, chip_smoke.renumber_ahead)
    assert len(markers(page)) == 13 * 2 - 1
    want = chip_smoke.tile_golden(golden["restart_444.jpg"], 400, 100, pick)
    np.testing.assert_array_equal(pil_l(page), want)
    np.testing.assert_array_equal(tnative.decode(page), want)


def test_datasets_take_damaged_files_as_jax(tmp_path, monkeypatch):
    """A tree of damaged scans (missing restart marker, bad code, out of
    range quantizers, garbage PIL refuses) builds in both packages'
    SignatureDataset with equal arrays; before this repair the port took
    the first two as zero images."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    d = tmp_path / "raw"
    d.mkdir()
    for name in ("restart_damaged.jpg", "bad_code.jpg", "dqt_q64.jpg"):
        (d / name).write_bytes((FIXTURES / name).read_bytes())
    (d / "junk.jpg").write_bytes(b"\xff\xd8\xff\xc0" + bytes(40))
    j = jdataset.SignatureDataset(d, 32, use_cache=False)
    t = tdataset.SignatureDataset(d, 32, use_cache=False)
    np.testing.assert_array_equal(t.images, j.images)
    assert [p.name for p in t.paths] == ["bad_code.jpg", "dqt_q64.jpg", "junk.jpg",
                                         "restart_damaged.jpg"]
    assert [bool(x.any()) for x in t.images] == [True, True, False, True]


def test_cache_of_the_older_decoder_is_not_read(tmp_path):
    """DECODE_VERSION is d11 (d3 since these repairs, d4 since C.13's, d5
    since damaged CCITT data decodes, d6 since damaged ZSTD literals read as
    libzstd reads them, d7 since old-style JPEG-in-TIFF without its last
    strip's data reads as libtiff reads it, d8 since planar YCbCr
    old-style JPEG-in-TIFF, GIF and Netpbm read, d9 since BMP files read as
    PIL reads a pixel offset of 0 and its grey palettes, d10 since
    old-style JPEG-in-TIFF headers skip as libtiff skips, d11 since a JPEG
    scan header's components are looked up as libjpeg-turbo looks them
    up): a d2 to d10 cache beside the data (what an older decoder wrote,
    zero images where files now decode) is not read; the new cache carries
    d11."""
    assert tnative.DECODE_VERSION == "d11"
    d = tmp_path / "raw"
    d.mkdir()
    (d / "restart_damaged.jpg").write_bytes((FIXTURES / "restart_damaged.jpg").read_bytes())
    ds = tdataset.SignatureDataset(d, 16, use_cache=True)
    cache = ds._cache_path()
    assert "_d11_" in cache.name and cache.exists()
    cache.unlink()
    for old in ("_d2_", "_d3_", "_d4_", "_d5_", "_d6_", "_d7_", "_d8_", "_d9_", "_d10_"):
        np.save(cache.with_name(cache.name.replace("_d11_", old)), np.zeros((1, 16, 16, 1), np.float32))
    again = tdataset.SignatureDataset(d, 16, use_cache=True)
    assert again.images.any()
    np.testing.assert_array_equal(again.images, ds.images)


def with_component_ids(data: bytes, frame_ids, scan_ids) -> bytes:
    """A baseline JPEG with its frame's component ids and its scan's
    replaced."""
    d = bytearray(data)
    sof, sos = d.index(b"\xff\xc0"), d.index(b"\xff\xda")
    for k, v in enumerate(frame_ids):
        d[sof + 10 + 3 * k] = v
    for k, v in enumerate(scan_ids):
        d[sos + 5 + 2 * k] = v
    return bytes(d)


@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("frame_ids", [(1, 2, 3), (3, 2, 1), (1, 1, 3), (1, 2, 2), (2, 2, 2), (1, 3, 1)])
def test_scan_component_ids_looked_up_as_libjpeg(frame_ids, subsampling):
    """C.27: jdmarker.c get_sos takes a scan's i-th id as the first of the
    frame's components of that id whose index finds the scan's slot of that
    number empty, and fails on a component named twice. So a scan out of
    the frame's order is corrupt (PIL: "broken data stream"), and a frame
    that repeats an id reads its components in order; every scan of ids
    1 .. 4 against each frame, read or refused as PIL."""
    buf = io.BytesIO()
    Image.fromarray(pixels(np.random.RandomState(3), (16, 16, 3)).astype(np.uint8)).save(
        buf, "JPEG", quality=85, subsampling=subsampling)
    read = 0
    for scan_ids in np.ndindex(4, 4, 4):
        data = with_component_ids(buf.getvalue(), frame_ids, [i + 1 for i in scan_ids])
        same_as_pil(data)
        try:
            pil_l(data)
            read += 1
        except OSError:
            pass
    assert 0 < read < 64


def dht_segment(tc: int, th: int, counts, vals) -> bytes:
    body = bytes([tc << 4 | th]) + bytes(counts) + bytes(vals)
    return b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body


HUFFMAN_TABLES = {   # (class, slot, counts, symbols): a DC table of 12 codes, or two codes of 1 bit
    "dc_symbol_16": (0, 0, [0, 1, 5, 1, 1, 1, 1, 1, 1] + [0] * 7, list(range(11)) + [16]),
    "dc_symbol_200": (0, 0, [0, 1, 5, 1, 1, 1, 1, 1, 1] + [0] * 7, list(range(11)) + [200]),
    "chroma_dc_symbol_16": (0, 1, [0, 1, 5, 1, 1, 1, 1, 1, 1] + [0] * 7, list(range(11)) + [16]),
    "dc_all_ones": (0, 0, [2] + [0] * 15, [0, 1]),
    "ac_all_ones": (1, 0, [2] + [0] * 15, [0, 1]),
    "dc_symbol_15": (0, 0, [0, 1, 5, 1, 1, 1, 1, 1, 1] + [0] * 7, list(range(11)) + [15]),
}


@pytest.mark.parametrize("slot_used", [True, False])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("table", sorted(HUFFMAN_TABLES))
def test_huffman_tables_checked_when_a_scan_uses_them(table, progressive, slot_used):
    """C.27: libjpeg checks a Huffman table (jdhuff.c
    jpeg_make_d_derived_tbl: codes that fit, none all ones; a DC symbol at
    most 15 in a lossy frame) when a scan that uses it starts, not at DHT:
    the same table in a slot no scan uses (3) reads; in the slot the first
    scan uses, it is refused where it breaks those rules."""
    tc, th, counts, vals = HUFFMAN_TABLES[table]
    buf = io.BytesIO()
    Image.fromarray(pixels(np.random.RandomState(5), (16, 16, 3)).astype(np.uint8)).save(
        buf, "JPEG", quality=85, progressive=progressive)
    data = buf.getvalue()
    sos = data.index(b"\xff\xda")
    same_as_pil(data[:sos] + dht_segment(tc, th if slot_used else 3, counts, vals) + data[sos:])
