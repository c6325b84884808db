"""LZMA and ZSTD TIFF (compressions 34925 and 50000; ROADMAP A.6.13,
A.6.14) in the port's own xz and Zstandard decoders
(``data/native/decode.cpp``: ``unxz``, ``unzstd``), against PIL through the
JAX package.

Every layout the Deflate tests cover is built in both codecs by
``chip_smoke``'s writers (LZMA as libtiff writes it: one .xz stream of Delta
and LZMA2 with no check; ZSTD a frame from the ``zstandard`` package):
strips, tiles, planar, BigTIFF, predictors 2 and 3, FillOrder 2, 16-bit,
RGB, YCbCr. PIL's own files in both. Then the streams libtiff's codecs
read otherwise than the format's spec says, each first put to PIL:
liblzma is asked only to fill the strip (what follows the data that fills
it is not read; a stream that ends or fails before fails the strip), libzstd
stops at the first frame's end and decodes a block past a strip it filled
to the block's end. Each case is bit-equal with PIL's ``convert("L")``
(``assert_port_reads_as_pil``) or, where PIL refuses, corrupt: a zero image
and ``ValueError``. A damaged strip on the YCbCr route keeps what the
codec decoded before it failed, as libtiff's RGBA reader does.
"""

import io
import lzma
import struct
import zlib

import numpy as np
import pytest
import zstandard
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels, tiff_file

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu.verify import pairs as jpairs
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative
from siggan_tpu_torch.verify import pairs as tpairs

LZMA, ZSTD = 34925, 50000
CODECS = {"lzma": LZMA, "zstd": ZSTD}
H, W = 13, 19
RS = np.random.RandomState(19)
RGB = pixels(RS, (H, W, 3)).astype(np.int64)
LAYOUTS = {"strips": dict(rows_per_strip=5), "one_strip": dict(), "tiles": dict(tile=(16, 16))}


def pil_reads(data: bytes) -> bool:
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.convert("L")
        return True
    except Exception:
        return False


def holds(tmp_path, data: bytes, reads: bool, what: str = ""):
    """PIL reads the file or refuses it, as ``reads`` says; the port does
    the same: bit-equal with PIL, or corrupt (a zero image, ValueError)."""
    assert pil_reads(data) == reads
    path = tmp_path / "f.tif"
    path.write_bytes(data)
    if reads:
        assert_port_reads_as_pil(path)
        return
    assert not jdataset.decode_image(path, 16).any()
    assert not tdataset.decode_image(path, 16).any()
    with pytest.raises(ValueError, match=what or None):
        tdataset.decode_gray(path)


def grey_strip(blob: bytes, compression: int, w: int = W, h: int = H) -> bytes:
    """An 8-bit grey TIFF of one strip whose bytes are ``blob``."""
    return tiff_file(w, h, [blob], [(258, 3, [8]), (259, 3, [compression]), (262, 3, [1]),
                                    (277, 3, [1]), (273, 4, None), (278, 4, [h]), (279, 4, None)])


GREY_RAW = RGB[..., 0].astype(np.uint8).tobytes()


# -- every layout ----------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", ["grey", "rgb", "bilevel", "grey16", "rgb16", "grey_pred2",
                                  "rgb_pred2", "grey16_pred2", "planar_rgb", "bigtiff",
                                  "fill_order_2"])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_layout_reads_as_pil(tmp_path, codec, kind, layout):
    c = CODECS[codec]
    kw = dict(compression=c, **LAYOUTS[layout])
    if kind.startswith("grey16"):
        samples, bits, photo = RGB[..., :1] * 257, 16, 1
    elif kind.startswith("rgb16"):
        samples, bits, photo = RGB * 257, 16, 2
    elif kind.startswith("rgb") or kind == "planar_rgb":
        samples, bits, photo = RGB, 8, 2
    elif kind == "bilevel":
        samples, bits, photo = RGB[..., :1] > 128, 1, 1
    else:
        samples, bits, photo = RGB[..., :1], 8, 1
    if kind.endswith("pred2"):
        kw["predictor"] = 2
    if kind == "planar_rgb":
        kw["planar"] = 2
    if kind == "bigtiff":
        kw["big"] = True
    if kind == "fill_order_2":
        kw["fill"] = 2
    holds(tmp_path, chip_smoke.tiff_layout(np.asarray(samples, np.int64), bits, photo, **kw), True)


@pytest.mark.parametrize("dtype,predictor", [("<f4", 1), ("<f4", 3), (">f4", 3), ("<i2", 1),
                                             ("<i2", 2), ("<u4", 1)])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_number_formats_read_as_pil(tmp_path, codec, dtype, predictor):
    """Grey numbers, with libtiff's floating-point predictor on floats."""
    v = (RGB[..., 0] - 100).astype(np.float64) * (3.7 if "f" in dtype else 1)
    fmt = 3 if "f" in dtype else 2 if "i" in dtype else 1
    if fmt == 1:
        v = np.abs(v)
    holds(tmp_path, chip_smoke.tiff_numbers(v, dtype, fmt, rows_per_strip=4, predictor=predictor,
                                            compression=CODECS[codec]), True)


@pytest.mark.parametrize("layout", ["strips", "one_strip", "tiles"])
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ycbcr_reads_as_pil(tmp_path, codec, sub, layout):
    """YCbCr outside JPEG through libtiff's RGBA reader, and planar."""
    rs = np.random.RandomState(sum(sub))
    y = pixels(rs, (H, W)).astype(np.uint8)
    shape = (-(-H // sub[1]), -(-W // sub[0]))
    cb, cr = (rs.randint(0, 256, shape).astype(np.uint8) for _ in range(2))
    kw = dict(rows_per_strip=4) if layout == "strips" else dict(tile=(16, 16)) if layout == "tiles" else {}
    holds(tmp_path, chip_smoke.tiff_ycbcr(y, cb, cr, sub, compression=CODECS[codec], **kw), True)
    if sub == (1, 1) and layout == "strips":
        holds(tmp_path, chip_smoke.tiff_ycbcr(y, cb, cr, sub, compression=CODECS[codec], planar=2,
                                              rows_per_strip=4), True)


@pytest.mark.parametrize("mode", ["L", "RGB", "1", "I;16", "RGBA", "CMYK", "P", "F", "LA"])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_pil_written_files_read_as_pil(tmp_path, codec, mode):
    a = RGB.astype(np.uint8)
    img = (Image.fromarray(a[..., 0].astype(np.uint16) * 257) if mode == "I;16" else
           Image.fromarray(a[..., 0].astype(np.float32) * 1.5, "F") if mode == "F" else
           Image.fromarray(a).convert(mode))
    buf = io.BytesIO()
    img.save(buf, "TIFF", compression=codec)
    holds(tmp_path, buf.getvalue(), True)


# -- LZMA streams ----------------------------------------------------------------

def xz(raw: bytes = GREY_RAW, check=lzma.CHECK_NONE, filters=None, **kw) -> bytes:
    return lzma.compress(raw, lzma.FORMAT_XZ, check=check,
                         filters=filters or [{"id": lzma.FILTER_LZMA2, **kw}])


def bcj_data(rs, n: int) -> bytes:
    """Bytes rich in the branch opcodes every BCJ filter converts."""
    return bytes(rs.choice([0xE8, 0xE9, 0xEB, 0x48, 0x49, 0x4B, 0x40, 0x7F, 0xF0, 0xF8, 0x10,
                            0x00, 0xFF, 0x01, 0x02], n).tolist())


def xz_blocks(*streams: bytes) -> bytes:
    """One .xz stream of the blocks of single-block ``streams`` (same
    check): the first's header, each block as it is, and the first's index
    and footer (not read: the strip is full at the last block's end)."""
    out = bytearray(streams[0][:12])
    for s in streams:
        out += s[12:xz_index_at(s)]
    return bytes(out + streams[0][xz_index_at(streams[0]):])


def xz_index_at(s: bytes) -> int:
    """Where a single-block stream's index starts (the footer's backward size)."""
    backward = (struct.unpack_from("<I", s, len(s) - 8)[0] + 1) * 4
    return len(s) - 12 - backward


def with_block_header(s: bytes, edit) -> bytes:
    """A single-block stream with its block header ``edit``ed (a bytearray
    in place) and its CRC32 made good again."""
    size = (s[12] + 1) * 4
    h = bytearray(s[12:12 + size])
    edit(h)
    struct.pack_into("<I", h, size - 4, zlib.crc32(bytes(h[:size - 4])))
    return s[:12] + bytes(h) + s[12 + size:]


def xz_cases():
    rs = np.random.RandomState(7)
    grey = GREY_RAW
    full = xz(grey, lzma.CHECK_CRC32)
    big_grey = np.tile(RGB[..., 0].astype(np.uint8), (20, 30))
    noisy = big_grey.copy()
    noisy[rs.rand(*noisy.shape) < 0.5] = 9
    half = len(grey) // 2
    block = bytes(rs.randint(0, 256, 8192).tolist())
    twice = block + block
    cases = {  # name: (strip bytes, width, height, PIL reads)
        "check_none": (xz(grey), W, H, True),
        "check_crc32": (xz(grey, lzma.CHECK_CRC32), W, H, True),
        "check_crc64": (xz(grey, lzma.CHECK_CRC64), W, H, True),
        "check_sha256": (xz(grey, lzma.CHECK_SHA256), W, H, True),
        "delta_2": (xz(grey, filters=[{"id": lzma.FILTER_DELTA, "dist": 2},
                                      {"id": lzma.FILTER_LZMA2}]), W, H, True),
        "lc0_lp4_pb2": (xz(grey, lc=0, lp=4, pb=2), W, H, True),
        "lc4_lp0_pb4": (xz(grey, lc=4, lp=0, pb=4), W, H, True),
        "incompressible_chunks": (xz(bytes(rs.randint(0, 256, W * H).tolist())), W, H, True),
        "many_chunks": (xz(noisy.tobytes(), preset=9), noisy.shape[1], noisy.shape[0], True),
        # Past the data that fills the strip nothing is read.
        "cut_footer": (full[:-12], W, H, True),
        "cut_index_and_check": (full[:xz_index_at(full) - 4], W, H, True),
        "bad_check": (full[:xz_index_at(full) - 4] + b"\0\0\0\0" + full[xz_index_at(full):], W, H,
                      True),
        "junk_after": (full + b"junk", W, H, True),
        # Two blocks: the first ends before the strip is full, so its
        # padding and check are read.
        "two_blocks": (xz_blocks(xz(grey[:half], lzma.CHECK_CRC64), xz(grey[half:], lzma.CHECK_CRC64)),
                       W, H, True),
        "two_blocks_sha256": (xz_blocks(xz(grey[:half], lzma.CHECK_SHA256),
                                        xz(grey[half:], lzma.CHECK_SHA256)), W, H, True),
        # Refused: not an .xz stream; the stream ends or fails before the
        # strip is full.
        "format_alone": (lzma.compress(grey, lzma.FORMAT_ALONE), W, H, False),
        "format_raw": (lzma.compress(grey, lzma.FORMAT_RAW, filters=[{"id": lzma.FILTER_LZMA2}]),
                       W, H, False),
        "two_streams": (xz(grey[:half]) + xz(grey[half:]), W, H, False),
        "cut_data": (full[:len(full) // 2], W, H, False),
        "two_blocks_first_check_bad": (xz_blocks(
            (lambda s: s[:xz_index_at(s) - 8] + b"\1" * 8 + s[xz_index_at(s):])(
                xz(grey[:half], lzma.CHECK_CRC64)), xz(grey[half:], lzma.CHECK_CRC64)), W, H, False),
        "short_stream": (xz(grey[:half]), W, H, False),
        "reserved_block_flag": (with_block_header(xz(grey), lambda h: h.__setitem__(1, h[1] | 0x10)),
                                W, H, False),
        # A match 8 KB back under a 4 KB dictionary: liblzma's error though
        # the strip holds those bytes.
        "lzma2_dictionary_too_small": (with_block_header(
            xz(twice, dict_size=1 << 20), lambda h: h.__setitem__(h.index(0x21) + 2, 0)),
            128, 128, False),
        "lzma2_dictionary_large_enough": (with_block_header(
            xz(twice, dict_size=1 << 20), lambda h: h.__setitem__(h.index(0x21) + 2, 2)),
            128, 128, True),
    }
    for fid, name in [(lzma.FILTER_X86, "x86"), (lzma.FILTER_POWERPC, "powerpc"),
                      (lzma.FILTER_IA64, "ia64"), (lzma.FILTER_ARM, "arm"),
                      (lzma.FILTER_ARMTHUMB, "armthumb"), (lzma.FILTER_SPARC, "sparc")]:
        for start in (0, 64):
            f = {"id": fid, **({"start_offset": start} if start else {})}
            cases[f"bcj_{name}_{start}"] = (xz(bcj_data(rs, W * H), filters=[f, {"id": lzma.FILTER_LZMA2}]),
                                            W, H, True)
    return cases


XZ_CASES = xz_cases()


@pytest.mark.parametrize("name", sorted(XZ_CASES))
def test_xz_stream_reads_as_pil(tmp_path, name):
    blob, w, h, reads = XZ_CASES[name]
    holds(tmp_path, grey_strip(blob, LZMA, w, h), reads)


def bcj_filter_tiff(filter_id: int = 0x0A, seed: int = 3) -> bytes:
    """A grey LZMA TIFF whose stream's BCJ filter is liblzma's ARM64 (0x0A)
    or RISC-V (0x0B): x86 BCJ data with the filter ID patched (Python's
    ``lzma`` writes neither). PIL reads it; the port not yet (ROADMAP A.6),
    so tests use it as their kind the port does not read."""
    s = with_block_header(xz(bcj_data(np.random.RandomState(seed), W * H),
                             filters=[{"id": lzma.FILTER_X86}, {"id": lzma.FILTER_LZMA2}]),
                          lambda h: h.__setitem__(2, filter_id))
    return grey_strip(s, LZMA)


def test_xz_filters_liblzma_has_and_the_port_does_not_yet_raise_a6():
    """ARM64 and RISC-V BCJ (liblzma 5.4 on; PIL's reads them): A.6."""
    data = bcj_filter_tiff()
    assert pil_reads(data)
    with pytest.raises(NotImplementedError, match="ARM64.*A.6"):
        tnative.decode(data)


# -- ZSTD frames -----------------------------------------------------------------

def zst(raw: bytes = GREY_RAW, **kw) -> bytes:
    return zstandard.ZstdCompressor(**kw).compress(raw)


def with_content_size(frame: bytes, size: int) -> bytes:
    """The frame with its content size field (as wide as it is) set to
    ``size``."""
    fhd = frame[4]
    width = {0: 1 if fhd & 0x20 else 0, 1: 2, 2: 4, 3: 8}[fhd >> 6]
    at = 5 + (0 if fhd & 0x20 else 1) + {0: 0, 1: 1, 2: 2, 3: 4}[fhd & 3]
    value = size - 256 if width == 2 else size
    assert width and 0 <= value < 1 << 8 * width
    return frame[:at] + value.to_bytes(width, "little") + frame[at + width:]


def zstd_cases():
    rs = np.random.RandomState(8)
    grey = GREY_RAW
    big = np.tile(RGB[..., 0].astype(np.uint8), (40, 40))
    big[rs.rand(*big.shape) < 0.3] = 3
    bw, bh = big.shape[1], big.shape[0]
    plain = bytearray(zst(grey, write_content_size=False))
    checked = zst(grey, write_checksum=True)
    dict_data = zstandard.train_dictionary(1024, [bytes(rs.randint(0, 20, 500).tolist())
                                                  for _ in range(200)])
    # A raw block (noise is stored) cut just past the strip's bytes: libzstd
    # hands on a raw block's bytes as they come.
    raw_frame = zst(bytes(rs.randint(0, 256, W * H + 50).tolist()), write_content_size=False)
    assert (raw_frame[6] >> 1) & 3 == 0
    cases = {  # name: (strip bytes, width, height, PIL reads)
        "level_1": (zst(grey, level=1), W, H, True),
        "level_19": (zst(grey, level=19), W, H, True),
        "level_22": (zst(grey, level=22), W, H, True),
        "level_minus_5": (zst(grey, level=-5), W, H, True),
        "no_content_size": (bytes(plain), W, H, True),
        "checksum": (checked, W, H, True),
        "big_level_1": (zst(big.tobytes(), level=1), bw, bh, True),
        "big_level_19_no_size": (zst(big.tobytes(), level=19, write_content_size=False), bw, bh,
                                 True),
        "big_level_3_checksum": (zst(big.tobytes(), level=3, write_checksum=True), bw, bh, True),
        "noise": (zst(bytes(rs.randint(0, 256, W * H).tolist())), W, H, True),
        "junk_after": (zst(grey) + b"xx", W, H, True),
        "window_log_27": (bytes(plain[:5]) + bytes([0x88]) + bytes(plain[6:]), W, H, True),
        "raw_block_data_cut_at_the_strip": (raw_frame[:6 + 3 + W * H], W, H, True),
        "raw_block_data_cut_before_the_strip": (raw_frame[:6 + 3 + W * H - 1], W, H, False),
        # Refused.
        "bad_checksum": (checked[:-1] + bytes([checked[-1] ^ 1]), W, H, False),
        "two_frames": (zst(grey[:100]) + zst(grey[100:]), W, H, False),
        "skippable_frame_first": (b"\x50\x2a\x4d\x18" + struct.pack("<I", 4) + b"abcd" + zst(grey),
                                  W, H, False),
        "dictionary": (zstandard.ZstdCompressor(dict_data=dict_data).compress(grey), W, H, False),
        "window_log_28": (bytes(plain[:5]) + bytes([0x90]) + bytes(plain[6:]), W, H, False),
        "window_log_27_and_an_eighth": (bytes(plain[:5]) + bytes([0x89]) + bytes(plain[6:]), W, H,
                                        False),
        "cut": (zst(grey)[:-5], W, H, False),
        "content_size_short": (zst(grey[:-1]), W, H, False),
        "content_size_long": (with_content_size(zst(grey), len(grey) + 7), W, H, False),
        "reserved_frame_bit": (zst(grey)[:4] + bytes([zst(grey)[4] | 8]) + zst(grey)[5:], W, H,
                               False),
    }
    return cases


ZSTD_CASES = zstd_cases()


@pytest.mark.parametrize("name", sorted(ZSTD_CASES))
def test_zstd_frame_reads_as_pil(tmp_path, name):
    blob, w, h, reads = ZSTD_CASES[name]
    holds(tmp_path, grey_strip(blob, ZSTD, w, h), reads)


# -- damage ----------------------------------------------------------------------

def damage(rs, blob: bytes) -> bytes:
    b = bytearray(blob)
    kind = rs.randint(4)
    if kind == 0:
        for _ in range(rs.randint(1, 3)):
            p = rs.randint(len(b))
            b[p] ^= 1 << rs.randint(8)
    elif kind == 1:
        b[rs.randint(len(b))] = rs.randint(256)
    elif kind == 2:
        del b[rs.randint(len(b) + 1):]
    else:
        p = rs.randint(len(b) + 1)
        b[p:p] = bytes(rs.randint(0, 256, rs.randint(1, 4)).tolist())
    return bytes(b)


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("route", ["grey", "ycbcr"])
def test_damaged_strips_read_as_pil(tmp_path, route, codec):
    """A strip damaged at random, 30 files: refused where PIL refuses, read
    bit-equal where it reads (the YCbCr route reads on from a strip its
    codec could not finish: what the codec decoded, then zeros)."""
    rs = np.random.RandomState(2 * (route == "ycbcr") + (codec == "zstd"))
    verdicts = []
    for _ in range(30):
        h, w = int(rs.randint(4, 30)), int(rs.randint(4, 40))
        if route == "grey":
            img = pixels(rs, (h, w)).astype(np.int64)[..., None]
            data = chip_smoke.tiff_layout(img, 8, 1, compression=CODECS[codec], rows_per_strip=4)
        else:
            y = pixels(rs, (h, w)).astype(np.uint8)
            cb, cr = (rs.randint(0, 256, (-(-h // 2), -(-w // 2))).astype(np.uint8) for _ in range(2))
            data = chip_smoke.tiff_ycbcr(y, cb, cr, (2, 2), compression=CODECS[codec], rows_per_strip=4)
        t = chip_smoke.tiff_strips(data)
        strips = list(t["strips"])
        i = rs.randint(len(strips))
        strips[i] = damage(rs, strips[i])
        keep = [(tag, 3, t[tag]) for tag in (258, 259, 262, 277, 284, 530) if tag in t]
        data = chip_smoke.tiff_pack(w, h, strips, keep + [
            (273, 4, lambda o: o), (278, 4, t[278]), (279, 4, [len(s) for s in strips])])
        reads = pil_reads(data)
        verdicts.append(reads)
        holds(tmp_path, data, reads)
    assert any(verdicts)


# -- C.15: damaged Huffman literals, as libzstd's x86-64 decoders read them ---------

def code_lengths(rs, k: int, most: int) -> list:
    """Code lengths of a complete prefix code of up to ``k`` symbols, none
    longer than ``most``: leaves split at random."""
    lens = [1, 1]
    while len(lens) < k:
        can = [i for i, n in enumerate(lens) if n < most]
        if not can:
            break
        i = can[rs.randint(len(can))]
        lens[i] += 1
        lens.insert(i + 1, lens[i])
    rs.shuffle(lens)
    return lens


def literals_frame(rs, regen: int, streams: int):
    """A ZSTD frame of one compressed block of ``regen`` Huffman-coded
    literals and no sequences (so its content is the literals): a random
    complete code over up to 59 symbols (direct weights, 1 to 12 bits; the
    canonical codes of RFC 8878 4.2.1.3), the literals drawn from them, in
    1 or 4 streams (each a backward bit stream, its highest 1 bit the end
    mark), then one stream damaged: bits flipped, a byte replaced, cut,
    bytes inserted, or replaced by random bytes. None where the sizes do
    not fit the header this writer uses."""
    lens = code_lengths(rs, rs.randint(2, 60), rs.randint(2, 13))
    syms = sorted(rs.choice(128, len(lens), replace=False).tolist())
    most = max(lens)
    order = sorted(range(len(lens)), key=lambda i: (-lens[i], syms[i]))
    codes, at = {}, 0
    for i in order:  # weights ascending from index 0, symbols ascending within
        codes[syms[i]] = format(at >> (most - lens[i]), f"0{lens[i]}b")
        at += 1 << (most - lens[i])
    weight = {sym: most + 1 - n for sym, n in zip(syms, lens)}
    explicit = [weight.get(sym, 0) for sym in range(syms[-1])]  # the last is implied
    tree = bytes([127 + len(explicit)]) + bytes(
        (explicit[i] << 4) | (explicit[i + 1] if i + 1 < len(explicit) else 0)
        for i in range(0, len(explicit), 2))
    data = rs.choice(syms, regen).tolist()

    def stream(part):
        bits = "".join(codes[sym] for sym in part)
        value = (1 << len(bits)) | (int(bits, 2) if bits else 0)
        return value.to_bytes((len(bits) + 8) // 8, "little")
    seg = -(-regen // 4)
    parts = [stream(data)] if streams == 1 else [stream(data[i * seg:(i + 1) * seg])
                                                 for i in range(4)]
    i = rs.randint(len(parts))
    b, kind = bytearray(parts[i]), rs.randint(5)
    if kind == 0:
        for _ in range(rs.randint(1, 4)):
            b[rs.randint(len(b))] ^= 1 << rs.randint(8)
    elif kind == 1:
        b[rs.randint(len(b))] = rs.randint(256)
    elif kind == 2 and len(b) > 1:
        del b[rs.randint(1, len(b)):]
    elif kind == 3:
        p = rs.randint(len(b) + 1)
        b[p:p] = bytes(rs.randint(0, 256, rs.randint(1, 4)).tolist())
    else:
        b = bytearray(rs.randint(0, 256, max(1, len(b) + rs.randint(-3, 4))).tolist())
    parts[i] = bytes(b)
    payload = tree + (parts[0] if streams == 1 else
                      struct.pack("<HHH", *[len(q) for q in parts[:3]]) + b"".join(parts))
    size_format = 0 if streams == 1 else 1 if max(regen, len(payload)) < 1024 else 2
    width = 10 if size_format < 2 else 14
    if max(regen, len(payload)) >= 1 << width or (streams == 1 and regen >= 1024):
        return None
    head = (2 | size_format << 2 | regen << 4 | len(payload) << (4 + width)).to_bytes(
        3 if size_format < 2 else 4, "little")
    block = head + payload + b"\x00"
    return (struct.pack("<IBI", 0xFD2FB528, 0xA0, regen)
            + (1 | 2 << 1 | len(block) << 3).to_bytes(3, "little") + block)


def pil_grey_or_none(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("L"))
    except Exception:
        return None


@pytest.mark.parametrize("part", range(4))
def test_damaged_literals_read_as_pil(part):
    """C.15: 500 frames a part (2,000 in all) of damaged Huffman literals,
    from 6 to 12,000 of them (X1 and X2 tables, the fast path and the
    checked one, 1 and 4 streams), each a one-row ZSTD TIFF: the port reads
    what PIL (libzstd 1.5.7) reads, byte for byte, and refuses what it
    refuses. The decoder before C.15's repair read some 10 % of such files
    otherwise."""
    verdicts = []
    for seed in range(500 * part, 500 * part + 500):
        rs = np.random.RandomState(seed)
        regen = int(rs.choice([rs.randint(6, 100), rs.randint(100, 3000), rs.randint(3000, 12000)]))
        streams = 1 if rs.rand() < 0.15 else 4
        frame = literals_frame(rs, min(regen, 1023) if streams == 1 else regen, streams)
        if frame is None:
            continue
        n = struct.unpack_from("<I", frame, 5)[0]
        data = grey_strip(frame, ZSTD, n, 1)
        want = pil_grey_or_none(data)
        verdicts.append(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"seed {seed}")
    assert 0.2 < np.mean(verdicts) < 0.8 and len(verdicts) > 450


def literal_span(frame: bytes):
    """(start, end) of the first block's literal section in a ZSTD frame, or
    None when that block is not compressed with Huffman literals."""
    fhd = frame[4]
    at = 5 + (0 if fhd & 0x20 else 1) + (0, 1, 2, 4)[fhd & 3]
    at += (1 if fhd & 0x20 else 0, 2, 4, 8)[fhd >> 6]
    if (frame[at] >> 1) & 3 != 2 or frame[at + 3] & 3 < 2:
        return None
    lit = at + 3
    sf = (frame[lit] >> 2) & 3
    hs, width = (3, 10) if sf < 2 else (4, 14) if sf == 2 else (5, 18)
    v = int.from_bytes(frame[lit:lit + hs], "little")
    return lit, lit + hs + ((v >> (4 + width)) & ((1 << width) - 1))


def test_damaged_zstd_strips_in_their_literals_read_as_pil():
    """C.15 on real strips: 240 grey scans' ZSTD strips (the ``zstandard``
    package, levels 1 to 19) damaged inside their first block's Huffman
    literals: the port reads each as PIL does, or refuses it where PIL does."""
    rs = np.random.RandomState(15)
    done = 0
    while done < 240:
        h, w = int(rs.randint(20, 60)), int(rs.randint(40, 200))
        img = pixels(rs, (h, w)).astype(np.uint8)
        frame = zstandard.ZstdCompressor(level=int(rs.randint(1, 20))).compress(img.tobytes())
        span = literal_span(frame)
        if span is None:
            continue
        b = bytearray(frame)
        for _ in range(rs.randint(1, 3)):
            b[rs.randint(span[0] + 1, span[1])] ^= 1 << rs.randint(8)
        data = grey_strip(bytes(b), ZSTD, w, h)
        want = pil_grey_or_none(data)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want)
        done += 1


# -- the datasets ------------------------------------------------------------------

def tree(root):
    rs = np.random.RandomState(21)
    for wi in range(2):
        d = root / f"writer{wi}"
        d.mkdir(parents=True)
        for k, (codec, kind) in enumerate([("lzma", "L"), ("zstd", "L"), ("lzma", "RGB"),
                                           ("zstd", "1")]):
            scan = Image.fromarray(pixels(rs, (30 + 4 * k, 60 - 3 * k)).astype(np.uint8))
            scan.convert(kind).save(d / f"w{wi}_{k}.tif", compression=codec)
        Image.fromarray(pixels(rs, (30, 50)).astype(np.uint8)).save(d / f"w{wi}_png.png")
        (d / f"w{wi}_bad.tif").write_bytes(grey_strip(zst(GREY_RAW)[:-5], ZSTD))  # refused: zero


def test_datasets_read_lzma_and_zstd_as_jax(tmp_path, monkeypatch):
    """``SignatureDataset`` and ``PairDataset`` over LZMA and ZSTD scans (a
    refused one among them) equal the JAX package's, its native decoder
    off."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    tree(tmp_path)
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 12
    np.testing.assert_array_equal(t.images, j.images)
    assert sum(not x.any() for x in t.images) == 2
    jp = jpairs.PairDataset(tmp_path, pairs_per_user=4, image_size=32, seed=5)
    tp = tpairs.PairDataset(tmp_path, pairs_per_user=4, image_size=32, seed=5)
    np.testing.assert_array_equal(tp.img1, jp.img1)
    np.testing.assert_array_equal(tp.img2, jp.img2)


# -- phase 12's pages and mixed tree --------------------------------------------------

def test_phase_12_pages_read_as_their_digests():
    """``chip_smoke.a6_codec_pages`` (the LZMA page and the damaged Group 4
    page, 1200 x 500, built without PIL) decode to the digests of PIL's grey
    that the fixtures keep, and PIL gives those digests; the LZMA page is
    scan_420.jpg's grey, and the ZSTD fixture page the Group 4 page's."""
    golden = chip_smoke.golden_arrays()
    digests = dict(reversed(line.split()) for line in
                   (chip_smoke.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    for name, data in chip_smoke.a6_codec_pages(golden).items():
        with Image.open(io.BytesIO(data)) as im:
            assert chip_smoke.gray_digest(np.asarray(im.convert("L"))) == digests[name], name
        assert chip_smoke.gray_digest(tnative.decode(data)) == digests[name], name
    assert digests["lzma_page.tif"] == chip_smoke.gray_digest(golden["scan_420.jpg"])
    zstd_page = (chip_smoke.FIXTURES / "zstd_g4_page.tif").read_bytes()
    assert chip_smoke.tiff_strips(zstd_page)[259] == [ZSTD]
    np.testing.assert_array_equal(tnative.decode(zstd_page), golden["ccitt_g4_page.tif"])


@pytest.mark.parametrize("turn", [6, 7, 8])
def test_mixed_tree_tiffs_of_the_new_kinds_read_as_pil(tmp_path, turn):
    """Phase 12's mixed-tree TIFFs of this slice's kinds: LZMA grey, the ZSTD
    page and the damaged Group 4 page."""
    grey = pixels(np.random.RandomState(turn), (45, 70)).astype(np.uint8)
    layout, data = chip_smoke.mixed_tiff(grey, turn)
    assert layout == ("lzma", "zstd", "damaged_g4")[turn - 6]
    holds(tmp_path, data, True)
