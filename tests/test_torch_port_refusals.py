"""Files PIL itself refuses, against the JAX package: a zero image, never a
refusal that stops a build (C.10); PIL's size rule; C.9's docstring.

The JAX package reads every file through PIL and takes a zero image, with a
warning, for any file PIL cannot open or convert. The port's decoder calls
each such kind corrupt (``ValueError``), so ``decode_image``,
``SignatureDataset`` and ``PairDataset`` give the same zero image and go
on; ``NotImplementedError`` (ROADMAP A.6) is left for kinds PIL reads and
the port does not yet. Each refused kind below is a genuine file of its
kind, and the test asserts that PIL refuses it. The size rule is PIL's:
more than 2 * ``Image.MAX_IMAGE_PIXELS`` (178,956,970) pixels is refused
(``DecompressionBombError``), any side length up to that is read."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import (_pack, _pack_row, assert_port_reads_as_pil, pil_gray,
                                    bmp_bytes, jpeg_bytes, pixels, tiff_file)
from test_torch_port_ojpeg import ojpeg_jif
from test_torch_port_progressive import pil_jpeg
from test_torch_port_tiff_lzma_zstd import bcj_filter_tiff
from torch_port_jpeg_writers import lossless_jpeg

import chip_smoke

from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu.verify import pairs as jpairs
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.infer.export import MAX_PIXELS, decode_png
from siggan_tpu_torch.verify import pairs as tpairs

RGB = pixels(np.random.RandomState(0), (16, 24, 3)).astype(np.uint8)
GREY = RGB[..., 0]


def seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def frame(data: bytes, marker=None, precision=None, height=None, width=None) -> bytes:
    """A JPEG with its frame marker, precision or size changed."""
    d = bytearray(data)
    at = next(i for i in range(len(d) - 1) if d[i] == 0xFF and d[i + 1] in (0xC0, 0xC2))
    if marker is not None:
        d[at + 1] = marker
    if precision is not None:
        d[at + 1], d[at + 4] = 0xC1, precision
    if height is not None:
        d[at + 5:at + 7] = struct.pack(">H", height)
    if width is not None:
        d[at + 7:at + 9] = struct.pack(">H", width)
    return bytes(d)


def two_components() -> bytes:
    """A 3-component baseline frame cut to two components (SOF and SOS)."""
    data = jpeg_bytes(RGB, ((1, 1),) * 3, 85)
    at = data.index(b"\xff\xc0")
    n = struct.unpack(">H", data[at + 2:at + 4])[0]
    sof = data[at + 4:at + 2 + n]
    sof = sof[:5] + b"\x02" + sof[6:12]
    return data[:at] + seg(0xC0, sof) + data[at + 2 + n:]


def raw_tiff(samples, bits, photometric, tags=(), be=False, compression=1) -> bytes:
    h, w, spp = samples.shape
    blob = (samples.reshape(h, -1).astype((">" if be else "<") + "u2").tobytes() if bits == 16
            else _pack(samples, bits).tobytes())
    base = [(258, 3, [bits] * spp), (259, 3, [compression]), (262, 3, [photometric]),
            (277, 3, [spp]), (273, 4, None), (278, 4, [h]), (279, 4, None)]
    names = {t[0] for t in tags}
    return tiff_file(w, h, [blob], [t for t in base if t[0] not in names] + list(tags), be)


def jpeg_tiff_sampled(luma, tag) -> bytes:
    """A YCbCr JPEG-in-TIFF of one stream with luma sampling ``luma`` and
    the YCbCrSubsampling tag ``tag``."""
    stream = jpeg_bytes(RGB, (luma, (1, 1), (1, 1)), 85)
    return tiff_file(24, 16, [stream], [(258, 3, [8] * 3), (259, 3, [7]), (262, 3, [6]),
                                        (277, 3, [3]), (284, 3, [1]), (273, 4, None),
                                        (278, 4, [16]), (279, 4, None), (530, 3, list(tag))])


G8 = GREY[..., None].astype(np.uint16)
RGBA = np.dstack([RGB, GREY]).astype(np.uint16)
# name -> (bytes, what the port's message names)
REFUSED = {
    "jpeg_12bit": (lambda: frame(jpeg_bytes(GREY, ((1, 1),), 85), precision=12), "12-bit JPEG"),
    "jpeg_16bit": (lambda: frame(jpeg_bytes(GREY, ((1, 1),), 85), precision=16), "16-bit JPEG"),
    "jpeg_height_0": (lambda: frame(jpeg_bytes(GREY, ((1, 1),), 85), height=0)
                      [:-2] + seg(0xDC, struct.pack(">H", 16)) + b"\xff\xd9", "DNL"),
    "jpeg_width_65501": (lambda: frame(jpeg_bytes(GREY, ((1, 1),), 85), width=65501), "65500"),
    "jpeg_sof5": (lambda: frame(pil_jpeg(GREY, quality=85), 0xC5), "hierarchical"),
    "jpeg_sof6": (lambda: frame(pil_jpeg(GREY, quality=85, progressive=True), 0xC6),
                  "hierarchical"),
    "jpeg_sof7": (lambda: frame(pil_jpeg(GREY, quality=85), 0xC7), "hierarchical"),
    "jpeg_sof13": (lambda: frame(pil_jpeg(GREY, quality=85), 0xCD), "hierarchical"),
    "jpeg_sof14": (lambda: frame(pil_jpeg(GREY, quality=85, progressive=True), 0xCE),
                   "hierarchical"),
    "jpeg_sof15": (lambda: frame(pil_jpeg(GREY, quality=85), 0xCF), "hierarchical"),
    "jpeg_2_components": (two_components, "2-component JPEG"),
    "jpeg_fractional_sampling": (lambda: jpeg_bytes(RGB, ((3, 1), (2, 1), (1, 1)), 85),
                                 "fractional chroma sampling"),
    "jpeg_18_blocks_an_mcu": (lambda: jpeg_bytes(RGB, ((4, 4), (1, 1), (1, 1)), 85),
                              "more than 10 blocks"),
    "jpeg_jpg0_marker": (lambda: (lambda b: b[:2] + seg(0xF0, b"abc") + b[2:])(
        pil_jpeg(GREY, quality=85)), "unknown JPEG marker"),
    "bmp_header_20": (lambda: (lambda d: d[:14] + struct.pack("<I", 20) + d[18:])(
        bmp_bytes([r.tobytes() for r in RGB[:6, :5]], 5, 6, 24, header=108)),
        "BMP header of 20 bytes"),
    "bmp_2bit": (lambda: bmp_bytes([_pack_row(r, 2) for r in (GREY[:6, :5] // 64)], 5, 6, 2,
                                   palette=[(0, 0, 0), (80, 80, 80), (160, 1, 2), (255, 255, 255)]),
                 "2-bit BMP"),
    "bmp_bitfields_444": (lambda: bmp_bytes([r.astype("<u2").tobytes() for r in G8[:6, :5, 0]],
                                            5, 6, 16, compression=3, masks=(0xF00, 0xF0, 0xF)),
                          "bitfields layout"),
    "bmp_jpeg_compression": (lambda: bmp_bytes([r.tobytes() for r in RGB[:6, :5]], 5, 6, 24,
                                               compression=4), "BMP compression 4"),
    "bmp_palette_70000": (lambda: (lambda d: d[:46] + struct.pack("<I", 70000) + d[50:])(
        bmp_bytes([bytes(r) for r in GREY[:6, :5]], 5, 6, 8,
                  palette=[(i, i, 0) for i in range(256)])), "palette size"),
    "tiff_be16_white_is_zero": (lambda: raw_tiff(G8 * 100, 16, 0, be=True), "without a PIL mode"),
    "tiff_7_samples": (lambda: raw_tiff(np.dstack([RGBA, RGB]).astype(np.uint16), 8, 2,
                                        [(338, 3, [0, 0, 0, 0])]), "without a PIL mode"),
    "tiff_grey_4_samples": (lambda: raw_tiff(RGBA, 8, 1), "without a PIL mode"),
    "tiff_mixed_sample_sizes": (lambda: raw_tiff(RGBA, 8, 2, [(258, 3, [8, 8, 8, 16]),
                                                              (338, 3, [0])]), "without a PIL mode"),
    "tiff_rgb_extra_sample_3": (lambda: raw_tiff(RGBA, 8, 2, [(338, 3, [3])]),
                                "without a PIL mode"),
    "tiff_sample_format_4": (lambda: raw_tiff(G8, 8, 1, [(339, 3, [4])]), "without a PIL mode"),
    "tiff_fill_order_2_rgba": (lambda: raw_tiff(RGBA, 8, 2, [(266, 3, [2]), (338, 3, [2])]),
                               "without a PIL mode"),
    "tiff_cielab": (lambda: (lambda b: (Image.fromarray(RGB).convert("LAB").save(b, "TIFF"),
                                        b.getvalue())[1])(io.BytesIO()), "CIELab"),
    "tiff_compression_12345": (lambda: raw_tiff(G8, 8, 1, compression=12345), "which PIL does not"),
    "tiff_next_compression": (lambda: raw_tiff(G8, 8, 1, compression=32766), "which PIL does not"),
    "tiff_webp_compression": (lambda: raw_tiff(G8, 8, 1, compression=50001), "libtiff refuses"),
    "tiff_ccitt_of_8_bits": (lambda: raw_tiff(G8, 8, 1, compression=4), "more than 1 bit"),
    "tiff_predictor_3_on_integers": (lambda: raw_tiff(G8, 8, 1, [(317, 3, [3])], compression=5),
                                     "floating-point predictor on integers"),
    "jpeg_tiff_subsampling_3": (lambda: jpeg_tiff_sampled((3, 1), (3, 1)), "subsampling 3"),
    "jpeg_tiff_tag_not_the_stream": (lambda: jpeg_tiff_sampled((2, 2), (2, 1)),
                                     "improper sampling factors"),
    # C.16: sites that raised naming A.6 for files PIL refuses.
    "jpeg_sof11": (lambda: chip_smoke.sof11(lossless_jpeg([GREY])), "SOF11"),
    "tiff_ojpeg_3_samples_in_photometric_1": (
        lambda: ojpeg_jif(pil_jpeg(RGB, quality=90, subsampling=0), 24, 16, 3, photometric=1),
        "3 samples in photometric 1"),
    "tiff_width_given_twice": (lambda: chip_smoke.tiff_layout(
        G8, 8, 1, compression=8, tags=[(256, 4, [24]), (256, 3, [21])]), "given twice"),
    "tiff_ycbcr_jpeg_in_planes": (lambda: planar_jpeg_tiff(6), "JPEG in planes"),
    "tiff_samples_read_otherwise": (lambda: chip_smoke.tiff_pack(24, 16, [zlib.compress(
        GREY.tobytes())], [(258, 17, [8]), (259, 3, [8]), (262, 3, [1]), (277, 3, [1]),
                           (273, 4, lambda o: o), (278, 4, [16]), (279, 4, [len(zlib.compress(
                               GREY.tobytes()))])]), "read otherwise"),
    # A.6.28, A.6.29: the GIF and Netpbm kinds PIL refuses.
    "gif_lzw_cut_before_eoi": (lambda: chip_smoke.gif_file(GREY, codes=chip_smoke.gif_lzw(
        GREY.tobytes(), eoi=False)[:100]), "before EOI"),
    "pgm_plain_sample_past_maxval": (lambda: chip_smoke.pnm_file("P2", GREY, 100), "past maxval"),
    "pam_p7": (lambda: b"P7\nWIDTH 24\nHEIGHT 16\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\n"
               b"ENDHDR\n" + GREY.tobytes(), "not a recognised image file"),
    # A.6.30-A.6.32: damaged WebP files PIL refuses (libwebp's demuxer, its
    # decoder's header check, a VP8 macroblock past its data, VP8L data past
    # its end, an ALPH chunk it cannot decode).
    "webp_cut_by_a_byte": (lambda: pil_image_bytes("WEBP")[:-1], "demuxer refuses"),
    "webp_vp8x_of_12_bytes": (lambda: webp_vp8x_of_12_bytes(), "decoder refuses"),
    "webp_lossy_tokens_cut": (lambda: webp_tokens_cut(), "premature end of VP8 data"),
    "webp_lossless_cut": (lambda: webp_lossless_cut(), "VP8L"),
    "webp_alph_reserved_bits": (lambda: webp_bad_alph(), "ALPH"),
}


def webp_vp8x_of_12_bytes() -> bytes:
    """A still VP8X file whose VP8X chunk holds 12 bytes: the demuxer
    skips the two past the 10, the decoder's header check refuses them."""
    d = pil_image_bytes("WEBP")
    return chip_smoke.riff_webp([chip_smoke.webp_chunk(b"VP8X", chip_smoke.vp8x_chunk(24, 16, 0)[8:] + b"\0\0"),
                                 d[12:]])


def webp_tokens_cut() -> bytes:
    """A lossy file whose token partition ends 8 bytes early, its sizes
    fixed: a macroblock reads past the data."""
    d = pil_image_bytes("WEBP")
    payload = d[20:20 + int.from_bytes(d[16:20], "little") - 8]
    return chip_smoke.riff_webp([chip_smoke.webp_chunk(b"VP8 ", payload)])


def webp_lossless_cut() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(RGB).save(buf, "WEBP", lossless=True)
    d = buf.getvalue()
    payload = d[20:20 + int.from_bytes(d[16:20], "little")]
    return chip_smoke.riff_webp([chip_smoke.webp_chunk(b"VP8L", payload[:len(payload) // 2 * 2 - 20])])


def webp_bad_alph() -> bytes:
    """Lossy with alpha whose ALPH header sets a reserved bit: libwebp fails
    the frame (the alpha never reaches L)."""
    buf = io.BytesIO()
    Image.fromarray(np.dstack([RGB, GREY])).save(buf, "WEBP", quality=80)
    d = bytearray(buf.getvalue())
    d[d.index(b"ALPH") + 8] |= 0x40
    return bytes(d)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_pil_refused_kind_is_a_zero_image(tmp_path, name):
    """PIL cannot open or convert the file, so the JAX package's
    ``decode_image`` gives a zero image; the port's gives the same and its
    ``decode_gray`` raises ``ValueError`` naming the kind, never
    ``NotImplementedError``."""
    build, what = REFUSED[name]
    path = tmp_path / f"{name}.{name.split('_')[0].replace('jpeg', 'jpg')}"
    path.write_bytes(build())
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.convert("L")
    assert not jdataset.decode_image(path, 16).any()
    np.testing.assert_array_equal(tdataset.decode_image(path, 16), jdataset.decode_image(path, 16))
    with pytest.raises(ValueError, match=what):
        tdataset.decode_gray(path)


def ccitt_tiles() -> bytes:
    from test_torch_port_ccitt import refused_files
    return refused_files()[0]["tiles"][0]


def planar_jpeg_tiff(photometric: int) -> bytes:
    """A JPEG-in-TIFF of three planes, each a grey JPEG stream of one of
    RGB's channels."""
    planes = [pil_jpeg(np.ascontiguousarray(RGB[..., i]), quality=90) for i in range(3)]
    return chip_smoke.tiff_pack(24, 16, planes, [
        (258, 3, [8] * 3), (259, 3, [7]), (262, 3, [photometric]), (277, 3, [3]), (284, 3, [2]),
        (273, 4, lambda o: o), (278, 4, [16]), (279, 4, [len(p) for p in planes])])


def jpeg_tiff_grey(stream: bytes, bits: int = 8, photometric: int = 1, tags=()) -> bytes:
    return chip_smoke.tiff_pack(24, 16, [stream], [
        (258, 3, [bits]), (259, 3, [7]), (262, 3, [photometric]), (277, 3, [1]),
        (273, 4, lambda o: o), (278, 4, [16]), (279, 4, [len(stream)])] + list(tags))


def mh_word_rows(black) -> bytes:
    """CCITT RLE-W (compression 32771) rows: each row's Modified Huffman
    runs (white first), padded to a 16-bit word."""
    bits = ""
    for row in black:
        x, colour, s = 0, False, ""
        while x < len(row):
            e = x
            while e < len(row) and row[e] == colour:
                e += 1
            s, x, colour = s + chip_smoke.ccitt_run(e - x, colour), e, not colour
        bits += s + "0" * (-len(s) % 16)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def thunderscan_raw(nibbles) -> bytes:
    """ThunderScan (compression 32809) rows of raw 4-bit pixels: a code
    byte 0xC0 | value each."""
    return bytes(0xC0 | int(v) for v in nibbles.ravel())


def pil_image_bytes(fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(GREY).save(buf, fmt)
    return buf.getvalue()


def one_strip(blob: bytes, bits: int, compression: int, photometric: int = 1) -> bytes:
    return chip_smoke.tiff_pack(24, 16, [blob], [
        (258, 3, [bits]), (259, 3, [compression]), (262, 3, [photometric]), (277, 3, [1]),
        (273, 4, lambda o: o), (278, 4, [16]), (279, 4, [len(blob)])])


def px_tile_past_its_row() -> bytes:
    """Planar PX through libtiff in tiles whose last row is inside the
    image: PIL reads that row of the first plane's tile on past its buffer."""
    from test_torch_port_tiff_layouts import PLANAR
    smp, bits, photo, tags = PLANAR["px"]
    return chip_smoke.tiff_layout(np.resize(smp, (16,) + smp.shape[1:]), bits, photo,
                                  compression=5, planar=2, tile=(16, 16), tags=tags)


def pil_tiff_of(codec: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(GREY).save(buf, "TIFF", compression=codec)
    return buf.getvalue()


def ojpeg_planar_tiles() -> bytes:
    """Planar YCbCr old-style JPEG-in-TIFF in tiles (tests/
    test_torch_port_ojpeg_planes.py), which PIL reads through its RGBA
    reader's gtTileSeparate."""
    from test_torch_port_ojpeg_planes import planar_tiles
    return planar_tiles()


def pil_only_file(fmt: str) -> bytes:
    """A genuine file of a format PIL opens and has no writer of
    (tests/test_torch_port_pil_formats.py)."""
    from test_torch_port_pil_formats import no_writer_files
    return no_writer_files()[fmt]


# name -> (bytes, what the message names): PIL reads these; the port not yet.
# The audit: a genuine file at each site of decode.cpp that still
# raises naming A.6 (a site whose file PIL refuses is corrupt: REFUSED):
# one file of each format PIL opens that the port does not read (C.21,
# chip_smoke.c21_files, and the formats PIL reads and writes not).
STILL_A6 = {
    **{f"c21_{fmt.lower()}": (lambda fmt=fmt: chip_smoke.c21_files()[fmt], fmt)
       for fmt in ("AVIF", "ICNS", "JPEG2000")},
}


# Kinds this file held as raising, which the port now reads (A.6.4-A.6.63,
# C.20).
NOW_READ = {
    **{f"pil_only_{fmt.lower()}": (lambda fmt=fmt: pil_only_file(fmt))
       for fmt in ("FITS", "FLI", "GBR", "IMT", "IPTC", "MCIDAS", "PCD", "PIXAR")},
    **{f"c21_{fmt.lower()}": (lambda fmt=fmt: chip_smoke.c21_files()[fmt])
       for fmt in ("BLP", "CUR", "DCX", "DDS", "DIB", "ICO", "IM", "MSP", "PCX", "PSD", "QOI", "SGI",
                   "SPIDER", "SUN", "TGA", "XBM", "XPM")},
    "xv_thumbnail": lambda: pil_only_file("XVThumb"),
    "pil_only_ftex": lambda: pil_only_file("FTEX"),
    "ojpeg_planar_tiles": ojpeg_planar_tiles,
    "webp": lambda: pil_image_bytes("WEBP"),
    "webp_lossless": lambda: (lambda b: (Image.fromarray(RGB).save(b, "WEBP", lossless=True),
                                         b.getvalue())[1])(io.BytesIO()),
    "webp_alpha": lambda: (lambda b: (Image.fromarray(np.dstack([RGB, GREY])).save(b, "WEBP", quality=80),
                                      b.getvalue())[1])(io.BytesIO()),
    "gif": lambda: pil_image_bytes("GIF"),
    "pgm": lambda: pil_image_bytes("PPM"),
    "ojpeg_planar_ycbcr": lambda: chip_smoke.ojpeg_planes_tiff(
        [GREY, GREY // 2 + 64, 255 - GREY], chip_smoke.Q90),
    "lzma_arm64_bcj": lambda: bcj_filter_tiff(0x0A),
    "lzma_riscv_bcj": lambda: bcj_filter_tiff(0x0B),
    "tag_given_twice": lambda: chip_smoke.tiff_layout(
        G8, 8, 1, compression=8, tags=[(262, 3, [1]), (262, 3, [0])]),
    "ccitt_rle_w": lambda: one_strip(mh_word_rows(GREY < 60), 1, 32771, 0),
    "thunderscan": lambda: one_strip(thunderscan_raw(GREY >> 4), 4, 32809),
    "planar_jpeg_tiff": lambda: planar_jpeg_tiff(2),
    "jpeg_tiff_12_bits": lambda: jpeg_tiff_grey(frame(pil_jpeg(GREY, quality=90), precision=12), 12),
    "jpeg_tiff_white_is_zero": lambda: jpeg_tiff_grey(pil_jpeg(GREY, quality=90), photometric=0),
    "jpeg_tiff_palette": lambda: jpeg_tiff_grey(pil_jpeg(GREY, quality=90), photometric=3, tags=[
        (320, 3, list(range(0, 65536, 256)) * 3)]),
    "planar_px_tile_past_its_row": px_tile_past_its_row,
    "ccitt_tiles": ccitt_tiles,
    "lzma_tiff": lambda: pil_tiff_of("lzma"),
    "zstd_tiff": lambda: pil_tiff_of("zstd"),
    "lossless_sof3": lambda: lossless_jpeg([GREY]),
    "arithmetic_sof9": lambda: frame(pil_jpeg(GREY, quality=85), 0xC9),
    "int16_tiff": lambda: raw_tiff(G8 * 100, 16, 1, [(339, 3, [2])]),
    "bigtiff": lambda: (lambda b: (Image.fromarray(GREY).save(b, "TIFF", big_tiff=True),
                                   b.getvalue())[1])(io.BytesIO()),
    "planar_rgb": lambda: chip_smoke.tiff_pack(24, 16, [RGB[..., i].tobytes() for i in range(3)], [
        (258, 3, [8] * 3), (259, 3, [1]), (262, 3, [2]), (277, 3, [3]), (284, 3, [2]),
        (273, 4, lambda o: o), (278, 4, [16]), (279, 4, [16 * 24] * 3)]),
    "palette_with_extra_sample": lambda: raw_tiff(
        np.dstack([G8, G8]) // 16, 8, 3, [(338, 3, [0]), (320, 3, list(range(0, 65536, 256)) * 3)]),
    "associated_alpha": lambda: raw_tiff(RGBA, 8, 2, [(338, 3, [1])]),
}


def past_the_tile_buffer(data: bytes) -> np.ndarray:
    """Where PIL reads a planar PX TIFF's tiles past its tile buffer: pixel
    c of a tile's row r is byte r * tw + 2 c of the first plane's tile,
    which holds tw * th bytes."""
    ifd = struct.unpack_from("<I", data, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        tag, typ, _ = struct.unpack_from("<HHI", data, ifd + 2 + 12 * i)
        tags[tag] = struct.unpack_from("<H" if typ == 3 else "<I", data, ifd + 10 + 12 * i)[0]
    h, w, tw, th = tags[257], tags[256], tags[322], tags[323]
    r, c = np.mgrid[0:h, 0:w]
    return (r % th) * tw + 2 * (c % tw) >= tw * th


@pytest.mark.parametrize("name", sorted(NOW_READ))
def test_kind_pil_reads_is_read_as_pil(tmp_path, name):
    """DIB, ICO, CUR, TGA, PCX, DCX, SGI, SUN, MSP, QOI, IM, PSD, XBM, XPM,
    BLP, DDS and SPIDER (the files of ``chip_smoke.c21_files``), an XV
    thumbnail, an FTEX file, a FITS, FLI, GBR, IMT, IPTC, McIdas, PCD and
    PIXAR file, planar
    YCbCr old-style JPEG-in-TIFF in tiles (the right tile keeping the left's
    rows, as PIL's tile buffer does), WebP (lossy, lossless, lossy with alpha), a
    genuine lossless JPEG (predictor 1), Huffman data under an
    arithmetic frame marker (decoded as libjpeg decodes it), an int16 grey
    TIFF, a BigTIFF, a planar RGB TIFF, a palette with an extra sample,
    RGB with associated alpha, LZMA and ZSTD TIFF, CCITT in tiles, LZMA of
    the ARM64 and RISC-V BCJ filters, a tag given twice, CCITT RLE-W,
    ThunderScan, planar, 12-bit, WhiteIsZero and palette JPEG-in-TIFF: each
    bit-equal with PIL. A planar PX TIFF in tiles whose last rows PIL reads
    past its tile buffer (memory that differs from run to run) is
    bit-equal with PIL elsewhere, and there a sample of 0, palette entry 0's
    grey (A.6.27)."""
    path = tmp_path / name
    path.write_bytes(NOW_READ[name]())
    assert jdataset.decode_image(path, 16).any()                   # PIL reads it
    if name != "planar_px_tile_past_its_row":
        assert_port_reads_as_pil(path)
        return
    past = past_the_tile_buffer(path.read_bytes())
    got = tdataset.decode_gray(path)
    with Image.open(path) as im:
        zero = Image.fromarray(np.zeros((1, 1), np.uint8), "P")
        zero.putpalette(im.getpalette())
    assert past.sum() == 8 and (got[past] == np.asarray(zero.convert("L"))[0, 0]).all()
    np.testing.assert_array_equal(got[~past], pil_gray(path)[~past])


@pytest.mark.parametrize("name", sorted(STILL_A6))
def test_kind_pil_reads_still_raises_naming_a6(tmp_path, name):
    build, what = STILL_A6[name]
    path = tmp_path / name
    path.write_bytes(build())
    assert jdataset.decode_image(path, 16).any()                   # PIL reads it
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP A.6"):
        tdataset.decode_gray(path)


def test_segments_libjpeg_skips_are_read(tmp_path):
    """What the port refused before and libjpeg reads: an arithmetic
    conditioning (DAC) segment in a Huffman file, a DNL segment after the
    scan of a frame that has its height, a DC table with symbol 16 (libjpeg-
    turbo 3 allows it for lossless files)."""
    base = pil_jpeg(GREY, quality=85)
    sos = base.index(b"\xff\xda")
    dht_16 = seg(0xC4, bytes([0x03] + [0, 1, 5] + [1] * 11 + [0, 0]) + bytes(range(17)))
    files = {"dac.jpg": base[:2] + seg(0xCC, bytes([0x00, 0x10, 0x10, 0x05])) + base[2:],
             "dnl.jpg": base[:-2] + seg(0xDC, struct.pack(">H", 16)) + b"\xff\xd9",
             "dc16.jpg": base[:sos] + dht_16 + base[sos:]}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        assert_port_reads_as_pil(tmp_path / name)


def mixed_refused_tree(root):
    """Two writers' folders: good scans and files PIL refuses."""
    for wi in range(2):
        d = root / f"w{wi}"
        d.mkdir(parents=True)
        for k in range(3):
            img = pixels(np.random.RandomState(10 * wi + k), (30 + 4 * k, 40, 3)).astype(np.uint8)
            Image.fromarray(img).save(d / f"w{wi}_{k}.{'jpg' if k % 2 else 'png'}")
        for k, name in enumerate(("jpeg_12bit", "jpeg_sof5", "tiff_be16_white_is_zero",
                                  "bmp_2bit")[2 * wi:2 * wi + 2]):
            (d / f"w{wi}_bad{k}.{name.split('_')[0].replace('jpeg', 'jpg')}").write_bytes(
                REFUSED[name][0]())


def test_datasets_build_over_refused_files_as_jax(tmp_path, monkeypatch):
    """A mixed directory of good scans and PIL-refused files builds in both
    packages' SignatureDataset and PairDataset with equal arrays (the
    JAX side on its PIL path): zero images where PIL refuses."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    mixed_refused_tree(tmp_path / "raw")
    j = jdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path / "raw", 32, use_cache=False)
    assert len(t) == 10 and sum(not x.any() for x in t.images) == 4
    np.testing.assert_array_equal(t.images, j.images)
    jp = jpairs.PairDataset(tmp_path / "raw", pairs_per_user=4, image_size=32, seed=3)
    tp = tpairs.PairDataset(tmp_path / "raw", pairs_per_user=4, image_size=32, seed=3)
    assert [(a.name, b.name, l) for a, b, l in tp.pairs] == \
        [(a.name, b.name, l) for a, b, l in jp.pairs]
    np.testing.assert_array_equal(tp.img1, jp.img1)
    np.testing.assert_array_equal(tp.img2, jp.img2)


def test_preprocess_cli_stops_on_a_refused_file_with_value_error(tmp_path, monkeypatch):
    """``cli.preprocess`` does not catch a decode failure in either
    package: on a file PIL refuses both stop, the port with ValueError."""
    from siggan_tpu.cli import preprocess as jcli
    from siggan_tpu.core import platform as jplatform
    from siggan_tpu_torch.cli import preprocess as tcli
    monkeypatch.setattr(jplatform, "setup", lambda *a, **k: None)
    raw = tmp_path / "raw" / "w0"
    raw.mkdir(parents=True)
    Image.fromarray(GREY).save(raw / "w0_0.png")
    (raw / "w0_1.jpg").write_bytes(REFUSED["jpeg_12bit"][0]())
    with pytest.raises(Exception):
        jcli.main(["--input_dir", str(tmp_path / "raw"), "--output_dir", str(tmp_path / "j")])
    with pytest.raises(ValueError, match="12-bit JPEG"):
        tcli.main(["--input_dir", str(tmp_path / "raw"), "--output_dir", str(tmp_path / "t"),
                   "--device", "cpu"])


def test_size_rule_is_pils(tmp_path):
    """A 70000 x 1 BMP (wider than the old 65535 limit) reads bit-equal
    with PIL; a header claiming more than 2 * MAX_IMAGE_PIXELS pixels is
    refused by PIL (DecompressionBombError) and corrupt in the port, in
    BMP, TIFF and PNG; at exactly the limit PIL opens the header and the
    port goes on to the pixel data (which this file lacks, so it is corrupt
    for that, before it allocates the image)."""
    assert MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS == 178_956_970
    wide = np.random.RandomState(1).randint(0, 256, (1, 70000, 3)).astype(np.uint8)
    Image.fromarray(wide).save(tmp_path / "wide.bmp")
    with Image.open(tmp_path / "wide.bmp") as im:     # (load_canvas's canvas would be 70000^2)
        np.testing.assert_array_equal(tdataset.decode_gray(tmp_path / "wide.bmp"),
                                      np.asarray(im.convert("L")))
    np.testing.assert_array_equal(tdataset.decode_image(tmp_path / "wide.bmp", 16),
                                  jdataset.decode_image(tmp_path / "wide.bmp", 16))
    w = 17_000
    for h in (MAX_PIXELS // w + 1, MAX_PIXELS // w):
        bomb = w * h > MAX_PIXELS
        files = {"b.bmp": bmp_bytes([], w, h, 24, raw=b"\0" * 64)}
        if bomb:
            files["t.tif"] = tiff_file(w, h, [b"\0" * 64], [
                (258, 3, [8]), (259, 3, [1]), (262, 3, [1]), (277, 3, [1]), (273, 4, None),
                (278, 4, [h]), (279, 4, None)])
        for name, data in files.items():
            path = tmp_path / f"{h}{name}"
            path.write_bytes(data)
            if bomb:
                with pytest.raises(Image.DecompressionBombError):
                    Image.open(path)
                assert not jdataset.decode_image(path, 16).any()
                assert not tdataset.decode_image(path, 16).any()
            else:
                with Image.open(path) as im:
                    assert im.size == (w, h)
            with pytest.raises(ValueError) as e:
                tdataset.decode_gray(path)
            assert ("decompression-bomb" in str(e.value)) == bomb
    ihdr = struct.pack(">IIBBBBB", 20_000, 9_000, 8, 0, 0, 0, 0)
    png = b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))
        for tag, body in ((b"IHDR", ihdr), (b"IEND", b"")))
    with pytest.raises(ValueError, match="decompression-bomb"):
        decode_png(png)


def test_verifier_eval_doc_names_the_charts_it_writes():
    """C.9: the CLI's docstring names the four charts, which
    ``evaluate_signature_verifier`` writes, and no longer says the port
    does not draw them."""
    import inspect
    from siggan_tpu_torch.cli import verifier_eval
    from siggan_tpu_torch.verify import eval as veval
    doc = " ".join(verifier_eval.__doc__.split())
    source = inspect.getsource(veval.evaluate_signature_verifier)
    assert "does not draw" not in doc
    for chart in ("roc.png", "det.png", "score_distributions.png", "metric_comparison.png"):
        assert chart in doc and f'"{chart}"' in source
