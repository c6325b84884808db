"""Lossy WebP (VP8, ROADMAP A.6.31) and the VP8X container (A.6.32: ALPH,
ICC/EXIF/XMP, an animation's first frame) in the port's host decoder
(``data/native/webp.cpp``) against PIL, through the JAX package.

PIL reads a WebP file through libwebp's demuxer and animation decoder:
the first frame, at its offset on a zeroed RGBA canvas, its RGB from
libwebp's fancy upsampler and fixed-point YUV->RGB, then ``convert("L")``.
Each case is held to PIL's grey and to ``siggan_tpu.data.dataset.
decode_image``, or to both refusals. Pillow writes the first files; the
writers of ``tests/torch_port_webp_writers.py`` write headers and
streams its encoder does not (the simple filter, sharpness, loop-filter
and quantiser deltas, segments, 2, 4 and 8 partitions, no skip
probability, coefficients past 16 bits, ALPH of every method, filter and
pre-processing value, animations), and the container's corner cases."""

import io

import numpy as np
import pytest
from PIL import Image
from test_torch_port_webp_lossless import damage, holds, pil_grey, pillow, probe
from torch_port_webp_writers import alph_chunk, animation, vp8_file, vp8_frame, vp8l_stream

import chip_smoke as cs
from siggan_tpu_torch.data.native import loader as tnative

RS = np.random.RandomState(31)
SCAN = np.asarray(Image.open(cs.FIXTURES / "scan_420.jpg").convert("RGB"))
CROP = SCAN[120:161, 600:653]                      # 41 x 53: odd both ways
ALPHA = np.where(CROP[..., 1] > 200, 0, 255).astype(np.uint8)


# -- Pillow's lossy files ------------------------------------------------------

@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("quality", [0, 10, 25, 50, 75, 90, 100])
def test_pillow_lossy_reads_as_pil(tmp_path, quality, method):
    data = pillow(CROP, quality=quality, method=method)
    assert data[12:16] == b"VP8 "
    holds(data, tmp_path if method == 4 else None, read=True)


@pytest.mark.parametrize("size", [(1, 1), (1, 2), (2, 1), (1, 17), (17, 1), (16, 16), (15, 33),
                                  (31, 2), (2, 31), (48, 48)])
def test_sizes_read_as_pil(size):
    """Odd widths and heights: the fancy upsampler's first, last and odd
    rows and columns, the crop from the macroblock grid."""
    h, w = size
    holds(pillow(np.resize(CROP, (h, w, 3)), quality=70), read=True)
    holds(pillow(np.resize(CROP[..., 1], (h, w)), quality=40), read=True)


@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_alpha_quality_reads_as_pil(alpha_quality, method):
    """VP8X with ALPH as Pillow's encoder writes it (raw or lossless, its
    filters, level reduction below 100)."""
    rgba = np.dstack([CROP, ALPHA // 2 + (RS.rand(*ALPHA.shape) * 60).astype(np.uint8)])
    data = pillow(rgba, quality=60, method=method, alpha_quality=alpha_quality)
    assert data[12:16] == b"VP8X" and b"ALPH" in data
    holds(data, read=True)


def test_icc_exif_xmp_chunks_read_as_pil(tmp_path):
    im = Image.fromarray(CROP)
    buf = io.BytesIO()
    im.save(buf, "WEBP", quality=60, icc_profile=b"\0" * 131, exif=b"Exif\0\0II*\0" + bytes(20),
            xmp=b"<x:xmpmeta/>")
    data = buf.getvalue()
    assert data[12:16] == b"VP8X" and all(t in data for t in (b"ICCP", b"EXIF", b"XMP "))
    holds(data, tmp_path, read=True)


# -- hand-built VP8 frames -----------------------------------------------------

SEGMENTS = (True, False, (5, -3, 10, 0), (1, -2, 3, 9), (100, 50, 200))
FRAMES = {
    "plain": dict(),
    "simple_filter": dict(simple=True, level=30),
    **{f"sharpness_{s}": dict(level=45, sharpness=s) for s in range(1, 8)},
    "filter_level_63": dict(level=63),
    "no_filter": dict(level=0),
    "level_0_segment_strengths": dict(level=0, segments=(True, True, None, (20, 40, 63, 10), None)),
    "lf_deltas": dict(level=20, lf_deltas=((5, -3, 2, 1), (-6, 9, 0, 4))),
    "lf_deltas_some": dict(level=36, lf_deltas=((None, 4, None, -2), (12, None, None, None))),
    "lf_deltas_simple": dict(simple=True, level=10, lf_deltas=((-20, 0, 0, 0), (30, 0, 0, 0))),
    **{f"partitions_{p}": dict(parts=p) for p in (2, 4, 8)},
    "no_skip_probability": dict(skip_prob=None),
    "skip_probability_0": dict(skip_prob=0),
    "segments_relative": dict(segments=SEGMENTS),
    "segments_absolute": dict(segments=(True, True, (10, 40, 90, 127), (0, 10, 30, 63), (30, 200, 128))),
    "segments_no_map": dict(segments=(False, False, (20, 0, 0, 0), None, None)),
    "segment_quantizers_past_127": dict(q=120, segments=(True, False, (100, -127, 60, -60), None, None)),
    "quantiser_deltas": dict(q=64, q_deltas=(7, -8, 15, -15, 3)),
    "quantiser_0": dict(q=0, q_deltas=(-15, -15, -15, -15, -15)),
    "quantiser_127": dict(q=127, q_deltas=(15, 15, 15, 15, 15)),
    "probability_updates": dict(updates=0.3),
    "coefficients_past_16_bits": dict(q=127, big=0.4, zero_rate=0.2),
    "large_y2_wrapping": dict(q=120, big=0.8, zero_rate=0.1, i4_rate=0.0),
    "zeros_to_the_end": dict(run_to_end=0.7),
    "all_i4x4": dict(i4_rate=1.0),
    "all_i16": dict(i4_rate=0.0, zero_rate=0.9),
    "profiles_1": dict(profile=1),
    "profile_3": dict(profile=3),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_hand_built_frame_reads_as_pil(tmp_path, name):
    rs = np.random.RandomState(sorted(FRAMES).index(name))
    data = vp8_file(vp8_frame(rs, 45, 37, **FRAMES[name]))
    holds(data, tmp_path if name == "plain" else None, read=True)


@pytest.mark.parametrize("seed", range(12))
def test_random_frames_read_as_pil(seed):
    """Frames of drawn headers and sizes."""
    rs = np.random.RandomState(1000 + seed)
    kw = dict(parts=int(rs.choice([1, 2, 4, 8])), simple=bool(rs.rand() < 0.3), level=int(rs.randint(0, 64)),
              sharpness=int(rs.randint(0, 8)), q=int(rs.randint(0, 128)), big=float(rs.choice([0, 0.05, 0.5])),
              zero_rate=float(rs.rand()), updates=float(rs.choice([0, 0.05])),
              skip_prob=None if rs.rand() < 0.3 else int(rs.randint(0, 256)))
    w, h = int(rs.randint(1, 70)), int(rs.randint(1, 50))
    holds(vp8_file(vp8_frame(rs, w, h, **kw)), read=True)


def cut_token_partition(payload: bytes, keep: int) -> bytes:
    """A one-partition frame's tokens cut to ``keep`` bytes."""
    part0 = int.from_bytes(payload[:3], "little") >> 5
    return payload[:10 + part0 + keep]


FRAME = vp8_frame(np.random.RandomState(7), 45, 37)
# name -> frame payload; libwebp refuses each
REFUSED_FRAMES = {
    "start_code": lambda: FRAME[:3] + b"\x9d\x01\x2b" + FRAME[6:],
    "inter_frame": lambda: bytes([FRAME[0] | 1]) + FRAME[1:],
    "not_shown": lambda: bytes([FRAME[0] & ~16]) + FRAME[1:],
    "profile_4": lambda: bytes([(FRAME[0] & ~14) | 8]) + FRAME[1:],
    "width_0": lambda: FRAME[:6] + b"\0\0" + FRAME[8:],
    "first_partition_past_the_data": lambda: (len(FRAME) << 5 | 16).to_bytes(3, "little") + FRAME[3:],
    "tokens_cut": lambda: cut_token_partition(FRAME, 40),
    "no_token_bytes": lambda: cut_token_partition(FRAME, 0),
    "partition_sizes_past_the_data": lambda: cut_sizes(),
    "header_only": lambda: FRAME[:10],
}


def cut_sizes() -> bytes:
    """Eight partitions, the data cut inside their size table."""
    f = vp8_frame(np.random.RandomState(8), 20, 20, parts=8)
    return f[:10 + (int.from_bytes(f[:3], "little") >> 5) + 10]


@pytest.mark.parametrize("name", sorted(REFUSED_FRAMES))
def test_frame_libwebp_refuses_is_corrupt(tmp_path, name):
    holds(vp8_file(REFUSED_FRAMES[name]()), tmp_path, read=False)


def test_token_end_of_data_is_refused_where_libwebp_refuses_it():
    """A frame's token partition cut byte by byte: libwebp refuses it once a
    macroblock reads past the data ("premature end-of-file"), and the port
    at the same cut; the odd cuts get RIFF's pad byte, which is read."""
    f = vp8_frame(np.random.RandomState(9), 33, 17, zero_rate=0.8)
    part0 = int.from_bytes(f[:3], "little") >> 5
    tokens = len(f) - 10 - part0
    verdicts = []
    for keep in range(max(1, tokens - 24), tokens + 1):
        data = vp8_file(cut_token_partition(f, keep))
        holds(data)
        verdicts.append(pil_grey(data) is not None)
    assert not verdicts[0] and verdicts[-1]


# -- VP8X: ALPH, canvas, chunks ------------------------------------------------

VP8_CROP = pillow(CROP, quality=70)[20:]            # the 'VP8 ' chunk's payload


def vp8x(*chunks, flags=0x10, canvas=(53, 41)) -> bytes:
    return cs.riff_webp([cs.vp8x_chunk(canvas[0], canvas[1], flags), *chunks])


def image_chunk() -> bytes:
    return cs.webp_chunk(b"VP8 ", VP8_CROP)


@pytest.mark.parametrize("pre", [0, 1])
@pytest.mark.parametrize("filt", range(4))
@pytest.mark.parametrize("method", [0, 1])
def test_alph_methods_and_filters_read_as_pil(tmp_path, method, filt, pre):
    """ALPH of method 0 (raw) and 1 (lossless, through the VP8L decoder:
    a palette of few levels takes libwebp's 8-bit route, others its 32-bit
    one), filters 0-3, the pre-processing bit: the grey is the frame's."""
    alpha = np.where(ALPHA > 0, 255, 60 * filt) if filt % 2 else ALPHA
    opts = {"transforms": [("palette", [0xFF000000 | int(v) << 8 for v in np.unique(alpha)])]} if filt % 2 else {}
    data = vp8x(alph_chunk(alpha, method=method, filt=filt, pre=pre, **opts), image_chunk())
    holds(data, tmp_path if filt == 0 else None, read=True)


ALPH_BAD = {
    "reserved_bits": lambda: alph_chunk(ALPHA, reserved=1),
    "method_2": lambda: alph_chunk(ALPHA, method=0)[:8] + bytes([2]) + alph_chunk(ALPHA, method=0)[9:],
    "pre_processing_2": lambda: alph_chunk(ALPHA, pre=2),
    "raw_too_short": lambda: cs.webp_chunk(b"ALPH", b"\0" + ALPHA.tobytes()[:-1]),
    "empty": lambda: cs.webp_chunk(b"ALPH", b""),
    "header_only": lambda: cs.webp_chunk(b"ALPH", b"\1"),
    "lossless_cut": lambda: cs.webp_chunk(b"ALPH", alph_chunk(ALPHA)[8:-6]),
    "lossless_size_mismatch": lambda: cs.webp_chunk(
        b"ALPH", b"\1" + vp8l_stream(0xFF000000 | (ALPHA[:-1].astype(np.int64) << 8), header=False)),
}


@pytest.mark.parametrize("name", sorted(ALPH_BAD))
def test_alph_libwebp_refuses_fails_the_frame(tmp_path, name):
    """An ALPH libwebp cannot decode fails the frame, so PIL refuses the file
    (its alpha never reaches the grey)."""
    holds(vp8x(ALPH_BAD[name](), image_chunk()), tmp_path, read=False)


CONTAINERS = {
    # read
    "alph_without_the_alpha_flag": (lambda: vp8x(alph_chunk(ALPHA, reserved=1), image_chunk(), flags=0), True),
    "unknown_chunks_around_the_image": (lambda: vp8x(cs.webp_chunk(b"ABCD", b"xyz"), image_chunk(),
                                                     cs.webp_chunk(b"EFGH", b""), flags=0), True),
    "icc_chunk_without_its_flag": (lambda: vp8x(cs.webp_chunk(b"ICCP", b"\0" * 9), image_chunk(), flags=0), True),
    "bytes_after_the_riff": (lambda: pillow(CROP, quality=60) + b"trailing bytes", True),
    "simple_then_unknown_chunk": (lambda: cs.riff_webp([image_chunk(), cs.webp_chunk(b"ABCD", b"12")]), True),
    "simple_then_alph": (lambda: cs.riff_webp([image_chunk(), alph_chunk(ALPHA, reserved=1)]), True),
    # refused (the first by the decoder's check of the whole file, which
    # libwebp's animation decoder asks before its demuxer: a VP8X chunk of
    # exactly 10 bytes)
    "vp8x_chunk_of_12_bytes": (lambda: cs.riff_webp([cs.webp_chunk(b"VP8X", cs.vp8x_chunk(53, 41, 0)[8:] + b"\0\0"),
                                                     image_chunk()]), False),
    "riff_size_past_the_file": (lambda: (lambda d: d[:4] + (len(d) - 6).to_bytes(4, "little") + d[8:])(
        pillow(CROP, quality=60)), False),
    "file_cut_by_one_byte": (lambda: pillow(CROP, quality=60)[:-1], False),
    "riff_size_under_8": (lambda: (lambda d: d[:4] + (4).to_bytes(4, "little") + d[8:])(pillow(CROP, quality=60)), False),
    "reserved_flag_bit": (lambda: vp8x(image_chunk(), flags=0x01), False),
    "canvas_not_the_frame": (lambda: vp8x(image_chunk(), canvas=(54, 41), flags=0), False),
    "alph_after_the_image": (lambda: vp8x(image_chunk(), alph_chunk(ALPHA)), False),
    "alph_then_unknown_then_image": (lambda: vp8x(alph_chunk(ALPHA), cs.webp_chunk(b"ABCD", b""),
                                                  image_chunk()), False),
    "alph_before_vp8l": (lambda: vp8x(alph_chunk(ALPHA), cs.webp_chunk(b"VP8L", pillow(CROP, lossless=True)[20:])), False),
    "two_images": (lambda: vp8x(image_chunk(), image_chunk(), flags=0), False),
    "no_image": (lambda: vp8x(cs.webp_chunk(b"ABCD", b""), flags=0), False),
    "second_vp8x": (lambda: vp8x(cs.vp8x_chunk(53, 41, 0), image_chunk(), flags=0), False),
    "chunk_size_past_the_riff": (lambda: vp8x(image_chunk()[:4] + (len(VP8_CROP) + 10).to_bytes(4, "little")
                                              + image_chunk()[8:], flags=0), False),
    "bytes_left_under_a_chunk_header": (lambda: (lambda d: d[:4] + (len(d) - 8 + 4).to_bytes(4, "little") + d[8:]
                                                 + b"\0" * 4)(pillow(CROP, quality=60)), False),
    "animation_flag_without_frames": (lambda: vp8x(image_chunk(), flags=0x02), False),
    "anmf_before_anim": (lambda: vp8x(cs.webp_chunk(b"ANMF", bytes(16) + image_chunk()), flags=0x02), False),
}


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_container_reads_as_pil(tmp_path, name):
    """libwebp's demuxer rules: what it reads past and what it refuses."""
    build, read = CONTAINERS[name]
    holds(build(), tmp_path, read=read)


def frame_chunks(arr, **kw) -> bytes:
    d = pillow(arr, **kw)
    return d[20 + int.from_bytes(d[16:20], "little"):] if d[12:16] == b"VP8X" else d[12:]


@pytest.mark.parametrize("first", ["lossy", "lossless", "lossy_alpha"])
def test_animation_first_frame_at_its_offset_reads_as_pil(tmp_path, first):
    """Two frames: the first, of each kind, at an offset (stored halved) on
    a larger canvas; PIL's grey is that frame on a zeroed canvas."""
    a, b = CROP[:20, :30], CROP[20:, 20:]
    chunks = {"lossy": frame_chunks(a, quality=60), "lossless": frame_chunks(a, lossless=True),
              "lossy_alpha": frame_chunks(np.dstack([a, ALPHA[:20, :30]]), quality=60)}[first]
    data = animation((61, 47), [(6, 10, 30, 20, chunks), (0, 0, b.shape[1], b.shape[0],
                                                            frame_chunks(b, quality=50))])
    holds(data, tmp_path, read=True)
    grey = tnative.decode(data)
    assert grey.shape == (47, 61) and not grey[:10].any() and not grey[:, :6].any() and grey[10:30, 6:36].any()


ANIM_BAD = {
    "frame_past_the_canvas": lambda: animation((40, 30), [(12, 12, 30, 20, frame_chunks(CROP[:20, :30], quality=60))]),
    "anmf_shorter_than_its_header": lambda: vp8x(cs.webp_chunk(b"ANIM", bytes(6)), cs.webp_chunk(b"ANMF", bytes(10)),
                                                 flags=0x02),
    "anmf_without_an_image": lambda: animation((40, 30), [(0, 0, 10, 10, cs.webp_chunk(b"ABCD", b""))]),
    "plain_image_in_an_animation": lambda: vp8x(cs.webp_chunk(b"ANIM", bytes(6)), image_chunk(), flags=0x02),
    "anim_chunk_under_6": lambda: vp8x(cs.webp_chunk(b"ANIM", bytes(4)), flags=0x02),
}


@pytest.mark.parametrize("name", sorted(ANIM_BAD))
def test_animation_libwebp_refuses_is_corrupt(tmp_path, name):
    holds(ANIM_BAD[name](), tmp_path, read=False)


def test_canvas_past_pils_pixel_limit_is_corrupt():
    """PIL refuses more than 2 * MAX_IMAGE_PIXELS pixels; so does the port,
    before it allocates the canvas."""
    data = animation((16384, 12000), [(0, 0, 53, 41, image_chunk())])
    assert pil_grey(data) is None
    with pytest.raises(ValueError, match="decompression-bomb"):
        tnative.decode(data)


# -- the damaged-file probe ----------------------------------------------------

@pytest.mark.parametrize("part", range(2))
def test_damaged_lossy_probe_reads_as_pil(part):
    """A.6.31/A.6.32's probe, 800 files a part (seeded): Pillow's lossy
    files (plain, q5, with ALPH raw and lossless, a two-frame animation)
    and hand-built frames (8 partitions, segments, the simple filter),
    damaged. Offline, 100,000 such files of Pillow's and 10,000 of the
    writers' read as PIL (PERF.md)."""
    crop = SCAN[300:340, 700:760]
    rgba = np.dstack([crop, np.where(crop[..., 0] > 100, 255, 0).astype(np.uint8)])
    fr = [Image.fromarray(crop[:20, :30]), Image.fromarray(crop[20:, 30:])]
    buf = io.BytesIO()
    fr[0].save(buf, "WEBP", save_all=True, append_images=fr[1:], quality=70)
    rs = np.random.RandomState(40 + part)
    bases = [pillow(crop, quality=80), pillow(crop, quality=5, method=2), pillow(rgba, quality=60),
             pillow(rgba, quality=60, alpha_quality=100, method=0), buf.getvalue(),
             vp8_file(vp8_frame(rs, 40, 30, parts=8, segments=SEGMENTS, simple=True, level=20))]
    probe(bases, 400 + part, 800)


def test_probe_damage_kinds_stay_inside_the_file():
    """The probe's damages keep a file of at least 12 bytes (PIL's check of
    the RIFF prefix then decides)."""
    rs = np.random.RandomState(0)
    base = pillow(CROP, quality=60)
    for _ in range(200):
        assert len(damage(rs, base)) >= 12
