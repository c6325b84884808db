"""JPEG-in-TIFF of photometric 0 and 3 (ROADMAP A.6.20), of 12 bits
(A.6.21) and in planes (A.6.22) in the port's host decoder
(``data/native/decode.cpp``) against PIL, through the JAX package; and
PIL's palette of a ColorMap of any count (C.18).

These go through libtiff's JPEG codec as PIL's decoder drives it, a strip or
tile at a time into samples that PIL unpacks with its own raw mode: libjpeg
with no colour conversion (JCS_UNKNOWN), the stream's precision that of
BitsPerSample, its components the chunk's samples (one for a plane), each
1 x 1. WhiteIsZero inverts libjpeg's grey, a palette looks it up. A 12-bit
page comes out of libtiff two samples in three bytes (of a row's odd count
the last is not written: PIL's buffer keeps what it held, memory that
differs from run to run, and the port gives 0 there), which PIL unpacks as
I;16 and clips at 255 in ``convert("L")``. The 12-bit streams are written
by ``chip_smoke.jpeg_sof1``, proven by PIL's own I;16 pixels, which stay
within the quantisation of the source."""

import io

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, jpeg_bytes, pixels
from test_torch_port_lzw_ojpeg_tiles import holds, pil_grey
from test_torch_port_progressive import pil_jpeg

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative

RS = np.random.RandomState(21)
H, W = 16, 24
GREY = pixels(RS, (H, W)).astype(np.uint8)
RGB = pixels(RS, (H, W, 3)).astype(np.uint8)
RAMP = list(range(0, 65536, 256)) * 3
TWELVE = np.clip(RS.randint(0, 260, (H, W)) + (RS.rand(H, W) < 0.15) * 3800, 0, 4095)


def strip(stream: bytes, bits: int = 8, photometric: int = 1, spp: int = 1, tags=(), w: int = W,
          h: int = H) -> bytes:
    return chip_smoke.jpeg_in_tiff([stream], w, h, bits, photometric, spp, tags=tags)


# -- A.6.20: photometric 0 and 3 ----------------------------------------------------

PHOTOMETRIC = {
    "white_is_zero": (0, ()),
    "palette_ramp": (3, [(320, 3, RAMP)]),
    "palette_tinted": (3, [(320, 3, list(np.arange(256) * 257) + list(np.arange(256)[::-1] * 257)
                            + list(np.arange(256) // 2 * 257))]),
}


@pytest.mark.parametrize("name", sorted(PHOTOMETRIC))
@pytest.mark.parametrize("stream", ["pil", "sof1", "restarts"])
def test_white_is_zero_and_palette_read_as_pil(tmp_path, name, stream):
    """WhiteIsZero and palette JPEG-in-TIFF of PIL's baseline grey, a SOF1
    stream and one with restarts: bit-equal with PIL."""
    photometric, tags = PHOTOMETRIC[name]
    data = {"pil": lambda: pil_jpeg(GREY, quality=90),
            "sof1": lambda: chip_smoke.jpeg_sof1(GREY, chip_smoke.Q90, precision=8),
            "restarts": lambda: pil_jpeg(GREY, quality=75, restart_marker_blocks=2)}[stream]()
    holds(tmp_path, strip(data, photometric=photometric, tags=tags), True)


def test_white_is_zero_is_the_inverted_grey(tmp_path):
    """PIL's grey of WhiteIsZero JPEG-in-TIFF is 255 minus that of the same
    stream under photometric 1; a ramp palette's is the same grey."""
    s = pil_jpeg(GREY, quality=90)
    grey = pil_grey(strip(s))
    np.testing.assert_array_equal(tnative.decode(strip(s, photometric=0)), 255 - grey)
    np.testing.assert_array_equal(tnative.decode(strip(s, photometric=3, tags=[(320, 3, RAMP)])),
                                  grey)


@pytest.mark.parametrize("count", [3, 48, 255, 257, 512, 767, 768, 770, 771, 1024])
@pytest.mark.parametrize("compression", [1, 8, 7])
def test_colour_map_of_any_count_reads_as_pil(tmp_path, count, compression):
    """C.18: PIL's palette is the ColorMap in thirds (red, green, blue),
    whatever its count, entries past it black, and PIL refuses a palette of
    more than 256 entries (a count from 771 up); the port called any other
    count than 3 << bits corrupt. libtiff drops such a map, which an 8-bit
    palette does not need: uncompressed (PIL's raw decoder), Deflate and
    JPEG-in-TIFF each read as PIL reads them."""
    cmap = [int(v) for v in np.random.RandomState(count).randint(0, 65536, count)]
    vals = np.arange(H * W, dtype=np.int64).reshape(H, W, 1) % 256
    if compression == 7:
        data = strip(pil_jpeg(GREY, quality=90), photometric=3, tags=[(320, 3, cmap)])
    else:
        data = chip_smoke.tiff_layout(vals, 8, 3, compression=compression, tags=[(320, 3, cmap)])
    holds(tmp_path, data, count < 771)


@pytest.mark.parametrize("compression", [1, 8])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_colour_map_of_another_count_below_8_bits(tmp_path, compression, bits):
    """Below 8 bits libtiff needs the map it dropped (MissingRequired), so
    PIL refuses a compressed file of another count and reads an
    uncompressed one (its raw decoder) with its palette of the map in
    thirds."""
    vals = np.arange(H * W, dtype=np.int64).reshape(H, W, 1) % (1 << bits)
    cmap = [int(v) for v in np.random.RandomState(bits).randint(0, 65536, 3 << bits | 3)]
    data = chip_smoke.tiff_layout(vals, bits, 3, compression=compression, tags=[(320, 3, cmap)])
    holds(tmp_path, data, compression == 1)


PIL_REFUSES = {  # name -> bytes: each kind PIL refuses, corrupt in the port
    "palette_of_3_samples": lambda: strip(pil_jpeg(RGB, quality=90), photometric=3, spp=3,
                                          tags=[(320, 3, RAMP)]),
    "white_is_zero_12_bits": lambda: strip(chip_smoke.jpeg_sof1(TWELVE, np.ones(64)), 12, 0),
    "palette_12_bits": lambda: strip(chip_smoke.jpeg_sof1(TWELVE, np.ones(64)), 12, 3,
                                     tags=[(320, 3, list(range(0, 65536, 16)) * 3)]),
    "rgb_12_bits": lambda: strip(chip_smoke.jpeg_sof1([TWELVE] * 3, np.ones(64)), 12, 2, 3),
    "ycbcr_12_bits": lambda: strip(chip_smoke.jpeg_sof1([TWELVE] * 3, np.ones(64)), 12, 6, 3),
    "8_bit_stream_in_12_bits": lambda: strip(pil_jpeg(GREY, quality=90), 12),
    "12_bit_stream_in_8_bits": lambda: strip(chip_smoke.jpeg_sof1(TWELVE, np.ones(64))),
    "ycbcr_of_one_sample": lambda: strip(pil_jpeg(GREY, quality=90), photometric=6),
    "five_components": lambda: strip(chip_smoke.jpeg_sof1(
        [GREY] * 5, np.full(64, 2), precision=8), 8, 5, 5, tags=[(338, 3, [0])]),
}


@pytest.mark.parametrize("name", sorted(PIL_REFUSES))
def test_jpeg_tiff_kinds_pil_refuses_are_corrupt(tmp_path, name):
    """A palette of 3 samples and WhiteIsZero, palette, RGB and YCbCr of 12
    bits (no PIL mode), a stream's precision not the TIFF's (libtiff's
    "Improper JPEG data precision"), YCbCr of one sample (libjpeg's
    conversion wants three) and a frame of 5 components (libjpeg-turbo
    finds a scan's components among the first 4 alone): PIL refuses each,
    the port calls it corrupt."""
    holds(tmp_path, PIL_REFUSES[name](), False)


# -- A.6.21: 12 bits ----------------------------------------------------------------

def test_sof1_writer_is_read_by_pil_as_its_source():
    """The 12-bit writer, proven: PIL's I;16 pixels of its stream (through
    libtiff) are within the quantisation of the source, with 8-bit and
    16-bit quantisation tables."""
    for quant, pq16, tol in ((np.ones(64), False, 1), (np.full(64, 3), True, 3),
                             (np.arange(1, 65), False, 40)):
        data = strip(chip_smoke.jpeg_sof1(TWELVE, quant, pq16=pq16), 12)
        with Image.open(io.BytesIO(data)) as im:
            assert im.mode == "I;16"
            assert np.abs(np.asarray(im).astype(np.int64) - TWELVE).max() <= tol


TWELVE_BITS = {
    "patched_8_bit_stream": lambda: strip(chip_smoke_frame_12(pil_jpeg(GREY, quality=90)), 12),
    "genuine": lambda: strip(chip_smoke.jpeg_sof1(TWELVE, np.ones(64)), 12),
    "coarse_16_bit_tables": lambda: strip(chip_smoke.jpeg_sof1(TWELVE, np.arange(1, 65) * 40,
                                                               pq16=True), 12),
    "restarts": lambda: strip(chip_smoke.jpeg_sof1(TWELVE, np.full(64, 2), restart=2), 12),
    "dc_categories_to_15": lambda: strip(chip_smoke.jpeg_sof1(
        np.where(np.arange(W)[None, :] % 16 < 8, 0, 4095) * np.ones((H, 1), np.int64), np.ones(64)),
        12),
    "strips_and_a_taller_last_stream": lambda: chip_smoke.jpeg_in_tiff(
        [chip_smoke.jpeg_sof1(TWELVE[:8], np.ones(64)), chip_smoke.jpeg_sof1(TWELVE[8:], np.ones(64))],
        W, 14, 12, 1, 1, rows_per_strip=8),
}


def chip_smoke_frame_12(stream: bytes) -> bytes:
    """A baseline JPEG's frame made a 12-bit SOF1: 8-bit data decoded at 12
    bits, round 2048."""
    d = bytearray(stream)
    at = d.index(b"\xff\xc0")
    d[at + 1], d[at + 4] = 0xC1, 12
    return bytes(d)


@pytest.mark.parametrize("name", sorted(TWELVE_BITS))
def test_12_bit_jpeg_tiff_reads_as_pil(tmp_path, name):
    """12-bit JPEG-in-TIFF: 8-bit data under a 12-bit frame (PIL's grey is
    255 everywhere), a genuine stream whose samples span 0 - 4095 with most
    under 256 (the clip and the exact low values both show), coarse 16-bit
    quantisation tables, restarts, DC differences of category 15, strips
    with a last stream taller than its strip: bit-equal with PIL."""
    data = TWELVE_BITS[name]()
    holds(tmp_path, data, True)
    grey = pil_grey(data)
    if name == "genuine":
        assert 0 < (grey == 255).mean() < 0.5 and (grey < 255).sum() > H * W // 2
    if name == "patched_8_bit_stream":
        assert (grey == 255).all()


def test_damaged_12_bit_probe_reads_as_pil():
    """A seeded probe of 120 damaged 12-bit streams (bytes replaced, cut,
    bytes taken out of the scan; restarts or not, 8- and 16-bit tables):
    bit-equal with PIL, whose grey keeps the samples under 256 (a missing
    interval is flat 2048, clipped)."""
    for seed in range(120):
        rs = np.random.RandomState(seed)
        h, w = int(rs.randint(8, 40)), 2 * int(rs.randint(4, 30))
        img = np.clip(rs.randint(0, 300, (h, w)) + (rs.rand(h, w) < 0.2) * rs.randint(0, 3800, (h, w)),
                      0, 4095)
        s = bytearray(chip_smoke.jpeg_sof1(img, np.full(64, rs.choice([1, 2, 8, 40])),
                                           restart=int(rs.choice([0, 0, 2, 5])), pq16=bool(rs.rand() < 0.3)))
        scan, how = s.index(b"\xff\xda") + 10, rs.randint(3)
        if how == 0:
            for _ in range(rs.randint(1, 5)):
                s[rs.randint(scan, len(s) - 2)] = rs.randint(256)
        elif how == 1:
            del s[rs.randint(scan, len(s)):]
        else:
            at = rs.randint(scan, len(s) - 2)
            del s[at:at + rs.randint(1, 20)]
        data = chip_smoke.jpeg_in_tiff([bytes(s)], w, h, 12, 1, 1)
        np.testing.assert_array_equal(tnative.decode(data), pil_grey(data), err_msg=f"seed {seed}")


def test_12_bit_odd_width_last_column_is_zero(tmp_path):
    """Of an odd width libtiff packs a row's samples in pairs and leaves
    the last unwritten, so PIL's last column is what its buffer held
    (differing from run to run); the port gives 0 there and PIL's grey
    everywhere else."""
    img = np.clip(np.random.RandomState(2).randint(0, 300, (H, 23)), 0, 4095)
    data = strip(chip_smoke.jpeg_sof1(img, np.ones(64)), 12, w=23)
    got, want = tnative.decode(data), pil_grey(data)
    assert not got[:, -1].any()
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])


# -- A.6.22: planes -------------------------------------------------------------------

def planar(planes, spp: int, photometric: int, rows: int = H, tile=None, tags=()) -> bytes:
    """A planar JPEG-in-TIFF of ``planes`` (each a list of its strips' or
    tiles' streams)."""
    streams = [s for p in planes for s in p]
    if tile is None:
        return chip_smoke.jpeg_in_tiff(streams, W, H, 8, photometric, spp, planar=2,
                                       rows_per_strip=rows, tags=tags)
    n = len(streams)
    return chip_smoke.tiff_pack(W, H, streams, [
        (258, 3, [8] * spp), (259, 3, [7]), (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [2]),
        (322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, lambda o: o[:n]),
        (325, 4, [len(s) for s in streams])] + list(tags))


def plane_strips(channel, rows: int):
    return [pil_jpeg(np.ascontiguousarray(channel[y:y + rows]), quality=90) for y in range(0, H, rows)]


def plane_tiles(channel, tw: int, th: int):
    pad = np.pad(channel, ((0, -H % th), (0, -W % tw)), mode="edge")
    return [pil_jpeg(np.ascontiguousarray(pad[y:y + th, x:x + tw]), quality=90)
            for y in range(0, pad.shape[0], th) for x in range(0, pad.shape[1], tw)]


def damaged(stream: bytes, at: float) -> bytes:
    d = bytearray(stream)
    d[int(len(d) * at)] ^= 0x5A
    return bytes(d)


PLANAR = {  # name -> (bytes, whether PIL reads it)
    "rgb_one_strip": (lambda: planar([plane_strips(RGB[..., i], H) for i in range(3)], 3, 2), True),
    "rgb_strips": (lambda: planar([plane_strips(RGB[..., i], 8) for i in range(3)], 3, 2, 8), True),
    "rgb_tiles": (lambda: planar([plane_tiles(RGB[..., i], 16, 16) for i in range(3)], 3, 2,
                                 tile=(16, 16)), True),
    "rgba": (lambda: planar([plane_strips(RGB[..., i % 3], H) for i in range(4)], 4, 2,
                            tags=[(338, 3, [2])]), True),
    "rgba_unassociated_by_default": (
        lambda: planar([plane_strips(RGB[..., i % 3], H) for i in range(4)], 4, 2), True),
    "cmyk": (lambda: planar([plane_strips(RGB[..., i % 3], H) for i in range(4)], 4, 5), True),
    "grey_alpha": (lambda: planar([plane_strips(RGB[..., i], H) for i in range(2)], 2, 1,
                                  tags=[(338, 3, [2])]), True),
    "damaged_green_plane": (lambda: planar([plane_strips(RGB[..., 0], H),
                                            [damaged(plane_strips(RGB[..., 1], H)[0], 0.6)],
                                            plane_strips(RGB[..., 2], H)], 3, 2), True),
    "cut_green_plane": (lambda: planar([plane_strips(RGB[..., 0], H),
                                        [plane_strips(RGB[..., 1], H)[0][:100]],
                                        plane_strips(RGB[..., 2], H)], 3, 2), False),
    "ycbcr_planes": (lambda: planar([plane_strips(RGB[..., i], H) for i in range(3)], 3, 6), False),
    "plane_stream_of_three_components": (
        lambda: planar([[pil_jpeg(RGB, quality=90)]] * 3, 3, 2), False),
    "plane_stream_2x2_sampled": (lambda: planar([[jpeg_bytes(RGB[..., i], ((2, 2),), 90)]
                                                 for i in range(3)], 3, 2), False),
}


@pytest.mark.parametrize("name", sorted(PLANAR))
def test_planar_jpeg_tiff_reads_as_pil(tmp_path, name):
    """Planar JPEG-in-TIFF, each plane's strip or tile its own stream of
    one component: RGB in one strip, in strips, in tiles; RGBA (with and
    without ExtraSamples: PIL's RGBa then), CMYK, grey + alpha; a plane
    whose stream is damaged (read on) or cut (libjpeg fails): bit-equal
    with PIL, or corrupt where PIL refuses (YCbCr in planes, a plane's
    stream of 3 components or of 2 x 2 sampling)."""
    build, reads = PLANAR[name]
    holds(tmp_path, build(), reads)


def test_contiguous_extra_samples_read_as_pil(tmp_path):
    """Contiguous JPEG-in-TIFF of a frame libtiff reads as it is and PIL's
    JPEG plugin would not (2 components): grey + alpha and a palette with
    alpha, bit-equal with PIL; RGBA and RGBX of 4 components too."""
    two = chip_smoke.jpeg_sof1([GREY, 255 - GREY], np.full(64, 2), precision=8)
    four = jpeg_bytes(np.dstack([RGB, RGB[..., :1]]), ((1, 1),) * 4, 90)
    files = {"la.tif": strip(two, 8, 1, 2, tags=[(338, 3, [2])]),
             "pa.tif": strip(two, 8, 3, 2, tags=[(338, 3, [2]), (320, 3, RAMP)]),
             "rgba.tif": strip(four, 8, 2, 4, tags=[(338, 3, [2])]),
             "rgbx.tif": strip(four, 8, 2, 4)}
    for name, data in files.items():
        holds(tmp_path, data, True, name)


# -- the datasets, phase 12 ------------------------------------------------------------

def test_datasets_read_the_new_kinds_as_jax(tmp_path, monkeypatch):
    """Two writers' WhiteIsZero, 12-bit and planar JPEG-in-TIFF scans
    beside PNGs, and a file PIL refuses: ``SignatureDataset`` bit-equal with
    the JAX package's (its PIL path), a zero image where PIL refuses."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    rs = np.random.RandomState(8)
    for wi in range(2):
        d = tmp_path / f"writer{wi}"
        d.mkdir()
        scan = pixels(rs, (40, 56)).astype(np.int64)
        for turn in (13, 14, 15):
            layout, data = chip_smoke.mixed_tiff(scan.astype(np.uint8), turn)
            (d / f"w{wi}_{layout}.tif").write_bytes(data)
        Image.fromarray(pixels(rs, (30, 70)).astype(np.uint8)).save(d / f"w{wi}_png.png")
    (tmp_path / "writer0" / "w0_refused.tif").write_bytes(PIL_REFUSES["rgb_12_bits"]())
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 9
    assert sum(not x.any() for x in t.images) == 1
    np.testing.assert_array_equal(t.images, j.images)


def test_phase_12_pages_read_as_their_digests():
    """``chip_smoke.a6_kind_pages`` (1200 x 500, built without PIL) decode
    to the digests of PIL's grey that the fixtures keep, as phase 12 holds
    them on the card's host; PIL gives those digests."""
    digests = dict(reversed(line.split()) for line in
                   (chip_smoke.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    pages = chip_smoke.a6_kind_pages(chip_smoke.golden_arrays())
    assert len(pages) == 6
    for name, data in pages.items():
        assert chip_smoke.gray_digest(pil_grey(data)) == digests[name]
        assert chip_smoke.gray_digest(tnative.decode(data, name)) == digests[name]


def test_mixed_tree_jpeg_kinds_read_as_pil(tmp_path):
    """``chip_smoke.mixed_tiff``'s JPEG-in-TIFF layouts of a scan read as
    PIL reads them."""
    scan = pixels(np.random.RandomState(5), (45, 62)).astype(np.uint8)  # even: see the odd width
    for turn in (13, 14, 15):
        layout, data = chip_smoke.mixed_tiff(scan, turn)
        path = tmp_path / f"{layout}.tif"
        path.write_bytes(data)
        assert_port_reads_as_pil(path)
