"""Old-style JPEG-in-TIFF (compression 6, ROADMAP A.6.3) against PIL, through
the JAX package: both layouts libtiff reads, a JPEGInterchangeFormat stream
(tags 513/514) and raw scan data in strips with the tables in
JPEGQTables/JPEGDCTables/JPEGACTables, in grey and in YCbCr at every
subsampling libtiff's RGBA reader takes, with strips and restarts. libtiff
takes YCbCr from libjpeg raw, at each component's own resolution, and PIL
reads it through libtiff's RGBA reader, which gives each h x v block its
chroma as it is (no "fancy" upsampling) and converts with libtiff's own
tables, so the port's result is held to PIL's, not to the JPEG's own
decode. What PIL refuses is a zero image (C.10)."""

import io
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import (_STD_BITS, _STD_VALS, assert_port_reads_as_pil, jpeg_bytes,
                                    pixels)
from test_torch_port_progressive import pil_jpeg

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset


def segments(stream: bytes):
    """A JPEG stream's marker segments up to SOS ((marker, body) each), and
    its entropy-coded data (up to EOI)."""
    out, i = [], 2
    while True:
        m, n = stream[i + 1], struct.unpack(">H", stream[i + 2:i + 4])[0]
        out.append((m, stream[i + 4:i + 2 + n]))
        i += 2 + n
        if m == 0xDA:
            return out, stream[i:stream.rindex(b"\xff\xd9")]


def intervals(data: bytes) -> list:
    """Entropy-coded data cut at its restart markers (dropped)."""
    cuts = [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    return [data[a:b] for a, b in zip([0] + [c + 2 for c in cuts], cuts + [len(data)])]


def ojpeg_jif(stream: bytes, w: int, h: int, spp: int, *, photometric=6, sub=None,
              rows_per_strip=None, extra=()) -> bytes:
    """The first layout: JPEGInterchangeFormat gives the whole stream, and
    each strip points at its restart interval within it."""
    segs, data = segments(stream)
    head = len(stream) - len(data) - 2
    parts, starts, at = intervals(data), [], head
    for part in parts:
        starts.append(at)
        at += len(part) + 2
    tags = [(258, 3, [8] * spp), (259, 3, [6]), (262, 3, [photometric]), (277, 3, [spp]),
            (513, 4, lambda o: [o[0]]), (514, 4, [len(stream)]),
            (273, 4, lambda o: [o[0] + s for s in starts]), (278, 4, [rows_per_strip or h]),
            (279, 4, [len(p) for p in parts])]
    if sub:
        tags.append((530, 3, list(sub)))
    return chip_smoke.tiff_pack(w, h, [stream], tags + list(extra))


def ojpeg_tables(stream: bytes, w: int, h: int, spp: int, *, photometric=6, sub=None,
                 rows_per_strip=None, restart_tag=None, with_tables=True, tile=None) -> bytes:
    """The second layout: the stream's scan data in strips (one a restart
    interval), its tables in JPEGQTables / JPEGDCTables / JPEGACTables, an
    offset a component, shared where components share a table (libjpeg's
    default Huffman tables where the stream holds none). With ``tile`` =
    (tw, th) the intervals are tiles instead (the stream tw wide, its rows
    the tiles' one after another)."""
    segs, data = segments(stream)
    q, dc, ac = {}, {0: bytes(_STD_BITS["dc", 0]) + _STD_VALS["dc", 0]}, \
        {0: bytes(_STD_BITS["ac", 0]) + _STD_VALS["ac", 0]}
    for m, b in segs:
        i = 0
        while m == 0xDB and i < len(b):
            q[b[i] & 15], i = b[i + 1:i + 65], i + 65
        while m == 0xC4 and i < len(b):
            n = sum(b[i + 1:i + 17])
            (ac if b[i] >> 4 else dc)[b[i] & 15] = b[i + 1:i + 17 + n]
            i += 17 + n
    sof = next(b for m, b in segs if m in (0xC0, 0xC1))
    sos = next(b for m, b in segs if m == 0xDA)
    nc = sof[5]
    per_component = [[q[sof[8 + 3 * i]] for i in range(nc)],
                     [dc[sos[2 + 2 * i] >> 4] for i in range(nc)],
                     [ac[sos[2 + 2 * i] & 15] for i in range(nc)]]
    blobs = intervals(data)
    ns = len(blobs)
    place = {}
    for table in sum(per_component, []):
        if table not in place:
            place[table] = len(blobs)
            blobs.append(table)
    layout = ([(322, 4, [tile[0]]), (323, 4, [tile[1]]), (324, 4, lambda o: o[:ns]),
               (325, 4, [len(b) for b in blobs[:ns]])] if tile else
              [(273, 4, lambda o: o[:ns]), (278, 4, [rows_per_strip or h]),
               (279, 4, [len(b) for b in blobs[:ns]])])
    tags = [(258, 3, [8] * spp), (259, 3, [6]), (262, 3, [photometric]), (277, 3, [spp]),
            (512, 3, [1])] + layout
    if with_tables:
        for tag, tables in zip((519, 520, 521), per_component):
            tags.append((tag, 4, lambda o, tables=tables: [o[place[t]] for t in tables]))
    if sub:
        tags.append((530, 3, list(sub)))
    if restart_tag is not None:
        tags.append((515, 3, [restart_tag]))
    return chip_smoke.tiff_pack(w, h, blobs, tags)


SUBSAMPLING = {"444": ((1, 1), 0), "422": ((2, 1), 1), "420": ((2, 2), 2)}


@pytest.mark.parametrize("layout", ["jif", "tables"])
@pytest.mark.parametrize("kind", ["grey", "444", "422", "420"])
@pytest.mark.parametrize("size", [(16, 16), (37, 29), (48, 40)])
def test_ojpeg_matches_pil(tmp_path, layout, kind, size):
    """PIL's JPEGs wrapped in either layout, one strip."""
    h, w = size
    rs = np.random.RandomState(h * w)
    rgb = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)   # saturated: chroma matters
    wrap = ojpeg_jif if layout == "jif" else ojpeg_tables
    if kind == "grey":
        data = wrap(pil_jpeg(rgb[..., 0], quality=85), w, h, 1, photometric=1)
    else:
        sub, pil_sub = SUBSAMPLING[kind]
        data = wrap(pil_jpeg(rgb, quality=85, subsampling=pil_sub), w, h, 3, sub=sub)
    (tmp_path / "o.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "o.tif")


@pytest.mark.parametrize("layout", ["jif", "tables"])
@pytest.mark.parametrize("kind,rows", [("grey", 1), ("420", 1), ("420", 2), ("422", 1),
                                       ("444", 3)])
def test_ojpeg_strips_and_restarts_match_pil(tmp_path, layout, kind, rows):
    """Strips of ``rows`` MCU rows, each a restart interval of the stream
    (libtiff's restart interval when strips are shorter than the image; the
    tables layout's strips joined by the RSTn libtiff puts between them)."""
    h, w = 67, 45
    rgb = pixels(np.random.RandomState(rows), (h, w, 3)).astype(np.uint8)
    if kind == "grey":
        stream, spp, sub, mcu_h = pil_jpeg(rgb[..., 0], quality=80, restart_marker_rows=rows), 1, \
            None, 8
    else:
        sub, pil_sub = SUBSAMPLING[kind]
        stream = pil_jpeg(rgb, quality=80, subsampling=pil_sub, restart_marker_rows=rows)
        spp, mcu_h = 3, 8 * sub[1]
    wrap = ojpeg_jif if layout == "jif" else ojpeg_tables
    data = wrap(stream, w, h, spp, photometric=1 if spp == 1 else 6, sub=sub,
                rows_per_strip=rows * mcu_h)
    (tmp_path / "o.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "o.tif")


@pytest.mark.parametrize("sampling", [(4, 2), (4, 1), (1, 2), (2, 2)])
def test_ojpeg_subsamplings_match_pil(tmp_path, sampling):
    """Every luma sampling libtiff's RGBA reader converts and libjpeg takes
    (4 x 4 makes 18 blocks an MCU), in both layouts (the tag given or left
    to the stream in the first)."""
    h, w = 40, 72
    rgb = np.random.RandomState(sum(sampling)).randint(0, 256, (h, w, 3)).astype(np.uint8)
    stream = jpeg_bytes(rgb, (sampling, (1, 1), (1, 1)), 85)
    for i, data in enumerate((ojpeg_jif(stream, w, h, 3), ojpeg_jif(stream, w, h, 3, sub=sampling),
                              ojpeg_tables(stream, w, h, 3, sub=sampling))):
        (tmp_path / f"o{i}.tif").write_bytes(data)
        assert_port_reads_as_pil(tmp_path / f"o{i}.tif")


def test_ojpeg_colour_tags_and_photometric_match_pil(tmp_path):
    """ReferenceBlackWhite and YCbCrCoefficients set libtiff's conversion;
    photometric 2 of 3 samples, or none, libtiff takes for YCbCr; a grey
    stream reads as it is, WhiteIsZero too (PIL takes any compression-6
    file for photometric 6, which grey leaves alone)."""
    h, w = 32, 48
    rgb = np.random.RandomState(7).randint(0, 256, (h, w, 3)).astype(np.uint8)
    stream = pil_jpeg(rgb, quality=80, subsampling=2)
    grey = pil_jpeg(rgb[..., 1], quality=80)
    files = {
        "refbw_studio": ojpeg_jif(stream, w, h, 3, extra=[(532, 5, [
            (16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])]),
        "refbw_odd": ojpeg_jif(stream, w, h, 3, extra=[(532, 5, [(10, 1), (200, 1), (100, 1),
                                                                  (250, 1), (128, 2), (511, 2)])]),
        "bt709": ojpeg_jif(stream, w, h, 3, extra=[(529, 5, [(2126, 10000), (7152, 10000),
                                                              (722, 10000)])]),
        "photometric_2": ojpeg_jif(stream, w, h, 3, photometric=2),
        "grey_white_is_zero": ojpeg_jif(grey, w, h, 1, photometric=0),
    }
    for name, data in files.items():
        (tmp_path / f"{name}.tif").write_bytes(data)
        assert_port_reads_as_pil(tmp_path / f"{name}.tif")
    no_photometric = chip_smoke.tiff_pack(w, h, [stream], [
        (258, 3, [8] * 3), (259, 3, [6]), (277, 3, [3]), (273, 4, lambda o: [o[0]]),
        (278, 4, [h]), (279, 4, [len(stream)]), (513, 4, lambda o: [o[0]]),
        (514, 4, [len(stream)])])
    (tmp_path / "no_photometric.tif").write_bytes(no_photometric)
    assert_port_reads_as_pil(tmp_path / "no_photometric.tif")


def test_ojpeg_pil_refuses_is_a_zero_image(tmp_path):
    """Sampling libtiff leaves to libjpeg (chroma not 1 x 1, luma of 3),
    more blocks an MCU than libjpeg takes, YCbCr of one sample, a tables
    layout without its tables, and strips not whole MCU rows: PIL refuses
    each, and the port's grey is a zero image (``ValueError`` from
    ``decode_gray``)."""
    h, w = 32, 48
    rgb = np.random.RandomState(8).randint(0, 256, (h, w, 3)).astype(np.uint8)
    stream = pil_jpeg(rgb, quality=80, subsampling=2)
    files = {
        "chroma_2x2": (ojpeg_jif(jpeg_bytes(rgb, ((2, 2), (2, 2), (1, 1)), 85), w, h, 3),
                       "libjpeg"),
        "luma_3x1": (ojpeg_jif(jpeg_bytes(rgb, ((3, 1), (1, 1), (1, 1)), 85), w, h, 3), "libjpeg"),
        "luma_4x4": (ojpeg_jif(jpeg_bytes(rgb, ((4, 4), (1, 1), (1, 1)), 85), w, h, 3),
                     "more than 10 blocks"),
        "ycbcr_of_one_sample": (ojpeg_jif(pil_jpeg(rgb[..., 0], quality=80), w, h, 1),
                                "one YCbCr sample"),
        "no_tables": (ojpeg_tables(stream, w, h, 3, sub=(2, 2), with_tables=False),
                      "without JPEG tables"),
        "strips_of_12_rows": (ojpeg_jif(pil_jpeg(rgb, quality=80, subsampling=2,
                                                 restart_marker_blocks=2), w, h, 3, sub=(2, 2),
                                        rows_per_strip=12), "not whole MCU rows"),
    }
    for name, (data, what) in files.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(data)
        with pytest.raises(Exception):
            with Image.open(path) as im:
                im.convert("L")
        assert not jdataset.decode_image(path, 16).any()
        np.testing.assert_array_equal(tdataset.decode_image(path, 16),
                                      jdataset.decode_image(path, 16))
        with pytest.raises(ValueError, match=what):
            tdataset.decode_gray(path)


def test_ojpeg_page_of_the_smoke_is_pils(tmp_path):
    """``chip_smoke.ojpeg_wrap`` of a 4:2:0 scan-shaped JPEG (the phase-12
    page's layout, at a small size here) reads as PIL reads it, and off the
    JPEG's own decode where its chroma is saturated."""
    rgb = np.random.RandomState(9).randint(0, 256, (80, 96, 3)).astype(np.uint8)
    stream = pil_jpeg(rgb, quality=90, subsampling=2)
    (tmp_path / "page.tif").write_bytes(chip_smoke.ojpeg_wrap(stream, 96, 80, 3))
    assert_port_reads_as_pil(tmp_path / "page.tif")
    with Image.open(io.BytesIO(stream)) as im:
        plain = np.asarray(im.convert("L"))
    assert (tdataset.decode_gray(tmp_path / "page.tif") != plain).any()
