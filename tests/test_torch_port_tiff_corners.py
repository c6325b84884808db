"""The last TIFF corners of ROADMAP A.6 in the port's host decoder
(``data/native/decode.cpp``) against PIL, through the JAX package: LZMA's
ARM64 and RISC-V BCJ filters (A.6.25), a tag given twice (A.6.26), the
planar PX tile whose last rows PIL reads past its buffer (A.6.27), and
libtiff's tiling by the tile size alone (C.19).

liblzma's ARM64 filter converts BL and, within +-512 MiB, ADRP; its RISC-V
filter JAL of rd x1 or x5 and AUIPC with the instruction after it (see
``test_torch_port_tiff_lzma_zstd.riscv_code``). Both take a start offset,
which must be a multiple of the filter's alignment (4 and 2), as every BCJ
filter's must: liblzma refuses another, and PIL the file. The test data is
what each filter rewrites, so a decoder passing the bytes through fails.

A tag given twice: PIL keeps the last entry it reads, libtiff the first.
On libtiff's route libtiff decodes with its own (compression, predictor,
FillOrder, strips or tiles, samples a pixel, planes, photometric for its
YCbCr reader and JPEG's colour conversion, SampleFormat, ColorMap), and
PIL unpacks what libtiff gives with the raw mode of its own; the size and
BitsPerSample given otherwise PIL's decoder refuses (C.16)."""

import itertools
import lzma
import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels
from test_torch_port_lzw_ojpeg_tiles import holds, pil_grey
from test_torch_port_progressive import pil_jpeg
from test_torch_port_tiff_lzma_zstd import (LZMA, arm64_code, bcj_filter_tiff, grey_strip,
                                            riscv_code, with_block_header, xz)

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu.data.native import loader as jnative
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative

CODE = {0x0A: arm64_code, 0x0B: riscv_code}


# -- A.6.25: ARM64 and RISC-V BCJ --------------------------------------------------------

@pytest.mark.parametrize("start", [0, 2, 4, 64, 1 << 20, 6, (1 << 31) + 4])
@pytest.mark.parametrize("filter_id", [0x0A, 0x0B])
def test_bcj_filters_read_as_pil(tmp_path, filter_id, start):
    """A page of code each filter rewrites, at start offsets aligned to it
    and not (ARM64 at 2 and 6 is refused: liblzma's options error): bit-equal
    with PIL where it reads, and then not the bytes written."""
    data = bcj_filter_tiff(filter_id, seed=start % 97, start=start, w=64, h=24)
    reads = start % (4 if filter_id == 0x0A else 2) == 0
    holds(tmp_path, data, reads)
    if reads:
        code = CODE[filter_id](np.random.RandomState(start % 97), 64 * 24)
        assert (pil_grey(data) != np.frombuffer(code, np.uint8).reshape(24, 64)).sum() > 20


@pytest.mark.parametrize("filter_id", [0x0A, 0x0B])
def test_bcj_data_ending_mid_instruction_reads_as_pil(tmp_path, filter_id):
    """Sizes that end inside an instruction (the filter leaves those last
    bytes as they are), strips of odd counts, one byte to some hundreds:
    each bit-equal with PIL."""
    for seed in range(8):
        rs = np.random.RandomState(100 + seed)
        w, h = int(rs.randint(1, 70)), int(rs.randint(1, 30))
        holds(tmp_path, bcj_filter_tiff(filter_id, seed=100 + seed, w=w, h=h), True, f"{seed}.tif")


def with_start_offset(stream: bytes, start: int) -> bytes:
    """A single-block stream with its first filter's start offset property
    set to ``start`` (4 bytes), its block header's CRC made good."""
    return with_block_header(stream, lambda h: h.__setitem__(slice(4, 8), struct.pack("<I", start)))


@pytest.mark.parametrize("fid,align", [(lzma.FILTER_POWERPC, 4), (lzma.FILTER_IA64, 16),
                                       (lzma.FILTER_ARM, 4), (lzma.FILTER_ARMTHUMB, 2),
                                       (lzma.FILTER_SPARC, 4), (lzma.FILTER_X86, 1)])
def test_bcj_start_offsets_off_the_alignment_are_corrupt(tmp_path, fid, align):
    """Every BCJ filter's start offset must be a multiple of its alignment
    (simple_coder.c): a stream whose property says otherwise (written
    aligned, then patched) PIL refuses, and the port calls it corrupt; x86's
    alignment of 1 takes any."""
    raw = np.random.RandomState(fid).randint(0, 256, 64 * 8).astype(np.uint8).tobytes()
    s = xz(raw, filters=[{"id": fid, "start_offset": 16 * align}, {"id": lzma.FILTER_LZMA2}])
    for start in (align * 5, align * 5 + 1):
        holds(tmp_path, grey_strip(with_start_offset(s, start), LZMA, 64, 8),
              start % align == 0, f"{start}.tif")


# -- A.6.26: a tag given twice ------------------------------------------------------------

RS = np.random.RandomState(26)
H, W = 12, 20
G = RS.randint(0, 256, (H, W, 1))
RGB = RS.randint(0, 256, (H, W, 3))
BILEVEL = (RS.rand(H, W, 1) < 0.3).astype(np.int64)
PAL = list(range(0, 65536, 256)) * 3
PAL2 = list(range(65535, -1, -256)) * 3
BASES = {  # name -> tiff_layout arguments
    "grey_zip": dict(samples=G, bits=8, photometric=1, compression=8, rows_per_strip=4),
    "grey_lzw_predictor": dict(samples=G, bits=8, photometric=1, compression=5, rows_per_strip=4,
                               predictor=2),
    "rgb_zip": dict(samples=RGB, bits=8, photometric=2, compression=8, rows_per_strip=6),
    "rgb_zip_planar": dict(samples=RGB, bits=8, photometric=2, compression=8, rows_per_strip=6,
                           planar=2),
    "grey_zip_tiles": dict(samples=G, bits=8, photometric=1, compression=8, tile=(16, 16)),
    "bilevel_packbits": dict(samples=BILEVEL, bits=1, photometric=0, compression=32773,
                             rows_per_strip=5),
    "palette_zip": dict(samples=G, bits=8, photometric=3, compression=8, rows_per_strip=4,
                        tags=[(320, 3, PAL)]),
}
VALUES = {  # tag -> values given in turn, two at a time
    259: [1, 5, 8, 32773, 7, 4], 262: [0, 1, 2, 3, 5, 6], 266: [1, 2], 277: [1, 2, 3, 4],
    278: [1, 3, 4, 6, 12], 284: [1, 2], 292: [0, 1, 4], 317: [1, 2], 322: [16, 32],
    323: [16, 32], 338: [0, 1, 2], 339: [1, 2, 3], 530: [[1, 1], [2, 2], [2, 1]],
    320: ["PAL", "PAL2"],
}


def twice(base: str, tag: int, first, last) -> bytes:
    kw = dict(BASES[base])
    tags = [t for t in kw.pop("tags", []) if t[0] != tag]
    values = [{"PAL": PAL, "PAL2": PAL2}.get(v, v) if isinstance(v, str) else
              v if isinstance(v, list) else [v] for v in (first, last)]
    return chip_smoke.tiff_layout(kw.pop("samples"), kw.pop("bits"), kw.pop("photometric"), **kw,
                                  tags=tags + [(tag, 3, values[0]), (tag, 3, values[1])])


def judge(data: bytes, what: str) -> bool:
    """The port reads ``data`` as PIL does, bit-equal, or is corrupt where
    PIL refuses it; returns whether PIL reads it."""
    want = pil_grey(data)
    if want is None:
        with pytest.raises(ValueError):
            tnative.decode(data)
        return False
    np.testing.assert_array_equal(tnative.decode(data), want, err_msg=what)
    return True


@pytest.mark.parametrize("base", sorted(BASES))
def test_each_tag_given_twice_reads_as_pil(base):
    """Every tag the decoder reads, given twice with each ordered pair of
    its values, over grey, RGB, planar, tiled, bilevel and palette files in
    Deflate, LZW and PackBits: each file reads bit-equal with PIL or is
    corrupt where PIL refuses it, and both happen."""
    verdicts = [judge(twice(base, tag, a, b), f"{base} {tag} {a} {b}")
                for tag, values in VALUES.items() for a, b in itertools.permutations(values, 2)]
    assert any(verdicts) and not all(verdicts)


def jpeg_strip(stream: bytes, spp: int, photometric: int, extra=()):
    return [(258, 3, [8] * spp), (259, 3, [7]), (262, 3, [photometric]), (277, 3, [spp]),
            (273, 4, lambda o: o[:1]), (278, 4, [H]), (279, 4, [len(stream)])] + list(extra)


JPEG_BASES = {
    "jpeg_grey": lambda: (pil_jpeg(G[..., 0].astype(np.uint8), quality=90), 1, 1, ()),
    "jpeg_ycbcr": lambda: (pil_jpeg(RGB.astype(np.uint8), quality=90, subsampling=2), 3, 6,
                           [(530, 3, [2, 2])]),
    "jpeg_rgb": lambda: (pil_jpeg(RGB.astype(np.uint8), quality=90, subsampling=0), 3, 2, ()),
}
JPEG_VALUES = {259: [8, 7, 1, 5], 262: [1, 2, 6, 0, 3], 277: [1, 3], 284: [1, 2],
               530: [[1, 1], [2, 2], [2, 1], [4, 4]]}


@pytest.mark.parametrize("base", sorted(JPEG_BASES))
def test_jpeg_tags_given_twice_read_as_pil(base):
    """JPEG-in-TIFF of grey, YCbCr 4:2:0 and RGB with a tag given twice:
    libtiff converts YCbCr by its own photometric and checks the stream's
    components and sampling against its own samples; PIL unpacks YCbCr of
    its own as RGB when its own compression is JPEG (else RGBX, which its
    decoder refuses over libtiff's rows), and YCbCr libtiff sees outside
    JPEG through libtiff's RGBA reader with its own raw mode: as PIL."""
    stream, spp, photometric, extra = JPEG_BASES[base]()
    entries = jpeg_strip(stream, spp, photometric, extra)
    verdicts = []
    for tag, values in JPEG_VALUES.items():
        for a, b in itertools.permutations(values, 2):
            pair = [(tag, 3, v if isinstance(v, list) else [v]) for v in (a, b)]
            data = chip_smoke.tiff_pack(W, H, [stream], [e for e in entries if e[0] != tag] + pair)
            verdicts.append(judge(data, f"{base} {tag} {a} {b}"))
    assert any(verdicts) and not all(verdicts)


def test_offsets_and_counts_given_twice_read_as_pil():
    """StripOffsets, StripByteCounts and RowsPerStrip given twice (the real
    ones first or last) over Deflate, LZW and uncompressed strips: as PIL
    (libtiff's strips by its first entries, PIL's raw decoder's by its
    last)."""
    verdicts = []
    for compression in (8, 5, 1):
        strips = chip_smoke.tiff_strips(chip_smoke.tiff_layout(G, 8, 1, compression=compression,
                                                               rows_per_strip=4))["strips"]
        real = {273: lambda o: o[:3], 279: [len(b) for b in strips], 278: [4]}
        for tag, other in ((273, lambda o: [x + 2 for x in o[:3]]), (273, lambda o: o[:3][::-1]),
                           (279, [1, 2, 3]), (279, [999] * 3), (278, [8])):
            for pair in ([(tag, 4, real[tag]), (tag, 4, other)], [(tag, 4, other), (tag, 4, real[tag])]):
                entries = [(258, 3, [8]), (259, 3, [compression]), (262, 3, [1]), (277, 3, [1]),
                           (273, 4, real[273]), (278, 4, [4]), (279, 4, real[279])]
                data = chip_smoke.tiff_pack(W, H, strips, [e for e in entries if e[0] != tag] + pair)
                verdicts.append(judge(data, f"{compression} {tag}"))
    assert any(verdicts) and not all(verdicts)


def test_a_plane_past_libtiffs_samples_reads_strip_0(tmp_path):
    """SamplesPerPixel given twice on a planar file, 1 then 3: libtiff has
    one plane of strips, and TIFFComputeStrip gives strip 0 for a plane
    past it, so PIL reads the first strip of the first plane for every
    strip of planes 2 and 3; in tiles TIFFReadTile refuses such a plane
    (corrupt)."""
    rgb = RS.randint(0, 256, (H, W, 3))
    data = chip_smoke.tiff_layout(rgb, 8, 2, compression=8, planar=2, rows_per_strip=4,
                                  tags=[(277, 3, [1]), (277, 3, [3])])
    holds(tmp_path, data, True)
    tiles = chip_smoke.tiff_layout(rgb, 8, 2, compression=8, planar=2, tile=(16, 16),
                                   tags=[(277, 3, [1]), (277, 3, [3])])
    holds(tmp_path, tiles, False, "tiles.tif")


# -- C.19: tiles by the tile size ----------------------------------------------------------

@pytest.mark.parametrize("tags", [[(322, 3, [16])], [(323, 3, [16])], [(322, 3, [16]), (323, 3, [16])],
                                  [(322, 3, [32]), (323, 3, [16])]])
@pytest.mark.parametrize("compression", [8, 32773])
def test_tile_size_on_a_strip_file(tmp_path, tags, compression):
    """C.19: libtiff takes an image for tiled when its directory gives a
    tile size (TileWidth or TileLength), and StripOffsets for its tile
    offsets (one field): a strip file with TileWidth alone has no tiles
    (libtiff refuses it), with both its strips are read as tiles. The port
    took the layout from which offsets the file gave. PIL refuses each of
    these files; corrupt."""
    data = chip_smoke.tiff_layout(G, 8, 1, compression=compression, rows_per_strip=4, tags=tags)
    holds(tmp_path, data, False)


def test_strips_read_as_tiles_where_the_sizes_agree(tmp_path):
    """Strips that happen to be whole tiles (the image one tile wide, the
    strips as high as a tile) and a tile size: libtiff reads them as tiles
    and PIL reads the file; bit-equal."""
    g = RS.randint(0, 256, (32, 16, 1))
    data = chip_smoke.tiff_layout(g, 8, 1, compression=8, rows_per_strip=16,
                                  tags=[(322, 3, [16]), (323, 3, [16])])
    holds(tmp_path, data, True)


# -- A.6.27: the planar PX tile -------------------------------------------------------------

PX_PAL = list(np.arange(256) * 257) + list(np.arange(256)[::-1] * 257) + list(np.arange(256) // 2 * 257)


@pytest.mark.parametrize("h,w,tile", [(16, 19, (16, 16)), (16, 40, (16, 16)), (32, 16, (16, 16)),
                                      (20, 30, (32, 16)), (15, 12, (16, 8))])
def test_planar_px_tiles_past_the_buffer(tmp_path, h, w, tile):
    """Planar PX in tiles: PIL reads a tile row's pixel c from byte 2c of
    the first plane's tile, on into the next row, and in a tile's last rows
    past the tile's buffer (memory that differs from run to run). The port
    reads every other pixel as PIL does and takes a sample of 0 there, palette
    entry 0's grey (A.6.27)."""
    rs = np.random.RandomState(h * w)
    smp = np.dstack([rs.randint(1, 256, (h, w)), rs.randint(0, 256, (h, w))])
    data = chip_smoke.tiff_layout(smp, 8, 3, compression=5, planar=2, tile=tile,
                                  tags=[(338, 3, [0]), (320, 3, PX_PAL)])
    (tmp_path / "px.tif").write_bytes(data)
    tw, th = tile
    r, c = np.mgrid[0:h, 0:w]
    past = (r % th) * tw + 2 * (c % tw) >= tw * th
    got, want = tnative.decode(data), pil_grey(data)
    entry_0 = (0 * 19595 + 255 * 38470 + 0 * 7471 + 0x8000) >> 16   # PX_PAL[0] is (0, 255, 0)
    assert past.any() and (got[past] == entry_0).all()
    np.testing.assert_array_equal(got[~past], want[~past])
    np.testing.assert_array_equal(tdataset.decode_image(tmp_path / "px.tif", 16).shape, (16, 16, 1))


# -- the datasets, phase 12 ------------------------------------------------------------

def test_datasets_read_the_new_kinds_as_jax(tmp_path, monkeypatch):
    """Two writers' scans as LZMA with the ARM64 filter, with a photometric
    given twice and with RISC-V code, beside PNGs: ``SignatureDataset``
    bit-equal with the JAX package's (its PIL path)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    rs = np.random.RandomState(12)
    for wi in range(2):
        d = tmp_path / f"writer{wi}"
        d.mkdir()
        scan = pixels(rs, (40, 56)).astype(np.uint8)
        layout, data = chip_smoke.mixed_tiff(scan, 18)
        (d / f"w{wi}_{layout}.tif").write_bytes(data)
        (d / f"w{wi}_twice.tif").write_bytes(chip_smoke.tiff_layout(
            scan[..., None].astype(np.int64), 8, 1, compression=8, tags=[(262, 3, [1]), (262, 3, [0])]))
        (d / f"w{wi}_riscv.tif").write_bytes(bcj_filter_tiff(0x0B, seed=wi, w=56, h=40))
        Image.fromarray(pixels(rs, (30, 70)).astype(np.uint8)).save(d / f"w{wi}_png.png")
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert [p.name for p in t.paths] == [p.name for p in j.paths] and len(t) == 8
    np.testing.assert_array_equal(t.images, j.images)


def test_mixed_tree_arm64_layout_reads_as_pil(tmp_path):
    """``chip_smoke.mixed_tiff``'s LZMA layout with the ARM64 filter reads
    as PIL reads it."""
    scan = pixels(np.random.RandomState(13), (45, 61)).astype(np.uint8)
    layout, data = chip_smoke.mixed_tiff(scan, 18)
    assert layout == "lzma_arm64"
    (tmp_path / "a.tif").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "a.tif")
