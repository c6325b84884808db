"""JPEG data that ends without EOI, and PIL's 64 KB read blocks (ROADMAP
C.13), against PIL through the JAX package.

PIL hands libjpeg a file ``ImageFile.MAXBLOCK`` (64 KB) bytes at a time;
libjpeg suspends where it needs a byte past the end of what it holds, PIL
reads the next block, and once the file has none PIL refuses it ("image
file is truncated"). Whether a file whose scan data ends without EOI is
read therefore depends on where libjpeg-turbo's Huffman decoder fills its
bit buffer: its slow path only when a code needs more bits than it holds
(to 57 bits), its fast path six bytes whenever 16 bits or fewer are left,
taken while 512 bytes a block of the MCU are buffered and no restart
interval is set. Progressive, lossless and arithmetic-coded data end as
their decoders read it; an arithmetic-coded scan cannot suspend at all, so
PIL refuses one that runs past its first block. Each case holds the port
to PIL's outcome on the same bytes: bit-equal, or corrupt where PIL
refuses. The tests read with PIL's own block size (other test files raise
``MAXBLOCK`` for PIL's JPEG writer)."""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile
from test_torch_port_decode import FIXTURES, assert_port_reads_as_pil, pixels
from test_torch_port_progressive import pil_jpeg
from torch_port_jpeg_writers import arith_jpeg, lossless_jpeg

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset


@pytest.fixture(autouse=True)
def pil_block(monkeypatch):
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 65536)


def pil_reads(data: bytes) -> bool:
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.convert("L")
        return True
    except Exception:
        return False


def as_pil(tmp_path, data: bytes) -> bool:
    """The port reads the file as PIL does: bit-equal, or corrupt (a zero
    image, ValueError) where PIL refuses it. Returns whether PIL reads it."""
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    if pil_reads(data):
        assert_port_reads_as_pil(path)
        return True
    assert not jdataset.decode_image(path, 16).any()
    assert not tdataset.decode_image(path, 16).any()
    with pytest.raises(ValueError):
        tdataset.decode_gray(path)
    return False


def cuts(base: bytes, ends, tails):
    return [base[:len(base) - k] + t for k in ends for t in tails]


SMALL = {  # name -> a baseline file small enough to decode on the slow path alone
    "rgb_420": lambda: pil_jpeg(pixels(np.random.RandomState(1), (40, 56, 3)).astype(np.uint8),
                                quality=90, subsampling=2),
    "grey": lambda: pil_jpeg(np.random.RandomState(0).randint(0, 256, (16, 24)).astype(np.uint8),
                             quality=80),
    "rgb_444_q95": lambda: pil_jpeg(np.random.RandomState(2).randint(0, 256, (32, 32, 3))
                                    .astype(np.uint8), quality=95, subsampling=0),
    "restarts": lambda: pil_jpeg(np.random.RandomState(3).randint(0, 256, (48, 48))
                                 .astype(np.uint8), quality=50, restart_marker_blocks=3),
}
TAILS = [b"", b"\x52", b"\x52" * 3, b"\x52" * 9, b"\x00", b"\xff"]


@pytest.mark.parametrize("end", [2, 3, 5, 9, 14, 21])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_baseline_cut_reads_as_pil(tmp_path, name, end):
    """The EOI and ``end`` - 2 bytes of scan data cut, then nothing, or a
    few bytes that are not a marker: PIL reads the file where libjpeg's
    last fills stay inside it (the slow path's fill points, a long code's
    fill after its first 9 bits)."""
    outcomes = [as_pil(tmp_path, d) for d in cuts(SMALL[name](), [end], TAILS)]
    if end == 2:
        assert outcomes[-3] or outcomes[-2], "nine bytes past the data always fill"


def test_scan_ending_a_few_bytes_past_reads_as_pil_at_every_cut(tmp_path):
    """Every cut of a small file's last 40 bytes, with one or six bytes
    past it: both outcomes occur, and the port gives PIL's at each."""
    base = SMALL["rgb_420"]()
    outcomes = [as_pil(tmp_path, d) for d in cuts(base, range(2, 42), [b"\x52", b"\x52" * 6])]
    assert any(outcomes) and not all(outcomes)


@pytest.mark.parametrize("fixture", ["scan_444.jpg", "scan_422.jpg", "scan_420.jpg"])
def test_page_cut_reads_as_pil(tmp_path, fixture):
    """A 1200 x 500 scan (two of them over 64 KB: the fast path, and a
    block's end inside the scan data), cut near its end and in the middle."""
    base = (FIXTURES / fixture).read_bytes()
    ends = [2, 3, 7, 15, 40, 333, 4001]
    for d in cuts(base, ends, [b"", b"\x52"]):
        as_pil(tmp_path, d)


def test_page_over_a_block_reads_whole(tmp_path):
    """A page whose scan crosses PIL's 64 KB block reads, EOI and all."""
    base = (FIXTURES / "scan_444.jpg").read_bytes()
    assert len(base) > 65536
    assert as_pil(tmp_path, base)


def test_progressive_without_eoi_is_refused(tmp_path):
    """A progressive frame is read to EOI before any output: cut at its
    end (or inside its last scan) PIL refuses it, and so does the port."""
    base = pil_jpeg(pixels(np.random.RandomState(4), (40, 56, 3)).astype(np.uint8), quality=85,
                    progressive=True)
    for d in cuts(base, [2, 3, 8, 30], [b"", b"\x52" * 9]):
        assert not as_pil(tmp_path, d)


@pytest.mark.parametrize("restart_rows", [0, 2])
def test_lossless_cut_reads_as_pil(tmp_path, restart_rows):
    """A lossless scan decodes on the slow path's fill points."""
    g = pixels(np.random.RandomState(5), (20, 30)).astype(np.uint8)
    base = lossless_jpeg([g], psv=1, restart_rows=restart_rows)
    outcomes = [as_pil(tmp_path, d) for d in cuts(base, range(2, 14), [b"", b"\x52" * 4])]
    assert any(outcomes)


@pytest.mark.parametrize("restart", [0, 2])
def test_arithmetic_cut_reads_as_pil(tmp_path, restart):
    """The QM decoder reads a byte when it needs one, and zeros at a
    marker; past the end of the data the file is truncated."""
    g = pixels(np.random.RandomState(6), (24, 32, 3)).astype(np.uint8)
    base = arith_jpeg(pil_jpeg(g, quality=80), restart=restart)
    outcomes = [as_pil(tmp_path, d) for d in cuts(base, range(2, 12), [b"", b"\x52" * 4])]
    assert any(outcomes)


@pytest.mark.parametrize("height", [160, 192, 200, 500])
def test_arithmetic_scan_past_a_block_is_refused(tmp_path, height):
    """libjpeg's arithmetic decoder cannot suspend (JERR_CANT_SUSPEND):
    a scan whose data runs past PIL's first 64 KB block is refused, one
    inside it read (chip_smoke's arithmetic pages, 1200 wide)."""
    data = chip_smoke.tile_jpeg((FIXTURES / "arith_444.jpg").read_bytes(), 1200, height,
                                chip_smoke.page_pick)
    assert as_pil(tmp_path, data) == (len(data) < 65536)
