"""SPIDER (A.6.55) in the port's host decoder (``decode.cpp``:
``spider_open`` and ``decode_spider``), bit-equal with PIL's
``Image.open(path).convert("L")`` (Pillow 12.1.0) and with the JAX
package's ``decode_image``: SpiderImagePlugin's header tests (27 floats,
big-endian first; whole numbers that agree; a 2D image; the stack fields
as int() takes them) and its mode F of F;32BF or F;32F, through PIL's
float -> L rule (clipped, truncated, NaN 0), which the port shares with
PFM, IM and float TIFF (``float_grey``). Files are ``chip_smoke.py``'s
``spider_file`` (Pillow writes SPIDER too: its files are held here as well).
SPIDER has no magic: PIL tries it after every plugin before it in
``Image.ID``, and so does ``pil_format``."""

import io

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil
from torch_port_raster_cases import holds, image, pil_verdict, probe
from torch_port_texture_cases import BASES, spider_values

import chip_smoke as cs
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset


def reads(tmp_path, data: bytes, names=("f.png",)):
    for name in names:
        (tmp_path / name).write_bytes(data)
        got, grey = pil_verdict(tmp_path / name)
        assert got == "SPIDER" and grey is not None
        assert_port_reads_as_pil(tmp_path / name)


@pytest.mark.parametrize("big_endian", [True, False])
@pytest.mark.parametrize("values", ["grey", "stretched", "specials", "huge", "tiny"])
@pytest.mark.parametrize("size", [(6, 9), (1, 1), (40, 3), (3, 300)])
def test_spider_reads_as_pil(tmp_path, big_endian, values, size):
    """Big- and little-endian images of grey levels, of floats past 0 .. 255
    both ways with fractions, of NaN, +-inf and values past int32's range,
    of values past float32's int range, and of fractions below 1: convert
    ("L") clips and truncates, NaN is 0; under .spi and .png names."""
    h, w = size
    v = {"grey": lambda: image(h, w).astype(np.float32),
         "stretched": lambda: image(h, w).astype(np.float32) * 1.7 - 90.25,
         "specials": lambda: spider_values(h, w),
         "huge": lambda: np.where(image(h, w) > 128, 3.0e38, -3.0e38).astype(np.float32),
         "tiny": lambda: image(h, w).astype(np.float32) / 255.0}[values]()
    reads(tmp_path, cs.spider_file(v, big_endian), ("f.spi", "f.png"))


@pytest.mark.parametrize("mode", ["L", "F", "1", "RGB"])
def test_pillow_spider_reads_as_pil(tmp_path, mode):
    """Pillow's SPIDER writer (big-endian, mode F of any mode it converts)."""
    b = io.BytesIO()
    im = Image.fromarray(image(7, 11, 3 if mode == "RGB" else 0))
    im = im.convert(mode) if mode != "F" else Image.fromarray(image(7, 11).astype(np.float32) * 2 - 50)
    im.save(b, "SPIDER")
    reads(tmp_path, b.getvalue())


@pytest.mark.parametrize("stack", [1, 2, 7])
@pytest.mark.parametrize("big_endian", [True, False])
def test_stack_first_image_reads_as_pil(tmp_path, stack, big_endian):
    """istack > 0 and imgnumber 0: a stack opened for the first time, its
    first image after a second header (at twice the header's length)."""
    reads(tmp_path, cs.spider_file(spider_values(5, 8), big_endian, stack=stack))


SPIDER_HEADERS = {
    # (fields, what PIL does): "read", "refused" (Image.open fails or the
    # load does), "passed" (PIL passes the file on; nothing opens it)
    "image_in_stack": ({24: 0, 27: 3}, "refused"),           # self.stkoffset was never set
    "negative_stack": ({24: -1, 27: 0}, "passed"),
    "stack_and_number": ({24: 2, 27: 1}, "passed"),
    "stack_nan": ({24: float("nan")}, "refused"),
    "number_inf": ({27: float("inf")}, "refused"),
    "stack_image_count_nan": ({24: 1, 26: float("nan")}, "refused"),
    "stack_fraction": ({24: 0.5, 27: 0.25}, "read"),             # int() truncates to 0, 0
    "iform_3": ({5: 3}, "passed"),
    "iform_2": ({5: 2}, "passed"),
    "iform_minus_11": ({5: -11}, "passed"),
    "labbyt_disagrees": ({22: 1000}, "passed"),
    "labbyt_zero": ({13: 0, 22: 0}, "passed"),
    "labbyt_negative": ({13: -1, 22: -36}, "refused"),           # seek(-36)
    "header_past_the_file": ({13: 1000, 22: 36000}, "refused"),
    "width_fraction": ({12: 9.5}, "passed"),
    "width_zero": ({12: 0}, "passed"),
    "height_negative": ({2: -6}, "passed"),
    "bomb": ({12: 1.0e5, 2: 1.0e5}, "refused"),
    "nslice_fraction": ({1: 1.5}, "passed"),
    "lenbyt_nan": ({23: float("nan")}, "passed"),
}


@pytest.mark.parametrize("case", sorted(SPIDER_HEADERS))
@pytest.mark.parametrize("big_endian", [True, False])
def test_spider_header_rules_as_pil(tmp_path, case, big_endian):
    """isSpiderHeader's whole numbers (1, 2, 5, 12, 13, 22, 23; int() of
    NaN or inf fails the test) and labbyt = labrec * lenbyt (not 0), iform
    1 alone (another valid iform: SyntaxError, the other byte order not
    tried), the stack cases (an image within a stack reads an offset
    _open never set: AttributeError, which Image.open does not catch; NaN
    in the stack fields: ValueError), a negative or too large offset, no
    pixels, the bomb limit."""
    fields, verdict = SPIDER_HEADERS[case]
    fmt, want = holds(tmp_path / "f.png", cs.spider_file(spider_values(6, 9), big_endian, fields=fields))
    assert (want is not None) == (verdict == "read")
    assert (fmt == "SPIDER") == (verdict == "read") or verdict == "refused"


@pytest.mark.parametrize("cut", [1, 4, 35, 36 + 4 * 54])
def test_spider_data_cut_short_is_refused(tmp_path, cut):
    """The raw decoder needs every row: a file a byte short is refused, as
    in the JAX package (a zero image)."""
    data = cs.spider_file(spider_values(6, 9))
    fmt, want = holds(tmp_path / "f.png", data)
    assert fmt == "SPIDER" and want is not None
    assert holds(tmp_path / "f.png", data[:-cut]) == ("SPIDER", None)
    (tmp_path / "f.png").write_bytes(data[:-cut])
    assert not jdataset.decode_image(tmp_path / "f.png", 8).any()


def test_little_endian_tried_when_big_endian_is_no_header(tmp_path):
    """A little-endian file reads: its floats are no header big-endian."""
    data = cs.spider_file(image(6, 9).astype(np.float32), False)
    reads(tmp_path, data)
    assert not (tdataset.decode_gray(tmp_path / "f.png") == 0).all()


@pytest.mark.parametrize("part", range(3))
def test_damaged_files_read_as_pil(tmp_path, part):
    """The probe (``scripts/raster_probe.py``), 100 files a part: the bases
    damaged six ways, each read bit-equal where PIL reads, corrupt where it
    refuses."""
    counts = probe(tmp_path / "f.png", BASES["SPIDER"](), 300 + part, 100)
    assert counts.get("SPIDER", [0, 0])[0] > 0 and sum(c[1] for c in counts.values()) > 0
