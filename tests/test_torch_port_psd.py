"""PSD (A.6.47) in the port's host decoder (``decode.cpp::decode_psd``),
bit-equal with PIL's ``Image.open(path).convert("L")`` (Pillow 12.1.0) on
hand-built Photoshop files (Pillow writes none; ``chip_smoke.psd_file``):
PsdImagePlugin's modes (MODES: 1- and 8-bit), its header, colour mode data,
resources and layer section as it reads them, the composite image raw or
through Pillow's PackBits decoder (not libtiff's), and the files PIL refuses
corrupt (``ValueError``)."""

import struct

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil
from torch_port_raster_cases import holds, image, pil_verdict, probe
from torch_port_text_cases import BASES, LUTS

import chip_smoke as cs

G = image(5, 9)
BITS = np.packbits(G > 120, axis=1)


def planes(channels: int):
    """``channels`` 8-bit planes."""
    return [G, 255 - G, G // 2, G // 3, G ^ 0x55][:channels]


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("mode,bits,channels", [(0, 1, 1), (0, 8, 1), (1, 8, 1), (1, 8, 2), (2, 8, 1),
                                                (3, 8, 3), (3, 8, 4), (3, 8, 5), (4, 8, 4), (4, 8, 5),
                                                (7, 8, 1), (7, 8, 3), (8, 8, 1), (8, 8, 2)])
def test_psd_modes_read_as_pil(tmp_path, compression, mode, bits, channels):
    """Each MODES entry PIL converts to L, raw and PackBits, of its channels
    and more: bitmap (1 bit, a set bit white), grey, indexed (a palette of
    768 bytes), RGB (4 channels: RGBA, 5: RGB), CMYK (inverted planes),
    multichannel and duotone (the first channel as L)."""
    ps = [BITS] if bits == 1 else planes(channels)
    data = cs.psd_file(ps, mode, bits=bits, compression=compression,
                       mode_data=LUTS["colour"] if mode == 2 else b"")
    (tmp_path / "f.psd").write_bytes(data)
    assert pil_verdict(tmp_path / "f.psd")[0] == "PSD"
    assert_port_reads_as_pil(tmp_path / "f.psd")
    (tmp_path / "f.png").write_bytes(data)
    assert_port_reads_as_pil(tmp_path / "f.png")


@pytest.mark.parametrize("mode_data", [0, 30, 767, 769])
def test_psd_indexed_without_a_768_byte_palette_reads_black(tmp_path, mode_data):
    """PIL takes a palette only from colour mode data of exactly 768 bytes:
    P without one converts to black, as the port reads it."""
    data = cs.psd_file([G], 2, mode_data=bytes(range(256)) * 3 + b"\x07" if mode_data == 769
                       else bytes(mode_data))
    fmt, want = holds(tmp_path / "f.psd", data)
    assert fmt == "PSD" and want is not None and not want.any()


@pytest.mark.parametrize("case", ["bits16", "lab", "lab_packbits", "too_few_channels", "compression2",
                                  "compression3", "bits2", "mode5", "version2"])
def test_psd_kinds_pil_refuses_are_corrupt(tmp_path, case):
    """16-bit (MODES has no key: PIL passes the file on, nothing takes it),
    LAB (PIL opens it, convert("L") refuses), fewer channels than the mode's
    (OSError), a compression other than 0 and 1 (no tile: "cannot load this
    image"), a depth or mode outside MODES, version 2: corrupt, as PIL
    refuses each."""
    files = {"bits16": cs.psd_file([np.repeat(G, 2, 1)], 1, bits=16),
             "lab": cs.psd_file(planes(3), 9), "lab_packbits": cs.psd_file(planes(3), 9, compression=1),
             "too_few_channels": cs.psd_file(planes(3), 3, channels=2),
             "compression2": cs.psd_file([G], 1, compression=2),
             "compression3": cs.psd_file([G], 1, compression=3),
             "bits2": cs.psd_file([G], 1, bits=2), "mode5": cs.psd_file([G], 5)}
    files["version2"] = files["lab"][:4] + b"\0\2" + cs.psd_file([G], 1)[6:]
    fmt, want = holds(tmp_path / "f.psd", files[case])
    assert want is None
    assert fmt == ("PSD" if case in ("lab", "lab_packbits", "compression2", "compression3") else None)


RES = b"8BIM" + struct.pack(">H", 1005) + b"\x03abc" + struct.pack(">I", 3) + b"xyz\0"


@pytest.mark.parametrize("case", ["resources", "odd_name", "even_name", "layers", "layers_and_resources",
                                  "layer_size_past_end", "resources_size_lies", "cut_in_resources"])
def test_psd_sections_before_the_image_as_pil(tmp_path, case):
    """Image resources read entry by entry (Pascal names padded to even,
    data padded to even) until their size is passed, the layer section
    skipped by its size: read as PIL reads them, refused where a read runs
    past the file's end."""
    res2 = b"8BIM" + struct.pack(">H", 7) + b"\x00\0" + struct.pack(">I", 1) + b"q\0"
    layers = struct.pack(">I", 10) + bytes(10)
    files = {"resources": cs.psd_file([G], 1, resources=RES),
             "odd_name": cs.psd_file([G], 1, resources=RES + res2),
             "even_name": cs.psd_file([G], 1, resources=b"8BIM\0\1\x02ab\0" + struct.pack(">I", 2) + b"xy"),
             "layers": cs.psd_file([G], 1, layers=layers),
             "layers_and_resources": cs.psd_file(planes(3), 3, compression=1, resources=RES, layers=layers),
             "layer_size_past_end": cs.psd_file([G], 1),
             "resources_size_lies": cs.psd_file([G], 1, resources=RES)}
    d = bytearray(files["layer_size_past_end"])
    struct.pack_into(">I", d, 34, 1 << 20)  # the layer section's size
    files["layer_size_past_end"] = bytes(d)
    d = bytearray(files["resources_size_lies"])
    struct.pack_into(">I", d, 30, 4)  # the resources' size: a part of the first entry
    files["resources_size_lies"] = bytes(d)
    files["cut_in_resources"] = files["resources"][:40]
    fmt, want = holds(tmp_path / "f.psd", files[case])
    if case in ("resources", "odd_name", "even_name", "layers", "layers_and_resources", "resources_size_lies"):
        assert fmt == "PSD" and want is not None
    else:
        assert want is None


def packbits_psd(streams, counts=None, h=2, w=4) -> bytes:
    """A grey PSD of hand-written PackBits ``streams`` (one a channel, all
    concatenated), ``counts`` the table of row byte counts."""
    body = b"".join(streams)
    counts = counts or [len(body) // (h * len(streams))] * (h * len(streams))
    head = (b"8BPS" + struct.pack(">H6xHIIHH", 1, len(streams), h, w, 8, 3 if len(streams) == 3 else 1)
            + struct.pack(">III", 0, 0, 0) + struct.pack(">H", 1))
    return head + struct.pack(f">{len(counts)}H", *counts) + body


PACKBITS = {
    "runs": packbits_psd([bytes([0xFD, 7, 0xFD, 9])]),
    "run_past_row": packbits_psd([bytes([0xF9, 7, 0xFD, 9])]),            # 8 copies cut at 4
    "literal_past_row": packbits_psd([bytes([5, 1, 2, 3, 4, 5, 6, 0xFD, 9])]),
    "nop": packbits_psd([bytes([0x80, 0xFD, 7, 0x80, 0x80, 3, 1, 2, 3, 4])]),
    "short_literal": packbits_psd([bytes([0xFD, 7, 5, 1, 2])]),
    "short_run": packbits_psd([bytes([0xFD, 7, 0xFD])]),
    "extra_bytes": packbits_psd([bytes([0xFD, 7, 0xFD, 9, 1, 2, 3])]),
    "counts_lie": packbits_psd([bytes([0xFD, 7, 0xFD, 9])] * 3, counts=[1, 1, 1, 1, 1, 1]),
    "counts_zero": packbits_psd([bytes([0xFD, 7, 0xFD, 9])] * 3, counts=[0] * 6),
    "counts_past_end": packbits_psd([bytes([0xFD, 7, 0xFD, 9])] * 3, counts=[60000] * 6),
    "table_cut": packbits_psd([bytes([0xFD, 7, 0xFD, 9])])[:-6],
}


@pytest.mark.parametrize("case", sorted(PACKBITS))
def test_psd_packbits_as_pil(tmp_path, case):
    """Pillow's PackDecode.c: a run or literal cut at the row's end (the
    rest dropped), 0x80 skipped, data ending inside a run or literal
    refused, each channel one stream from where the row counts place it
    (whatever they say: a stream reads on into the next channel's bytes,
    and one placed past the end is refused), a table cut short refused."""
    fmt, want = holds(tmp_path / "f.psd", PACKBITS[case])
    refused = ("short_literal", "short_run", "counts_past_end", "table_cut")
    assert (want is None) == (case in refused)


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("size", [(1, 1), (3, 17), (40, 3), (16, 130)])
def test_psd_sizes_read_as_pil(tmp_path, compression, size):
    """Sizes of one pixel, odd widths and rows past a PackBits op's 128
    bytes, grey and 1 bit."""
    g = image(*size, seed=size[1])
    for ps, bits in (([g], 8), ([np.packbits(g > 100, axis=1)], 1)):
        data = cs.psd_file(ps, 0 if bits == 1 else 1, bits=bits, compression=compression, width=size[1])
        fmt, want = holds(tmp_path / "f.psd", data)
        assert fmt == "PSD" and want is not None and want.shape == size


@pytest.mark.parametrize("part", range(3))
def test_damaged_psd_read_as_pil(tmp_path, part):
    """The probe (``scripts/raster_probe.py``), 200 files a part: the bases
    damaged six ways, each read bit-equal where PIL reads, corrupt where it
    refuses."""
    counts = probe(tmp_path / "f.png", BASES["PSD"](), 200 + part, 200)
    assert counts.get("PSD", [0, 0])[0] > 0 and sum(c[1] for c in counts.values()) > 0


def test_phase_12_pages_read_as_their_digests():
    """``chip_smoke.a6_text_pages``' PSD pages (raw and PackBits, 1200 x
    500, built without PIL) decode to the digests of PIL's grey that the
    fixtures keep, and so do the other pages of A.6.43-A.6.48."""
    digests = dict(reversed(line.split()) for line in
                   (cs.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    from siggan_tpu_torch.data.native import loader as tnative
    pages = cs.a6_text_pages(cs.golden_arrays())
    assert len(pages) == 7
    for name, data in pages.items():
        got = tnative.decode(data, name)
        assert got.shape == (500, 1200) and cs.gray_digest(got) == digests[name], name
    with Image.open(__import__("io").BytesIO(pages["psd_packbits_page.psd"])) as im:
        assert cs.gray_digest(np.asarray(im.convert("L"))) == digests["psd_packbits_page.psd"]
