"""GIF (ROADMAP A.6.28) in the port's host decoder (``data/native/decode.cpp``,
``decode_gif``) against PIL, through the JAX package.

PIL reads a GIF's first frame: mode L where the frame has no colour table
or an identity ramp (the LZW indices are the grey), else P; a canvas of the
logical screen grown to hold the frame, filled with the frame's
transparency index (or 0); Pillow's own LZW decoder (GifDecode.c). The
files are written by ``chip_smoke.gif_file`` / ``gif_lzw`` (the writer
phase 12 uses on the card's host, which has no PIL), each case held to
PIL's grey, or to its refusal."""

import io

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels

import chip_smoke as cs
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset
from siggan_tpu_torch.data.native import loader as tnative

RS = np.random.RandomState(0)
FRAME = RS.randint(0, 256, (13, 17)).astype(np.uint8)
RAMP = np.repeat(np.arange(256), 3).reshape(256, 3)
TINT = RS.randint(0, 256, (256, 3))
BIG = RS.randint(0, 256, (120, 150)).astype(np.uint8)


def pil_grey(data: bytes):
    """PIL's ``convert("L")`` and mode, or (None, None) where PIL refuses."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("L")), im.mode
    except Exception:
        return None, None


def holds(data: bytes, mode=None):
    """The port reads ``data`` as PIL does (of PIL's ``mode``), or calls it
    corrupt where PIL refuses it (mode None)."""
    want, got_mode = pil_grey(data)
    assert got_mode == mode
    if want is None:
        with pytest.raises(ValueError):
            tnative.decode(data)
    else:
        np.testing.assert_array_equal(tnative.decode(data), want)


CODES_EARLY = cs.gif_lzw(FRAME.tobytes()[:50])
# name -> (file, PIL's mode; None where PIL refuses)
FILES = {
    "no_table": (lambda: cs.gif_file(FRAME), "L"),
    "identity_ramp_global": (lambda: cs.gif_file(FRAME, global_table=RAMP), "L"),
    "global_table": (lambda: cs.gif_file(FRAME, global_table=TINT), "P"),
    "local_table": (lambda: cs.gif_file(FRAME, local_table=TINT), "P"),
    "identity_local_over_global": (lambda: cs.gif_file(FRAME, global_table=TINT, local_table=RAMP), "L"),
    "local_over_identity_global": (lambda: cs.gif_file(FRAME, global_table=RAMP, local_table=TINT), "P"),
    "short_ramp": (lambda: cs.gif_file(FRAME % 4, global_table=RAMP[:4], bits=2), "L"),
    "indices_past_a_short_table": (lambda: cs.gif_file(FRAME, global_table=TINT[:4]), "P"),
    "transparency_smaller_frame": (lambda: cs.gif_file(FRAME, screen=(30, 25), at=(4, 3), global_table=TINT,
                                                       transparency=77), "P"),
    "transparency_smaller_frame_l": (lambda: cs.gif_file(FRAME, screen=(30, 25), at=(4, 3),
                                                         transparency=77), "L"),
    "smaller_frame": (lambda: cs.gif_file(FRAME, screen=(30, 25), at=(4, 3), global_table=TINT), "P"),
    "frame_past_the_screen": (lambda: cs.gif_file(FRAME, screen=(8, 8), at=(3, 2), global_table=TINT), "P"),
    "screen_0x0": (lambda: cs.gif_file(FRAME, screen=(0, 0), global_table=TINT), "P"),
    "full_table_clear": (lambda: cs.gif_file(BIG, global_table=TINT), "P"),
    "full_table_deferred_clear": (lambda: cs.gif_file(BIG, global_table=TINT, clear_when_full=False), "P"),
    "full_table_deferred_interlaced": (lambda: cs.gif_file(BIG, interlace=True, clear_when_full=False), "L"),
    "no_eoi_all_pixels": (lambda: cs.gif_file(FRAME, global_table=TINT, eoi=False), "P"),
    "gif87a": (lambda: b"GIF87a" + cs.gif_file(FRAME, global_table=TINT)[6:], "P"),
    "extensions": (lambda: cs.gif_file(FRAME, global_table=TINT, extensions=[
        b"\x21\xfe\x05hello\x03abc\x00", b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00",
        b"\x21\x01\x0c" + bytes(12) + b"\x02ab\x00", b"\x21\x77\x02zz\x00",
        b"\x21\xf9\x04\x00\x00\x00\x05\x00"]), "P"),
    "garbage_bytes_before_the_frame": (lambda: cs.gif_file(FRAME, global_table=TINT,
                                                           extensions=[b"\x00\x05\x99"]), "P"),
    # refused: EOI before the frame is full (the decoder's call ends; PIL's
    # read then finds the file's end), LZW cut before EOI, a code size past
    # 12, no image, NETSCAPE2.0 with no sub-block (PIL's reader then runs
    # on through the frame), a short graphic control extension
    "early_eoi": (lambda: cs.gif_file(FRAME, global_table=TINT, codes=CODES_EARLY), None),
    "early_eoi_transparency": (lambda: cs.gif_file(FRAME, global_table=TINT, transparency=9,
                                                   codes=CODES_EARLY), None),
    "lzw_cut_before_eoi": (lambda: cs.gif_file(FRAME, global_table=TINT, codes=cs.gif_lzw(
        FRAME.tobytes(), eoi=False)[:60]), None),
    "code_size_13": (lambda: cs.gif_file(FRAME, global_table=TINT, bits=13), None),
    "no_image": (lambda: cs.gif_file(FRAME, global_table=TINT)[:13 + 768] + b";", None),
    "netscape_without_sub_block": (lambda: cs.gif_file(FRAME, global_table=TINT, extensions=[
        b"\x21\xff\x0bNETSCAPE2.0\x00"]), None),
    "short_graphic_control": (lambda: cs.gif_file(FRAME, global_table=TINT, extensions=[
        b"\x21\xf9\x02\x01\x00\x00"]), None),
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_gif_kind_reads_as_pil(name):
    build, mode = FILES[name]
    holds(build(), mode)


@pytest.mark.parametrize("bits", [0, 1, 2, 3, 5, 7, 8, 9, 12])
def test_lzw_code_sizes_read_as_pil(bits):
    """Code sizes 0 to 12 (PIL's decoder takes any up to 12; a size below 2
    gives codes that never widen, and at 0 no EOI can be read: the data
    runs out first, which PIL refuses)."""
    frame = (FRAME.astype(int) % (1 << min(bits, 8))).astype(np.uint8)
    data = cs.gif_file(frame, global_table=TINT, bits=bits)
    holds(data, pil_grey(data)[1])


@pytest.mark.parametrize("h", range(1, 18))
def test_interlaced_rows_read_as_pil(h):
    """The four passes of an interlaced frame, every height a pass can end
    at, give the rows of the frame written in order."""
    frame = RS.randint(0, 256, (h, 5)).astype(np.uint8)
    data = cs.gif_file(frame, global_table=TINT, interlace=True)
    holds(data, "P")
    np.testing.assert_array_equal(tnative.decode(data), tnative.decode(cs.gif_file(frame, global_table=TINT)))


def test_early_eoi_past_pils_first_block_reads_on():
    """EOI only ends one call of PIL's decoder: past its first 64 KB read,
    the next call goes on with the codes after EOI (here the block's
    padding, then the next sub-blocks), as the port does."""
    big = RS.randint(0, 256, (400, 400)).astype(np.uint8)
    codes = cs.gif_lzw(big.tobytes()[:200000]) + cs.gif_lzw(big.tobytes()[200000:])
    data = cs.gif_file(big, global_table=TINT, codes=codes)
    assert len(data) > 2 * 65536
    holds(data, pil_grey(data)[1])


def damage(rs, data: bytes) -> bytes:
    """One of five damages: bytes changed anywhere, a byte of the header,
    tables or descriptor, the file truncated, a sub-block length changed
    (maybe past the file), three bytes of the codes replaced."""
    d, kind = bytearray(data), rs.randint(5)
    if kind == 0:
        for _ in range(rs.randint(1, 4)):
            d[rs.randint(6, len(d))] = rs.randint(0, 256)
    elif kind == 1:
        d[rs.randint(6, min(len(d), 800))] = rs.randint(0, 256)
    elif kind == 2:
        d = d[:rs.randint(6, len(d))]
    elif kind == 3:
        at = data.index(b"\x2c") + 10
        at += 3 * (2 << (data[at - 1] & 7)) if data[at - 1] & 0x80 else 0
        j, blocks = at + 1, []
        while j < len(d) and d[j]:
            blocks.append(j)
            j += d[j] + 1
        d[blocks[rs.randint(len(blocks))]] = rs.randint(0, 256)
    else:
        j = rs.randint(len(d) // 2, len(d))
        d[j:j + 3] = bytes(rs.randint(0, 256, 3))
    return bytes(d)


@pytest.mark.parametrize("part", range(2))
def test_damaged_gif_probe_reads_as_pil(part):
    """A.6.28's probe, 1500 files a part (seeded): GIFs with a global or a
    local table, none, interlaced, a frame off the screen's corner with
    transparency, 2-bit codes behind extensions; read bit-equal where PIL
    reads, corrupt where it refuses. It found the frame of width 0 at x 0,
    which PIL's decoder takes for the whole image, and EOI's end of a call;
    61,500 files of five seeds then read as PIL."""
    rs = np.random.RandomState(100 + part)
    bases = []
    for h, w in ((13, 17), (40, 31)):
        f = (rs.randint(0, 256, (h, w)) // 16 * 16).astype(np.uint8)
        bases += [cs.gif_file(f, global_table=TINT), cs.gif_file(f, interlace=True),
                  cs.gif_file(f, screen=(w + 5, h - 3), at=(2, 4), local_table=TINT, transparency=3),
                  cs.gif_file((f // 64).astype(np.uint8), global_table=RAMP[:4], bits=2, extensions=[
                      b"\x21\xfe\x03abc\x00", b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"])]
    verdicts = set()
    for i in range(1500):
        data = damage(rs, bases[i % len(bases)])
        want, _ = pil_grey(data)
        verdicts.add(want is not None)
        if want is None:
            with pytest.raises(ValueError):
                tnative.decode(data)
        else:
            np.testing.assert_array_equal(tnative.decode(data), want, err_msg=f"file {i}")
    assert verdicts == {True, False}


def test_datasets_read_gifs_named_png_as_jax(tmp_path, monkeypatch):
    """GIFs under .png and .gif names beside PNG scans: the JAX package
    globs the .png (PIL reads it by its content) and so does the port, and
    both SignatureDatasets give the same arrays."""
    from siggan_tpu.data.native import loader as jnative
    monkeypatch.setattr(jnative, "available", lambda: False)
    for k in range(3):
        scan = pixels(np.random.RandomState(k), (30 + 4 * k, 40)).astype(np.uint8)
        Image.fromarray(scan).save(tmp_path / f"w0_{k}.png")
        (tmp_path / f"w0_g{k}.png").write_bytes(cs.gif_file(scan, global_table=TINT, interlace=k == 1))
    t = tdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    j = jdataset.SignatureDataset(tmp_path, 32, use_cache=False)
    assert len(t) == 6 and all(x.any() for x in t.images)
    np.testing.assert_array_equal(t.images, j.images)
    assert_port_reads_as_pil(tmp_path / "w0_g1.png")


def test_phase_12_pages_read_as_their_digests():
    """``chip_smoke.a6_gif_pnm_pages``' GIF pages (1200 x 500, built without
    PIL) decode to the digests of PIL's grey that the fixtures keep."""
    digests = dict(reversed(line.split()) for line in
                   (cs.FIXTURES / "a6_pages.sha256").read_text().splitlines())
    pages = cs.a6_gif_pnm_pages(cs.golden_arrays())
    for name in ("gif_page.gif", "gif_interlaced_page.gif"):
        assert cs.gray_digest(pil_grey(pages[name])[0]) == digests[name]
        assert cs.gray_digest(tnative.decode(pages[name])) == digests[name]
