"""Every format PIL opens is read or raised naming it and ROADMAP A.6 (C.21).

The JAX package opens every file through ``Image.open``, which tries each
of Pillow 12.1.0's plugins whatever the file's name, so a PGM or an XBM
saved as ``.png`` reaches it and reads. The port's decoder finds the format
by the same rules (``decode.cpp::pil_format``: preinit's plugins, then
``Image.ID``'s, each ``_accept`` and the header checks of each ``_open``):
a file PIL opens as a format the port reads (PNG, JPEG and MPO, BMP, TIFF,
GIF, PPM, WEBP, DIB, TGA, PCX, DCX, ICO, CUR, SGI, SUN, MSP, QOI, IM, PSD,
XBM, XPM, XVThumb) reads bit-equal; one of another format raises
``NotImplementedError`` naming that format and A.6, never a zero image; a
file PIL identifies as nothing, and the formats whose pixels PIL refuses
(EPS here, the stubs BUFR, GRIB, HDF5 and WMF, MPEG), are corrupt."""

import io
import re
import struct
import warnings

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil, pixels
from torch_port_raster_cases import READ

import chip_smoke
from siggan_tpu.data import dataset as jdataset
from siggan_tpu_torch.data import dataset as tdataset

H, W = 6, 9
GREY = (np.arange(H * W).reshape(H, W) * 4).astype(np.uint8)


def written(fmt: str, mode: str):
    g = (np.arange(20 * 28).reshape(20, 28) * 7 % 256).astype(np.uint8)
    b = io.BytesIO()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            Image.fromarray(g).convert(mode).save(b, fmt)
    except Exception:
        return None
    return b.getvalue()


def writer_cases():
    """(format, mode) of every Pillow writer that takes the mode (L, RGB, 1
    or P), from a 20 x 28 grey image."""
    Image.init()
    return [(fmt, mode) for fmt in sorted(Image.SAVE) for mode in ("L", "RGB", "1", "P")
            if written(fmt, mode) is not None]


def pil_format(data: bytes):
    """(format, grey) as PIL opens and converts the file; grey None where
    PIL refuses its pixels; (None, None) where PIL identifies nothing."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            im = Image.open(io.BytesIO(data))
        except Exception:
            return None, None
        try:
            return im.format, np.asarray(im.convert("L"))
        except Exception:
            return im.format, None


def holds(tmp_path, data: bytes, fmt: str):
    """The port reads the file as PIL does (a format it reads) or raises
    naming ``fmt`` and A.6; as ``.png`` too, where the JAX package reads it."""
    path = tmp_path / "f.png"
    path.write_bytes(data)
    if fmt in READ:
        assert_port_reads_as_pil(path)
        return
    assert jdataset.decode_image(path, 16).any()
    with pytest.raises(NotImplementedError, match=re.compile(f"{fmt}.*ROADMAP A.6", re.I)):
        tdataset.decode_gray(path)


@pytest.mark.parametrize("fmt,mode", writer_cases())
def test_every_pillow_writer_reads_or_raises_a6(tmp_path, fmt, mode):
    """Each format Pillow writes, in each mode its writer takes: where PIL
    reads the file back, the port reads it bit-equal or raises naming the
    format; where PIL refuses it (EPS without Ghostscript; PALM and PDF,
    which PIL cannot read), the port calls it corrupt."""
    data = written(fmt, mode)
    got, grey = pil_format(data)
    if grey is None:
        assert fmt in ("EPS", "PALM", "PDF")
        (tmp_path / "f.png").write_bytes(data)
        with pytest.raises(ValueError):
            tdataset.decode_gray(tmp_path / "f.png")
        return
    holds(tmp_path, data, got)


@pytest.mark.parametrize("fmt", sorted(chip_smoke.c21_files()))
def test_hand_written_files_raise_naming_their_format(tmp_path, fmt):
    """``chip_smoke.c21_files`` (phase 12's C.21 tree, written without
    PIL): XPM, PSD, SUN, CUR, DCX and the rest are genuine files PIL opens
    as that format and reads; the port reads the formats of A.6.33-A.6.55
    bit-equal and raises naming each other one."""
    data = chip_smoke.c21_files()[fmt]
    got, grey = pil_format(data)
    assert got == fmt and grey is not None and grey.size
    holds(tmp_path, data, fmt)


@pytest.mark.parametrize("fmt", chip_smoke.C21_READ)
def test_c21_files_the_port_reads_hold_their_greys(tmp_path, fmt):
    """``chip_smoke.c21_greys`` (what phase 12 holds the C.21 files of
    ``C21_READ`` to, with no PIL on the card's host) is PIL's grey of each
    file, and the port's."""
    want = chip_smoke.c21_greys()[fmt]
    got, grey = pil_format(chip_smoke.c21_files()[fmt])
    assert got == fmt
    np.testing.assert_array_equal(grey, want)
    (tmp_path / "f.png").write_bytes(chip_smoke.c21_files()[fmt])
    np.testing.assert_array_equal(tdataset.decode_gray(tmp_path / "f.png"), want)


def no_writer_files() -> dict:
    """Genuine files of the formats PIL opens and has no writer of, a 6 x 9
    grey ramp each (PCD its one size), by PIL's name."""
    def rec(a, b, data):
        return bytes([0x1C, a, b]) + struct.pack(">H", len(data)) + data
    cards = ["SIMPLE  =                    T", "BITPIX  =                    8", "NAXIS   =                    2",
             f"NAXIS1  = {W:20d}", f"NAXIS2  = {H:20d}", "END"]
    fits = "".join(c.ljust(80) for c in cards).encode()
    chunk = struct.pack("<IH", 6 + W * H, 16) + GREY.tobytes()
    frame = struct.pack("<IHH8x", 16 + len(chunk), 0xF1FA, 1) + chunk
    rgb = np.repeat(GREY[..., None], 3, 2).tobytes()
    mcidas = [0] * 64
    mcidas[1], mcidas[8], mcidas[9], mcidas[10], mcidas[13], mcidas[33] = 4, H, W, 1, 1, 256
    pixar = bytearray(b"\x80\xe8\x00\x00" + bytes(1020))
    struct.pack_into("<HHHH", pixar, 416, H, W, 0, 0)
    struct.pack_into("<HH", pixar, 424, 14, 2)
    return {
        "FITS": fits + b" " * (-len(fits) % 2880) + GREY[::-1].tobytes() + bytes(2880 - H * W),
        "FLI": struct.pack("<IHHHHHHI", 128 + len(frame), 0xAF12, 1, W, H, 8, 3, 5) + bytes(108) + frame,
        "FTEX": b"FTEX" + struct.pack("<iiiiiiii", 1, W, H, 1, 1, 1, 32, len(rgb)) + rgb,
        "GBR": struct.pack(">IIIII", 25, 1, W, H, 1) + b"ramp\0" + GREY.tobytes(),
        "IMT": f"width {W}\nheight {H}\npixel n8\n".encode() + b"\x0c" + GREY.tobytes(),
        "IPTC": (rec(3, 60, bytes([1, 0])) + rec(3, 20, struct.pack(">I", W)) + rec(3, 30, struct.pack(">I", H))
                 + rec(3, 120, struct.pack(">I", 1)) + rec(8, 10, GREY.tobytes())),
        "MCIDAS": struct.pack(">64i", *mcidas) + GREY.tobytes(),
        "PCD": bytes(2048) + b"PCD_" + bytes(96 * 2048 - 2052) + bytes(768 * 512 * 3 // 2),
        "PIXAR": bytes(pixar) + rgb,
        "XVThumb": b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n" + f"{W} {H} 255\n".encode()
                   + GREY.tobytes(),
    }


@pytest.mark.parametrize("fmt", sorted(set(no_writer_files()) - {"XVThumb"}))
def test_formats_pil_reads_and_writes_not_raise_naming_them(tmp_path, fmt):
    """FITS, FLI, FTEX, GBR, IMT, IPTC, McIdas, PCD and PIXAR: PIL opens
    and reads each; the port reads FTEX (A.6.53) bit-equal and raises
    naming each other format."""
    data = no_writer_files()[fmt]
    got, grey = pil_format(data)
    assert got.upper() == fmt.upper() and grey is not None
    holds(tmp_path, data, fmt)


def test_xv_thumbnail_pil_opens_whatever_its_name_reads_as_pil(tmp_path):
    """The hand-written XV thumbnail (A.6.46), which PIL opens as XVThumb
    under a .png name: the port reads it bit-equal."""
    data = no_writer_files()["XVThumb"]
    got, grey = pil_format(data)
    assert got == "XVThumb" and grey is not None
    holds(tmp_path, data, got)


STUBS = {
    "BUFR": b"BUFR" + bytes(40),
    "GRIB": b"GRIB\0\0\0\x01" + bytes(40),
    "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(40),
    "WMF": (b"\xd7\xcd\xc6\x9a\0\0" + struct.pack("<hhhhH", 0, 0, 90, 60, 1440) + bytes(6)
            + b"\x01\0\t\0" + bytes(40)),
    "MPEG": b"\0\0\1\xb3" + bytes([0x00, 0x90, 0x06]) + bytes(40),
}


@pytest.mark.parametrize("fmt", sorted(STUBS))
def test_formats_whose_pixels_pil_refuses_are_corrupt(tmp_path, fmt):
    """BUFR, GRIB, HDF5 and WMF (stubs with no loader registered) and MPEG
    (no tile): PIL opens them and refuses their pixels, so the JAX package
    gives a zero image, and so does the port (ValueError naming the
    format)."""
    got, grey = pil_format(STUBS[fmt])
    assert got == fmt and grey is None
    path = tmp_path / "f.png"
    path.write_bytes(STUBS[fmt])
    assert not jdataset.decode_image(path, 16).any()
    with pytest.raises(ValueError, match=fmt):
        tdataset.decode_gray(path)
    np.testing.assert_array_equal(tdataset.decode_image(path, 16), jdataset.decode_image(path, 16))


def test_random_bytes_pil_identifies_as_nothing_are_corrupt(tmp_path):
    """1500 seeded byte strings of 18 to 4000 bytes: PIL identifies none,
    and the port calls each corrupt."""
    rs = np.random.RandomState(0)
    path = tmp_path / "f.png"
    for i in range(1500):
        data = rs.randint(0, 256, rs.randint(18, 4001)).astype(np.uint8).tobytes()
        assert pil_format(data) == (None, None)
        path.write_bytes(data)
        with pytest.raises(ValueError, match="not a recognised image file"):
            tdataset.decode_gray(path)


def test_build_stops_naming_a_misnamed_format(tmp_path, monkeypatch):
    """An AVIF saved as .png beside scans: the JAX package reads it; the
    port's SignatureDataset and cli.preprocess stop, naming AVIF and A.6; a
    PGM and an ICO (A.6.37, this test's unread format before) under the
    same name read."""
    from siggan_tpu_torch.cli import preprocess as tcli
    raw = tmp_path / "raw" / "w0"
    raw.mkdir(parents=True)
    Image.fromarray(pixels(np.random.RandomState(1), (30, 40)).astype(np.uint8)).save(raw / "w0_0.png")
    (raw / "w0_1.png").write_bytes(chip_smoke.c21_files()["AVIF"])
    assert jdataset.SignatureDataset(raw, 16, use_cache=False).images[1].any()
    with pytest.raises(NotImplementedError, match="AVIF.*ROADMAP A.6"):
        tdataset.SignatureDataset(raw, 16, use_cache=False)
    with pytest.raises(NotImplementedError, match="AVIF.*ROADMAP A.6"):
        tcli.main(["--input_dir", str(tmp_path / "raw"), "--output_dir", str(tmp_path / "t"),
                   "--device", "cpu"])
    (raw / "w0_1.png").write_bytes(chip_smoke.pnm_file("P5", GREY))
    assert len(tdataset.SignatureDataset(raw, 16, use_cache=False)) == 2
    (raw / "w0_1.png").write_bytes(chip_smoke.c21_files()["ICO"])
    from siggan_tpu.data.native import loader as jnative
    monkeypatch.setattr(jnative, "available", lambda: False)   # the JAX package's PIL path
    np.testing.assert_array_equal(tdataset.SignatureDataset(raw, 16, use_cache=False).images,
                                  jdataset.SignatureDataset(raw, 16, use_cache=False).images)
