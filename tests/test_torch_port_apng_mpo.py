"""Animated PNG and MPO, which the port reads through its PNG and JPEG
readers, bit-equal with PIL's ``Image.open(path).convert("L")`` (Pillow
12.1.0) and with the JAX package's ``decode_image``: PIL reads an APNG's
default image (the IDAT image, whether or not the animation shows it) and
an MPO's first frame, and so does the port. Files are Pillow's own."""

import io

import numpy as np
import pytest
from PIL import Image
from test_torch_port_decode import assert_port_reads_as_pil
from torch_port_raster_cases import image


def frames(mode: str):
    """Two frames of ``mode`` that differ (P with a palette of its own)."""
    bands = {"L": 0, "RGB": 3, "RGBA": 4, "P": 3}[mode]
    out = [Image.fromarray(image(12, 17, bands, seed=s)) for s in (5, 6)]
    if mode == "P":
        return [im.convert("P", palette=Image.Palette.ADAPTIVE, colors=64) for im in out]
    return out


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("default_image", [False, True])
def test_apng_reads_its_default_image_as_pil(tmp_path, mode, default_image):
    """APNG in L, RGB, RGBA and P, the default image in the animation or
    out of it, under .png and .jpg names."""
    first, second = frames(mode)
    b = io.BytesIO()
    first.save(b, "PNG", save_all=True, append_images=[second], default_image=default_image, duration=40)
    with Image.open(io.BytesIO(b.getvalue())) as im:
        assert im.format == "PNG" and getattr(im, "n_frames", 1) >= 2
    for name in ("f.png", "f.jpg"):
        (tmp_path / name).write_bytes(b.getvalue())
        assert_port_reads_as_pil(tmp_path / name)


@pytest.mark.parametrize("bands", [0, 3])
def test_mpo_reads_its_first_frame_as_pil(tmp_path, bands):
    """A two-frame MPO (grey and RGB): its first frame, a JPEG."""
    first, second = (Image.fromarray(image(16, 24, bands, seed=s)) for s in (5, 6))
    b = io.BytesIO()
    first.save(b, "MPO", save_all=True, append_images=[second])
    with Image.open(io.BytesIO(b.getvalue())) as im:
        assert im.format == "MPO" and im.n_frames == 2
    path = tmp_path / "f.jpg"
    path.write_bytes(b.getvalue())
    assert_port_reads_as_pil(path)
    assert np.asarray(second.convert("L")).any()
