"""The port's ops, config, RNG and export helpers against the JAX package,
plus the port's import hygiene and its device default."""

import io
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.ops import conv as jconv
from siggan_tpu.ops.norm import batch_norm as j_batch_norm
from siggan_tpu.utils import visualizer as jvis
from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.core.platform import device_info, resolve_device
from siggan_tpu_torch.infer import export
from siggan_tpu_torch.ops import conv as tconv
from siggan_tpu_torch.ops.norm import batch_norm, init_state
from siggan_tpu_torch.utils import visualizer as tvis

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_conv2d_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16, 3).astype(np.float32)
    w = rs.randn(4, 4, 3, 8).astype(np.float32) * 0.1
    b = rs.randn(8).astype(np.float32)
    for stride, pad in ((2, 1), (1, 1)):
        ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           stride=stride, padding=pad)
        got = tconv.conv2d(t(x), t(w), t(b), stride=stride, padding=pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_conv_transpose2d_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 4, 4, 6).astype(np.float32)
    w = rs.randn(4, 4, 6, 3).astype(np.float32) * 0.1
    ref = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), stride=2, padding=1)
    got = tconv.conv_transpose2d(t(x), t(w), stride=2, padding=1)
    assert got.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_linear_matches_jax_and_honours_compute_dtype():
    rs = np.random.RandomState(2)
    x, w, b = rs.randn(5, 7), rs.randn(7, 9) * 0.1, rs.randn(9)
    ref = jconv.linear(jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
                       jnp.asarray(b, jnp.float32))
    got = tconv.linear(t(x), t(w), t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert tconv.linear(t(x), t(w), t(b), compute_dtype="bfloat16").dtype == torch.bfloat16


@pytest.mark.parametrize("shape,per_sample", [
    ((4, 5, 5, 8), False), ((6, 8), False), ((4, 5, 5, 8), True)])
def test_eval_batch_norm_matches_jax(shape, per_sample):
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32) * 3 + 1
    c = shape[-1]
    rows = (shape[0], c) if per_sample else (c,)
    scale = rs.rand(*rows).astype(np.float32) + 0.5
    offset = rs.randn(*rows).astype(np.float32)
    state = {"mean": rs.randn(c).astype(np.float32),
             "var": rs.rand(c).astype(np.float32) + 0.1}
    ref, _ = j_batch_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(offset),
                          {k: jnp.asarray(v) for k, v in state.items()}, train=False)
    got, st = batch_norm(t(x), t(scale), t(offset),
                         {k: t(v) for k, v in state.items()}, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert torch.equal(st["var"], t(state["var"]))
    assert torch.equal(init_state(3)["var"], torch.ones(3))


def test_config_sidecar_round_trips_both_ways():
    j = JTrainConfig(batch_size=32, use_pallas=True, compute_dtype="float32")
    port = TrainConfig.from_json(j.to_json())
    assert port.to_json() == j.to_json()
    assert JTrainConfig.from_json(port.to_json()) == j
    extra = json.loads(port.to_json())
    extra["model"]["future_knob"] = 1
    assert TrainConfig.from_dict(extra) == port


def test_rng_streams_are_deterministic_and_independent():
    a = torch.randn(8, generator=rng.generator(42, rng.STREAM_EVAL, 0))
    b = torch.randn(8, generator=rng.generator(42, rng.STREAM_EVAL, 0))
    c = torch.randn(8, generator=rng.generator(42, rng.STREAM_EVAL, 1))
    d = torch.randn(8, generator=rng.generator(42, rng.STREAM_NOISE, 0))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert rng.STREAM_EVAL == 0x4556414C


def test_to_uint8_and_grid_match_jax():
    imgs = np.random.RandomState(4).uniform(-1.2, 1.2, (5, 6, 7, 1)).astype(np.float32)
    np.testing.assert_array_equal(tvis.to_uint8(imgs), jvis.to_uint8(imgs))
    u8 = tvis.to_uint8(imgs)
    np.testing.assert_array_equal(tvis.make_grid(u8, nrow=3), jvis.make_grid(u8, nrow=3))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_encoder_is_standard(channels):
    from PIL import Image
    u8 = np.random.RandomState(5).randint(0, 256, (9, 13, channels)).astype(np.uint8)
    png = export.encode_png(u8)
    back = np.asarray(Image.open(io.BytesIO(png)))
    np.testing.assert_array_equal(back.reshape(u8.shape), u8)
    np.testing.assert_array_equal(export.decode_png(png), u8)
    # decode_png also reads what another encoder wrote (adaptive filters).
    buf = io.BytesIO()
    Image.fromarray(u8[..., 0] if channels == 1 else u8).save(buf, format="PNG")
    np.testing.assert_array_equal(export.decode_png(buf.getvalue()), u8)


def test_zip_and_png_exports(tmp_path):
    imgs = np.random.RandomState(6).uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32)
    with zipfile.ZipFile(io.BytesIO(export.zip_bytes(imgs))) as zf:
        names = zf.namelist()
        assert names == [f"signature_{i:06d}.png" for i in range(3)]
        np.testing.assert_array_equal(export.decode_png(zf.read(names[1])),
                                      tvis.to_uint8(imgs)[1])
    paths = export.save_pngs(imgs, tmp_path, prefix="s", start_index=5)
    assert [p.name for p in paths] == ["s_000005.png", "s_000006.png", "s_000007.png"]
    sheet = export.decode_png(export.contact_sheet(imgs, tmp_path / "g.png", nrow=2)
                              .read_bytes())
    assert sheet.shape == (2 * 10 + 2, 2 * 10 + 2, 1)


def test_port_imports_no_jax_and_nothing_of_siggan_tpu():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "siggan_tpu_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'siggan_tpu' or m.startswith('siggan_tpu.')]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20


def test_chip_smoke_imports_no_jax():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "siggan_tpu." not in src.replace("siggan_tpu_torch", "")


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert device_info("cpu")["platform"] == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
