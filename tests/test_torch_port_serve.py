"""The port's generation session, HTTP API and CLIs, on the CPU.

The session's kernel path (``use_pallas``) takes the kernel's plain version
here, since its tensors lie on the CPU; the comparison with the module path
holds the packing and the plain arithmetic together.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from siggan_tpu_torch.ckpt.manager import save_generator
from siggan_tpu_torch.cli import generate as gen_cli
from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.infer.export import decode_png
from siggan_tpu_torch.infer.generate import GeneratorSession, load_session
from siggan_tpu_torch.models.generator import init_fn
from siggan_tpu_torch.serve.api import ApiCore, ApiError, serve
from siggan_tpu_torch.utils.visualizer import to_uint8

SMALL = dict(latent_dim=16, base_features=32)


def small_model(num_classes=0, seed=0):
    cfg = ModelConfig(num_classes=num_classes, **SMALL)
    model = init_fn(rng.generator(seed, rng.STREAM_INIT_G), cfg)
    with torch.no_grad():  # random running stats, so BN folding matters
        g = torch.Generator().manual_seed(seed)
        for bn in [model.fc_bn] + [b.bn for b in model.blocks]:
            bn.mean.copy_(torch.randn(bn.mean.shape, generator=g) * 0.1)
            bn.var.copy_(torch.rand(bn.var.shape, generator=g) + 0.5)
    return model


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    model = small_model()
    save_generator(d, model, TrainConfig(model=model.cfg, compute_dtype="float32",
                                         use_pallas=True))
    return d


def test_kernel_path_agrees_with_module_path():
    model = small_model()
    k = GeneratorSession(model, compute_dtype="float32", use_pallas=True, device="cpu")
    m = GeneratorSession(model, compute_dtype="float32", use_pallas=False, device="cpu")
    assert k.uses_kernel and not m.uses_kernel
    a, b = k.sample(10, seed=3, batch_size=4), m.sample(10, seed=3, batch_size=4)
    assert a.shape == (10, 64, 64, 1) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert a.std() > 0


def test_same_seed_same_images_and_batches_are_prefix_stable(ckpt):
    s = load_session(str(ckpt), device="cpu")
    assert s.uses_kernel
    a = s.sample(6, seed=9, batch_size=4)
    np.testing.assert_array_equal(a, s.sample(6, seed=9, batch_size=4))
    np.testing.assert_array_equal(a[:4], s.sample(4, seed=9, batch_size=4))
    assert not np.array_equal(a, s.sample(6, seed=10, batch_size=4))
    assert s.sample_uint8(2, seed=9, batch_size=4).dtype == np.uint8


def test_interpolate_any_step_count(ckpt):
    s = load_session(str(ckpt), device="cpu")
    frames = s.interpolate(seed=1, steps=10)
    assert frames.shape == (10, 64, 64, 1)
    np.testing.assert_array_equal(frames, s.interpolate(seed=1, steps=10))
    with pytest.raises(ValueError, match="unconditional"):
        s.interpolate(steps=3, class_id=0)


def test_class_id_checks():
    unc = GeneratorSession(small_model(), compute_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="unconditional"):
        unc.sample(2, class_id=0)
    cond = GeneratorSession(small_model(num_classes=3), compute_dtype="float32",
                            use_pallas=True, device="cpu")
    assert not cond.uses_kernel  # the kernel serves unconditional models only
    with pytest.raises(ValueError, match="out of range"):
        cond.sample(2, class_id=3)
    with pytest.raises(ValueError, match="out of range"):
        cond.interpolate(steps=2, class_id=-1)
    assert cond.sample(3, class_id=2, batch_size=2).shape == (3, 64, 64, 1)
    assert cond.interpolate(steps=4, class_id=1).shape == (4, 64, 64, 1)


def test_entry_points_default_to_cuda(ckpt):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        GeneratorSession(small_model())
    with pytest.raises(RuntimeError, match="CUDA"):
        load_session(str(ckpt))
    with pytest.raises(RuntimeError, match="CUDA"):
        ApiCore().load_model(str(ckpt))


def test_api_core_contract(ckpt, tmp_path):
    core = ApiCore(device="cpu")
    assert core.health()["model_loaded"] is False
    with pytest.raises(ApiError) as e:
        core.generate({"n": 1})
    assert e.value.status == 503
    core.load_model(str(tmp_path / "missing"))
    assert "FileNotFoundError" in core.health()["load_error"]
    with pytest.raises(ApiError, match="model not loaded"):
        core.info()

    core.load_model(str(ckpt))
    h = core.health()
    assert h["model_loaded"] and h["platform"] == "cpu" and h["load_error"] is None
    info = core.info()
    assert info["latent_dim"] == 16 and info["image_size"] == 64
    assert info["g_param_count"] > 0 and info["num_classes"] == 0
    for body in ({"n": 0}, {"n": 1001}, {"n": "x"}, {"format": "tar"},
                 {"class_id": 0}, {"class_id": "a"}, {"noise_scale": "nan"},
                 {"seed": -1}):
        with pytest.raises(ApiError) as e:
            core.generate(body)
        assert e.value.status == 422, body

    payload, ctype = core.generate({"n": 3, "seed": 5, "format": "base64"})
    assert ctype == "application/json"
    doc = json.loads(payload)
    assert doc["n"] == 3 and len(doc["images"]) == 3
    want = core.state.session.sample_uint8(3, seed=5)
    for img, w in zip(doc["images"], want):
        np.testing.assert_array_equal(decode_png(base64.b64decode(img)), w)
    payload, ctype = core.generate({"n": 2, "format": "zip"})
    assert ctype == "application/zip"
    with zipfile.ZipFile(io.BytesIO(payload)) as zf:
        assert len(zf.namelist()) == 2
    png, ctype = core.generate_single({"seed": 5})
    assert ctype == "image/png"
    np.testing.assert_array_equal(decode_png(png), want[0])


def _request(url, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def test_http_server_end_to_end(ckpt):
    server = serve("127.0.0.1", 0, str(ckpt), device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, headers, body = _request(base + "/health")
        assert status == 200 and json.loads(body)["model_loaded"] is True
        assert headers["Access-Control-Allow-Origin"] == "*"
        status, _, body = _request(base + "/info")
        assert status == 200 and json.loads(body)["image_size"] == 64
        status, _, body = _request(base + "/generate", {"n": 5, "format": "base64"})
        assert status == 200 and len(json.loads(body)["images"]) == 5
        status, headers, body = _request(base + "/generate", {"n": 4, "format": "zip"})
        assert status == 200 and headers["Content-Type"] == "application/zip"
        with zipfile.ZipFile(io.BytesIO(body)) as zf:
            assert len(zf.namelist()) == 4
        status, headers, body = _request(base + "/generate/single", {"seed": 1})
        assert status == 200 and decode_png(body).shape == (64, 64, 1)
        status, _, body = _request(base + "/generate", {"n": 0})
        assert status == 422 and "detail" in json.loads(body)
        assert _request(base + "/nope")[0] == 404
        assert _request(base + "/generate", method="OPTIONS")[0] == 204
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_generate_cli(ckpt, tmp_path, capsys):
    assert gen_cli.main(["--checkpoint", str(ckpt), "--info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["architecture"] == {"latent_dim": 16, "image_size": 64,
                                    "base_features": 32}
    out = tmp_path / "gen"
    assert gen_cli.main(["--checkpoint", str(ckpt), "--device", "cpu",
                         "--n_samples", "3", "--batch_size", "2",
                         "--output_dir", str(out), "--grid",
                         "--zip", str(tmp_path / "a.zip")]) == 0
    pngs = sorted(p.name for p in out.glob("signature_*.png"))
    assert pngs == [f"signature_{i:06d}.png" for i in range(3)]
    assert (out / "grid.png").exists() and (tmp_path / "a.zip").exists()
    want = to_uint8(load_session(str(ckpt), device="cpu").sample(3, batch_size=2))
    np.testing.assert_array_equal(decode_png((out / "signature_000002.png").read_bytes()),
                                  want[2])
    assert gen_cli.main(["--checkpoint", str(ckpt), "--device", "cpu",
                         "--interpolate", "5", "--output_dir", str(out)]) == 0
    assert decode_png((out / "interpolation.png").read_bytes()).shape[1] == 5 * 66 + 2
