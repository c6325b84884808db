"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA card (the
kernels have no CPU mode). The file imports neither JAX nor ``siggan_tpu``,
so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerance: rtol 1e-4 / atol 1e-5 in f32; the kernels and the plain versions
sum the same products in a different order.
"""

import numpy as np
import pytest
import torch

from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.infer.generate import GeneratorSession
from siggan_tpu_torch.models.generator import init_fn
from siggan_tpu_torch.ops.kernels import generator_fwd as gf
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.ops.kernels import upsample as up

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def small_model(dev, seed=0):
    model = init_fn(rng.generator(seed, rng.STREAM_INIT_G),
                    ModelConfig(latent_dim=16, base_features=32), dev)
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for bn in [model.fc_bn] + [b.bn for b in model.blocks]:
            bn.mean.copy_(torch.randn(bn.mean.shape, generator=g) * 0.1)
            bn.var.copy_(torch.rand(bn.var.shape, generator=g) + 0.5)
    return model


@pytest.mark.parametrize("shape,cout,relu", [
    ((3, 8, 8, 16), 8, True), ((2, 4, 4, 8), 4, False), ((5, 7, 3, 12), 20, True)])
def test_upsample_block_kernel(dev, shape, cout, relu):
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)
    w = torch.from_numpy(rs.randn(4, 4, shape[-1], cout).astype(np.float32) * 0.1)
    w9 = up.pack_w9(w).to(dev)
    scale = torch.from_numpy(rs.rand(cout).astype(np.float32) + 0.5).to(dev)
    offset = torch.from_numpy(rs.randn(cout).astype(np.float32)).to(dev)
    before = up.LAUNCHES.count
    got = up.upsample_block(x, w9, scale, offset, relu=relu)
    assert up.LAUNCHES.count == before + 1
    ref = up.upsample_block_reference(x, w9, scale, offset, relu=relu)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 10, 64])
def test_generator_forward_kernel(dev, n):
    packed = gf.pack_generator(small_model(dev))
    z = torch.randn(n, 16, generator=torch.Generator().manual_seed(n)).to(dev)
    before = gf.LAUNCHES.count
    got = gf.generator_forward(packed, z)
    assert gf.LAUNCHES.count == before + 1
    torch.testing.assert_close(got, gf.generator_forward_reference(packed, z),
                               rtol=RTOL, atol=ATOL)


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(1, 2, 2, 4, device=dev)
    taps = torch.zeros(4, 2, 2, 4, 4, device=dev)
    with pytest.raises(TypeError, match="float32"):
        up.upsample_block_taps(x.double(), taps, torch.ones(4, device=dev),
                               torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        up.upsample_block_taps(x.transpose(1, 2), taps, torch.ones(4, device=dev),
                               torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="shape"):
        up.upsample_block_taps(x, taps[:, :1].contiguous(), torch.ones(4, device=dev),
                               torch.zeros(4, device=dev))


def test_session_kernel_path_matches_module_path(dev):
    model = small_model(dev, seed=3)
    k = GeneratorSession(model, compute_dtype="float32", use_pallas=True, device=dev)
    m = GeneratorSession(model, compute_dtype="float32", use_pallas=False, device=dev)
    a, b = k.sample(70, seed=1), m.sample(70, seed=1)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(a, k.sample(70, seed=1))
    assert k.interpolate(steps=10).shape == (10, 64, 64, 1)


def tail_weights(dev, base=32, seed=0):
    """Stored-layout tail weights of a 64 px generator at ``base`` width."""
    g = torch.Generator().manual_seed(seed)
    c = [base // 2, base // 4, base // 8, base // 8]
    ws = [torch.randn(ci, co, 4, 4, generator=g) for ci, co in zip(c, c[1:])]
    ws.append(torch.randn(1, c[-1], 3, 3, generator=g))
    return [w.to(dev) for w in ws]


@pytest.mark.parametrize("base", [32, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_tail_kernels(dev, base, dtype):
    ws = [w.requires_grad_(True) for w in tail_weights(dev, base)]
    f0, b0 = pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count
    out = pt.pack_tail(ws, dtype)
    ref = pt.pack_tail_reference([w.detach() for w in ws], dtype)
    assert pt.FWD_LAUNCHES.count == f0 + 1
    for a, b in zip(out, ref):
        assert a.dtype == dtype and torch.equal(a, b)
    g = torch.Generator().manual_seed(1)
    cts = [torch.randn(o.shape, generator=g).to(dev, dtype) for o in out]
    got = torch.autograd.grad(out, ws, cts)
    assert pt.BWD_LAUNCHES.count == b0 + 1
    want = pt.pack_tail_backward_reference(ws, cts)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
