"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA card (the
kernels have no CPU mode). The file imports neither JAX nor ``siggan_tpu``,
so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerance: rtol 1e-4 / atol 1e-5 in f32; the kernels and the plain versions
sum the same products in a different order. B3 and B4 at full width (base
256, up to 1024 products a sum, 3xTF32) are held at the serving bar, rtol
1e-4 / atol 1e-4. The train-tail kernel (B2) is
held, against its plain version and against the module path it replaces
in the discriminator step, at rtol 1e-4 / atol 1e-4 in f32 (image) and
rtol 1e-4 / atol 1e-5 (batch statistics), and in bf16 at atol 2e-2 (image)
and rtol 1e-2 / atol 1e-3 (batch statistics): its prologue rounds
affine + ReLU to bf16 once where the other two round after each op.
"""

import copy

import numpy as np
import pytest
import torch

from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.infer.generate import GeneratorSession
from siggan_tpu_torch.models.generator import init_fn
from siggan_tpu_torch.ops.conv import conv2d_oihw, conv_transpose2d_iohw, linear_oi
from siggan_tpu_torch.ops.kernels import generator_fwd as gf
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.ops.kernels import train_tail as tt
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


def calibrated_model(dev, base, seed=0):
    """A random 64 px generator at ``base`` width whose eval BN statistics
    are its own batch statistics with a jitter and whose final conv is
    scaled so that the images span [-1, 1] (a trained model's scale)."""
    model = init_fn(rng.generator(seed, rng.STREAM_INIT_G),
                    ModelConfig(base_features=base), dev).eval()
    g = torch.Generator().manual_seed(seed + 1)

    def set_stats(bn, h):
        flat = h.reshape(-1, h.shape[-1])
        jit = lambda: (0.8 + 0.4 * torch.rand(flat.shape[1], generator=g)).to(dev)  # noqa: E731
        bn.mean.copy_(flat.mean(0) * jit())
        bn.var.copy_(flat.var(0) * jit())

    with torch.no_grad():
        z = torch.randn(32, model.cfg.latent_dim, generator=g).to(dev)
        h = linear_oi(z, model.fc.weight, model.fc.bias)
        set_stats(model.fc_bn, h)
        h = torch.relu(model.fc_bn(h)).reshape(32, 4, 4, -1)
        for blk in model.blocks:
            h = conv_transpose2d_iohw(h, blk.weight, stride=2, padding=1)
            set_stats(blk.bn, h)
            h = torch.relu(blk.bn(h))
        pre = conv2d_oihw(h, model.final.weight, model.final.bias, padding=1)
        model.final.weight.mul_(1.5 / float(pre.std()))
    return model


# The serving bar of B3 and B4 at full width (chip_smoke.py): 3xTF32
# products summed in f32 over up to 1024 terms, in another order than the
# plain version's matmuls.
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
# The four blocks of the full-width generator (base 256): input side, Cin, Cout.
FULL_WIDTH_BLOCKS = [(4, 256, 128), (8, 128, 64), (16, 64, 32), (32, 32, 32)]


@pytest.mark.parametrize("block", range(4))
@pytest.mark.parametrize("n", [1, 10, 63, 64])
def test_upsample_block_kernel_full_width(dev, block, n):
    """B3 at the full-width block shapes, whole and ragged batches (tiles
    that span images, and a last tile past the batch), against the plain
    version; two launches give the same bits."""
    side, cin, cout = FULL_WIDTH_BLOCKS[block]
    rs = np.random.RandomState(block * 100 + n)
    x = torch.from_numpy(np.maximum(rs.randn(n, side, side, cin), 0).astype(np.float32)).to(dev)
    taps = torch.from_numpy((rs.randn(4, 2, 2, cin, cout) / np.sqrt(4 * cin))
                            .astype(np.float32)).to(dev)
    scale = torch.from_numpy(rs.rand(cout).astype(np.float32) + 0.5).to(dev)
    offset = torch.from_numpy(rs.randn(cout).astype(np.float32) * 0.1).to(dev)
    before = up.LAUNCHES.count
    got = up.upsample_block_taps(x, taps, scale, offset, mma=up.mma_taps(taps))
    again = up.upsample_block_taps(x, taps, scale, offset)
    assert up.LAUNCHES.count == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, up.convt_phase_reference(x, taps, scale, offset),
                               **SERVE_TOL)


@pytest.mark.parametrize("shape,cout", [
    ((3, 4, 4, 100), 36),   # a cluster of 4 over 13 uneven chunks; Cin % 8, Cout % 32 != 0
    ((9, 4, 4, 260), 8),    # a cluster of 4 over 33 chunks
    ((2, 50, 3, 6), 8),     # an image's rows over two tiles; Cin % 4 != 0
    ((1, 3, 130, 8), 12),   # columns over three tiles
    ((70, 1, 1, 16), 4),    # 1 x 1 maps, 42 images a tile
])
def test_upsample_block_kernel_tile_geometry(dev, shape, cout):
    """B3's tile shapes, cluster splits and zero padding at the edges of
    its contract, against the plain version; two launches give the same
    bits."""
    rs = np.random.RandomState(sum(shape) + cout)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)
    taps = torch.from_numpy((rs.randn(4, 2, 2, shape[-1], cout) / np.sqrt(4 * shape[-1]))
                            .astype(np.float32)).to(dev)
    scale = torch.from_numpy(rs.rand(cout).astype(np.float32) + 0.5).to(dev)
    offset = torch.from_numpy(rs.randn(cout).astype(np.float32) * 0.1).to(dev)
    got = up.upsample_block_taps(x, taps, scale, offset)
    assert torch.equal(got, up.upsample_block_taps(x, taps, scale, offset))
    torch.testing.assert_close(got, up.convt_phase_reference(x, taps, scale, offset),
                               **SERVE_TOL)


@pytest.mark.parametrize("base", [32, 256])
@pytest.mark.parametrize("n", [1, 10, 64])
def test_generator_forward_kernel_widths(dev, base, n):
    """B4 (blocks 1-3 in B3's kernel, block 4 fused with the final conv)
    at the test width and the full width, against the plain version; two
    launches give the same bits."""
    packed = gf.pack_generator(calibrated_model(dev, base, seed=base))
    zdim = packed["wfc16"].shape[1]
    z = torch.randn(n, zdim, generator=torch.Generator().manual_seed(n)).to(dev)
    got = gf.generator_forward(packed, z)
    assert torch.equal(got, gf.generator_forward(packed, z))
    ref = gf.generator_forward_reference(packed, z)
    assert float(ref.std()) > 0.1
    torch.testing.assert_close(got, ref, **SERVE_TOL)


def test_generator_forward_follows_a_replaced_weight(dev):
    """The kernel reads the weights the packed dict holds at the call: a
    replaced final conv (weights and bias negated, so the image is too)
    changes the image as it changes the plain version's."""
    packed = gf.pack_generator(calibrated_model(dev, 32))
    z = torch.randn(10, packed["wfc16"].shape[1],
                    generator=torch.Generator().manual_seed(1)).to(dev)
    before = gf.generator_forward(packed, z)
    packed["wfin"], packed["bfin"] = -packed["wfin"], -packed["bfin"]
    got = gf.generator_forward(packed, z)
    torch.testing.assert_close(got, gf.generator_forward_reference(packed, z), **SERVE_TOL)
    torch.testing.assert_close(got, -before, **SERVE_TOL)


def test_generator_forward_is_one_host_call_without_block4_in_memory(dev):
    """One ctypes call per forward; the profiler sees the fc kernel, B3's
    tile kernel three times (blocks 1-3) and the fused kernel once: block
    4's output is never written to device memory by a B3 launch."""
    from torch.profiler import ProfilerActivity, profile
    packed = gf.pack_generator(calibrated_model(dev, 256))
    z = torch.randn(64, 100, generator=torch.Generator().manual_seed(0)).to(dev)
    gf.generator_forward(packed, z)
    torch.cuda.synchronize()
    f0, u0 = gf.LAUNCHES.count, up.LAUNCHES.count
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gf.generator_forward(packed, z)
        torch.cuda.synchronize()
    assert gf.LAUNCHES.count == f0 + 1 and up.LAUNCHES.count == u0 + 3
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    kernels = [n for n in names if "fc_relu_kernel" in n or "convt_tile_kernel" in n
               or "gen_tail_kernel" in n]
    assert sum("convt_tile_kernel" in n for n in kernels) == 3
    assert sum("gen_tail_kernel" in n for n in kernels) == 1
    assert sum("fc_relu_kernel" in n for n in kernels) == 1


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


def train_tail_case(dev, size, dtype, batch=64, seed=0, base=256):
    """The tail of the ``size`` px generator (full width at base 256): B1's
    packed weights in ``dtype``, random BN affines and running statistics,
    and a ReLU'd random h0 at the tail entry."""
    cfg = ModelConfig(image_size=size, base_features=base)
    g = init_fn(rng.generator(seed, rng.STREAM_INIT_G), cfg, dev)
    gen = torch.Generator().manual_seed(seed)
    tail = g.blocks[g.tail_entry():]
    with torch.no_grad():
        for blk in tail:
            c = blk.bn.mean.shape[0]
            blk.bn.offset.copy_(torch.randn(c, generator=gen) * 0.1)
            blk.bn.mean.copy_(torch.randn(c, generator=gen) * 0.1)
            blk.bn.var.copy_(torch.rand(c, generator=gen) + 0.5)
        g.final.bias.fill_(0.05)
        ws = pt.pack_tail([b.weight for b in tail] + [g.final.weight], dtype)
    ci = tail[0].weight.shape[0]
    side = size // 2 ** len(tail)
    h0 = torch.relu(torch.randn(batch, side, side, ci, generator=gen)).to(dev, dtype)
    return (h0, ws, [(b.bn.scale.detach(), b.bn.offset.detach()) for b in tail],
            [{"mean": b.bn.mean, "var": b.bn.var} for b in tail], g.final.bias.detach())


def clone_states(states):
    return [{k: v.clone() for k, v in s.items()} for s in states]


def batch_stats(new, old):
    """The batch statistics a running update took in: (new - 0.9 old) / 0.1.
    Compared instead of the running values, of which only a tenth is the
    batch's."""
    return [{k: (n[k] - 0.9 * o[k]) / 0.1 for k in ("mean", "var")}
            for n, o in zip(new, old)]


def tail_tols(dtype):
    """(image, batch statistics) tolerances of B2. bf16: the kernel's
    prologue rounds affine + ReLU to bf16 once where the plain version (and
    the module path) round after each op, and a flipped bf16 ulp propagates
    through the tail."""
    if dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-5)
    return dict(rtol=0, atol=2e-2), dict(rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_tail_kernel(dev, size, dtype):
    h0, ws, bn, states, bias = train_tail_case(dev, size, dtype)
    before = tt.LAUNCHES.count
    new, new2 = clone_states(states), clone_states(states)
    with torch.no_grad():
        img = tt.tail_forward_train(h0, ws, bn, new, bias, dtype)
        again = tt.tail_forward_train(h0, ws, bn, new2, bias, dtype)
        ref, ref_new = tt.tail_forward_train_reference(h0, ws, bn, states, bias, dtype)
    assert tt.LAUNCHES.count == before + 2
    assert img.shape == (64, size // 2, size // 2, 4) and img.dtype == dtype
    # Two launches on the same inputs give the same bits: no atomics.
    assert torch.equal(img, again)
    for a, b in zip(new, new2):
        assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"], b["var"])
    img_tol, st_tol = tail_tols(dtype)
    torch.testing.assert_close(img.float(), ref.float(), **img_tol)
    for a, b in zip(batch_stats(new, states), batch_stats(ref_new, states)):
        torch.testing.assert_close(a["mean"], b["mean"], **st_tol)
        torch.testing.assert_close(a["var"], b["var"], **st_tol)


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("base", [32, 256])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_tail_kernel_shapes(dev, size, base, batch, dtype):
    """B2 where the tiles meet ragged pixel counts (batch 1 and 3: fewer
    than 128 pixels, or not a multiple) and narrow channels (base 32: 16
    packed channels, phases of 4, chunks that straddle them), against the
    plain version, with two launches giving the same bits."""
    h0, ws, bn, states, bias = train_tail_case(dev, size, dtype, batch=batch, base=base)
    new, new2 = clone_states(states), clone_states(states)
    with torch.no_grad():
        img = tt.tail_forward_train(h0, ws, bn, new, bias, dtype)
        again = tt.tail_forward_train(h0, ws, bn, new2, bias, dtype)
        ref, ref_new = tt.tail_forward_train_reference(h0, ws, bn, states, bias, dtype)
    assert img.shape == ref.shape and img.dtype == dtype
    assert torch.equal(img, again)
    for a, b in zip(new, new2):
        assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"], b["var"])
    img_tol, st_tol = tail_tols(dtype)
    torch.testing.assert_close(img.float(), ref.float(), **img_tol)
    for a, b in zip(batch_stats(new, states), batch_stats(ref_new, states)):
        torch.testing.assert_close(a["mean"], b["mean"], **st_tol)
        torch.testing.assert_close(a["var"], b["var"], **st_tol)


def test_pack_tail_kernel_takes_new_shapes_dtypes_and_weights(dev):
    """B1 bit-equal to its plain version call after call while the shapes,
    the dtype and the weight tensors change, and after the weights are
    updated in place: no descriptor or pointer of an earlier call survives."""
    for seed, (base, dtype) in enumerate([(32, torch.bfloat16), (256, torch.bfloat16),
                                          (256, torch.float32), (32, torch.float32),
                                          (32, torch.bfloat16), (256, torch.bfloat16)]):
        ws = tail_weights(dev, base, seed)
        for _ in range(2):
            got = pt.pack_tail_launch(ws, dtype)
            for a, b in zip(got, pt.pack_tail_reference(ws, dtype)):
                assert a.dtype == dtype and torch.equal(a, b)
            with torch.no_grad():
                for w in ws:
                    w.mul_(-1.5).add_(0.25)


def test_train_tail_updates_states_in_place(dev):
    h0, ws, bn, states, bias = train_tail_case(dev, 64, torch.float32, batch=8)
    old = clone_states(states)
    ptrs = [s["mean"].data_ptr() for s in states]
    with torch.no_grad():
        tt.tail_forward_train(h0, ws, bn, states, bias, torch.float32)
        _, ref_new = tt.tail_forward_train_reference(h0, ws, bn, old, bias, torch.float32)
    assert [s["mean"].data_ptr() for s in states] == ptrs
    for a, b in zip(states, ref_new):
        torch.testing.assert_close(a["mean"], b["mean"], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(a["var"], b["var"], rtol=1e-4, atol=1e-5)
    with torch.no_grad(), pytest.raises(ValueError, match="tail weight"):
        tt.tail_forward_train(h0, ws[1:], bn, states, bias, torch.float32)


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_tail_route_matches_module_route(dev, size, dtype):
    """The discriminator step's generator forward at full width: the tail in
    B2 (``fused_tail=True``) against the module path it replaces, on two
    copies of one state. B2's bars hold between the two routes: the packed
    fakes, and the batch statistics every tail BN took in."""
    fused = init_fn(rng.generator(0, rng.STREAM_INIT_G), ModelConfig(image_size=size), dev)
    module = copy.deepcopy(fused)
    entry = fused.tail_entry()
    old = [{"mean": b.bn.mean.clone(), "var": b.bn.var.clone()} for b in fused.blocks[entry:]]
    z = torch.randn(64, fused.cfg.latent_dim, generator=torch.Generator().manual_seed(1))
    z = z.to(dev)
    before = tt.LAUNCHES.count
    with torch.no_grad():
        a = fused(z, None, dtype, train=True, packed_output=True, fused_tail=True)
        b = module(z, None, dtype, train=True, packed_output=True)
    assert tt.LAUNCHES.count == before + 1
    assert a.shape == b.shape == (64, size // 2, size // 2, 4) and a.dtype == b.dtype == dtype
    img_tol, st_tol = tail_tols(dtype)
    torch.testing.assert_close(a.float(), b.float(), **img_tol)
    new = lambda g: [{"mean": x.bn.mean, "var": x.bn.var} for x in g.blocks[entry:]]  # noqa: E731
    for x, y in zip(batch_stats(new(fused), old), batch_stats(new(module), old)):
        torch.testing.assert_close(x["mean"], y["mean"], **st_tol)
        torch.testing.assert_close(x["var"], y["var"], **st_tol)


def packed_cotangents(ws, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(pt.packed_shape(k, *pt.dims(w, k)), generator=g).to(w.device, dtype)
            for w, k in zip(ws, pt.kinds(len(ws)))]


@pytest.mark.parametrize("channels", [
    [(128, 64), (64, 32), (32, 32), (1, 32)],     # the full-width tail
    [(13, 10), (10, 7), (7, 5), (3, 5)],          # ragged: element copies, partial tiles
    [(16, 8), (8, 4), (1, 4)],                    # base 32 at 64 px, one interior
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_tail_backward_kernel(dev, channels, dtype):
    """B1' against its plain version (f32 sums in another order: rtol 1e-5,
    atol 1e-6) wherever its tiles meet ragged channel counts and runs that
    are not 16-byte aligned; two launches give the same bits."""
    g = torch.Generator().manual_seed(len(channels))
    ws = [torch.randn(ci, co, 4, 4, generator=g).to(dev) for ci, co in channels[:-1]]
    ws.append(torch.randn(channels[-1][0], channels[-1][1], 3, 3, generator=g).to(dev))
    cts = packed_cotangents(ws, dtype, seed=3)
    before = pt.BWD_LAUNCHES.count
    got = pt.pack_tail_backward_launch(ws, cts)
    again = pt.pack_tail_backward_launch(ws, cts)
    assert pt.BWD_LAUNCHES.count == before + 2
    for a, b, r, w in zip(got, again, pt.pack_tail_backward_reference(ws, cts), ws):
        assert a.shape == w.shape and a.dtype == torch.float32 and a.is_contiguous()
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)


# -- the graphed K-step dispatch ---------------------------------------------

def train_cfg(tmp_path=None, **kw):
    from siggan_tpu_torch.core.config import TrainConfig
    dirs = {} if tmp_path is None else dict(
        checkpoint_dir=str(tmp_path / "c"), sample_dir=str(tmp_path / "s"),
        log_dir=str(tmp_path / "l"))
    return TrainConfig(model=ModelConfig(latent_dim=16, base_features=32), batch_size=8,
                       seed=4, sample_interval=0, checkpoint_interval=1, **dirs, **kw)


@pytest.fixture
def deterministic(dev):
    """cuDNN's deterministic algorithms, so that two eager runs give the same
    bits and graphed steps can be held to them."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield dev
    torch.backends.cudnn.deterministic = before


def state_equal(a, b):
    from siggan_tpu_torch.train.train_step import state_tensors
    return a.step == b.step and all(torch.equal(x, y) for x, y in
                                    zip(state_tensors(a), state_tensors(b)))


def test_graphed_steps_equal_eager_steps(deterministic):
    """Two windows of 4 graphed steps (the first holds the 2 eager warm-up
    steps and the capture), across an epoch change, against 8 eager steps
    on a copy of the state: the same bits, metrics and launch counts (B1
    twice, B1' once and B2 once per step)."""
    from siggan_tpu_torch.core.state import create_train_state
    from siggan_tpu_torch.data.synthetic import generate_dataset
    from siggan_tpu_torch.train.train_step import (make_resident_multi_step,
                                                   make_resident_train_step)
    cfg = train_cfg()
    images = torch.from_numpy(generate_dataset(32, 64, seed=2)).to(deterministic)
    multi, spe = make_resident_multi_step(cfg, 32, 4)
    eager, _ = make_resident_train_step(cfg, 32)
    a = create_train_state(cfg, deterministic)
    b = copy.deepcopy(a)
    counters = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES)
    before = [c.count for c in counters]
    got = []
    for _ in range(2):
        a, m = multi(a, images)
        got.append(m)
    torch.cuda.synchronize()
    assert multi.graphed.graph is not None and multi.graphed.capture_s > 0
    assert [c.count - n for c, n in zip(counters, before)] == [16, 8, 8]
    want = []
    for _ in range(8):
        b, m = eager(b, images)
        want.append(m)
    assert state_equal(a, b)
    for k in want[0]:
        assert torch.equal(torch.cat([m[k] for m in got]), torch.stack([m[k] for m in want]))
    # Launch counts after more windows: each replay adds what was captured.
    before = [c.count for c in counters]
    for _ in range(3):
        a, _ = multi(a, images)
    assert [c.count - n for c, n in zip(counters, before)] == [24, 12, 12]


def test_graphed_training_resumes_like_the_uninterrupted_run(deterministic, tmp_path):
    """1 epoch, a checkpoint, a new trainer that resumes it (the graph bound
    to the restored state) and 1 more epoch: the bits of 2 epochs in one run."""
    from siggan_tpu_torch.data.synthetic import generate_dataset
    from siggan_tpu_torch.train.trainer import GANTrainer
    images = generate_dataset(32, 64, seed=3)

    def trainer(name, epochs):
        return GANTrainer(train_cfg(tmp_path / name, epochs=epochs), images, device="cuda")

    whole = trainer("whole", 2)
    whole.train()
    trainer("split", 1).train()
    resumed = trainer("split", 2)
    assert resumed.resume("latest") and resumed.state.step == 4
    resumed.train()
    assert whole.scan_steps == resumed.scan_steps == 4
    assert state_equal(whole.state, resumed.state)
    assert resumed._step_fn.graphed.graph is not None


def v20_cfg(**kw):
    """The v2.0 recipe at a small width: concat labels, the spectral-norm
    projection head, DiffAugment, linear LR decay over 16 steps from step 4,
    and the EMA shadow."""
    from siggan_tpu_torch.core.config import OptimConfig, TrainConfig
    return TrainConfig(
        model=ModelConfig(latent_dim=20, base_features=32, num_classes=4,
                          g_conditioning="concat", use_spectral_norm=True),
        batch_size=8, seed=5, sample_interval=0, checkpoint_interval=1,
        diffaugment="translation,cutout", ema_decay=0.999,
        optim=OptimConfig(d_lr=1e-4, g_lr=2e-4, lr_schedule="linear", lr_total_steps=16,
                          lr_decay_start_frac=0.25), **kw)


def test_graphed_v20_steps_equal_eager_steps_and_decay_the_lr(deterministic):
    """The v2.0 recipe: two windows of 4 graphed steps against 8 eager
    steps on a copy of the state, the same bits (EMA shadow and LR records
    included) and launches (B1 twice, B1' once and B2 once per step, B2 on
    the concat generator's D-step tail); the LR each replay applied is the
    schedule's at its count, so it goes on decaying after the capture."""
    from siggan_tpu_torch.core.state import create_train_state, lr_schedule
    from siggan_tpu_torch.data.synthetic import generate_labeled_dataset
    from siggan_tpu_torch.models.generator import fused_tail_supported
    from siggan_tpu_torch.train.train_step import (make_resident_multi_step,
                                                   make_resident_train_step)
    cfg = v20_cfg()
    assert fused_tail_supported(cfg.model)
    images, labels = generate_labeled_dataset(4, 8, 64, seed=2)
    images = torch.from_numpy(images).to(deterministic)
    labels = torch.from_numpy(labels).long().to(deterministic)
    multi, _ = make_resident_multi_step(cfg, 32, 4)
    eager, _ = make_resident_train_step(cfg, 32)
    a = create_train_state(cfg, deterministic)
    b = copy.deepcopy(a)
    counters = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES)
    before = [c.count for c in counters]
    got, lrs = [], []
    for _ in range(2):
        a, m = multi(a, images, labels)
        got.append(m)
        lrs.append(float(a.g_opt["lr"]))
    torch.cuda.synchronize()
    assert multi.graphed.graph is not None
    assert [c.count - n for c, n in zip(counters, before)] == [16, 8, 8]
    want = []
    for _ in range(8):
        b, m = eager(b, images, labels=labels)
        want.append(m)
    assert state_equal(a, b)
    for k in want[0]:
        assert torch.equal(torch.cat([m[k] for m in got]), torch.stack([m[k] for m in want]))
    # Steps 3 and 7 (counts before the update) are on the decay: 2e-4 * (1 -
    # (c - 4) / 12) for c >= 4, the capture having been at step 2.
    sched = lr_schedule(cfg, cfg.optim.g_lr)
    for lr, c in zip(lrs, (3, 7)):
        assert lr == float(sched(torch.tensor(c, dtype=torch.int32, device=deterministic)))
    assert lrs[0] == pytest.approx(2e-4) and lrs[1] == pytest.approx(2e-4 * (1 - 3 / 12))
    a, _ = multi(a, images, labels)
    assert float(a.g_opt["lr"]) == pytest.approx(2e-4 * (1 - 7 / 12), rel=1e-6)


def test_graphed_v20_training_resumes_like_the_uninterrupted_run(deterministic, tmp_path):
    """The v2.0 recipe through the trainer: 1 epoch, a checkpoint, a resumed
    trainer and 1 more epoch give the bits of 2 epochs in one run, shadow
    and schedule included."""
    from siggan_tpu_torch.data.synthetic import generate_labeled_dataset
    from siggan_tpu_torch.train.trainer import GANTrainer
    images, labels = generate_labeled_dataset(4, 8, 64, seed=3)

    def trainer(name, epochs):
        cfg = v20_cfg(epochs=epochs, checkpoint_dir=str(tmp_path / name / "c"),
                      sample_dir=str(tmp_path / name / "s"), log_dir=str(tmp_path / name / "l"))
        return GANTrainer(cfg, images, device="cuda", labels=labels)

    whole = trainer("whole", 2)
    whole.train()
    trainer("split", 1).train()
    resumed = trainer("split", 2)
    assert resumed.resume("latest") and resumed.state.step == 4
    resumed.train()
    assert state_equal(whole.state, resumed.state)


# -- the evaluation path -----------------------------------------------------

@pytest.fixture
def tf32_on(dev):
    """TF32 allowed globally (PyTorch's cuDNN default), so that the eval
    code has to turn it off itself."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield dev
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def test_inception_and_lpips_on_the_card_match_the_cpu(tf32_on):
    """Random-init Inception features and LPIPS distances of 64 px images on
    the card against the CPU module on the same weights, at the f32 bar
    (features rtol 1e-4 / atol 1e-5, distances rtol 1e-4 / atol 1e-6; TF32
    would miss it), with TF32 on outside the eval code and restored after
    it."""
    from siggan_tpu_torch.eval import lpips
    from siggan_tpu_torch.eval.common import batched_apply
    from siggan_tpu_torch.eval.fid import FIDScorer
    x = np.tanh(np.random.RandomState(0).randn(6, 64, 64, 1) * 2).astype(np.float32)
    cpu, card = FIDScorer(batch_size=4, device="cpu"), FIDScorer(batch_size=4, device="cuda")
    np.testing.assert_allclose(card.features(x), cpu.features(x), rtol=RTOL, atol=ATOL)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    rgb = np.repeat(x, 3, axis=-1)
    dists = {}
    for where in ("cpu", "cuda"):
        m = lpips.init_lpips(0).to(where)
        dists[where] = batched_apply(lambda a, b: lpips.distance(m, a, b), rgb[:3], rgb[3:],
                                     batch_size=2, device=torch.device(where))
        dists[where + " diversity"] = lpips.diversity(m, x)
    np.testing.assert_allclose(dists["cuda"], dists["cpu"], rtol=RTOL, atol=1e-6)
    assert dists["cuda diversity"] == pytest.approx(dists["cpu diversity"], rel=RTOL)


def test_cli_evaluate_on_the_card_samples_through_b4(dev, tmp_path):
    """``cli.evaluate`` (device cuda by default) on a ``use_pallas``
    checkpoint: every sampled batch launches B4, the report has no error."""
    import json
    from siggan_tpu_torch.ckpt.manager import save_generator
    from siggan_tpu_torch.cli import evaluate
    from siggan_tpu_torch.core.config import TrainConfig
    from siggan_tpu_torch.data.synthetic import save_dataset_pngs
    data = save_dataset_pngs(16, tmp_path / "data", seed=1)
    model = small_model(dev)
    ckpt = save_generator(tmp_path / "ckpt", model, TrainConfig(
        model=model.cfg, use_pallas=True, compute_dtype="float32"))
    before = gf.LAUNCHES.count
    assert evaluate.main(["--checkpoint", str(ckpt), "--data_dir", str(data),
                          "--n_samples", "16", "--batch_size", "8", "--seeds", "0", "1",
                          "--lpips_subset", "8", "--output_dir", str(tmp_path / "out")]) == 0
    assert gf.LAUNCHES.count - before == 2 * 2
    m = json.loads((tmp_path / "out" / "evaluation_report.json").read_text())["metrics"]
    assert m["errors"] == {} and np.isfinite(m["fid"]) and m["fid"] > 0
    assert 0.0 <= m["precision"] <= 1.0 and np.isfinite(m["lpips_diversity"])


def test_fid_epoch_leaves_the_graphed_windows_bit_equal(deterministic, tmp_path):
    """Two epochs on the graphed dispatch with the in-training FID after
    each (fakes, Inception and the host math between the windows) give the
    bits of the same run without FID, and the FID picks ``best``."""
    from siggan_tpu_torch.data.synthetic import generate_dataset
    from siggan_tpu_torch.train.trainer import GANTrainer
    images = generate_dataset(32, 64, seed=3)
    runs = {}
    for fid in (0, 1):
        t = GANTrainer(train_cfg(tmp_path / str(fid), epochs=2, fid_interval=fid,
                                 fid_samples=16), images, device="cuda")
        t.train()
        assert t._step_fn.graphed.graph is not None
        runs[fid] = t
    assert state_equal(runs[0].state, runs[1].state)
    fids = [m["fid"] for m in runs[1].logger.metrics]
    assert len(fids) == 2 and all(np.isfinite(fids))
    idx = runs[1].ckpt.available()
    assert idx["best_fid"] == min(fids) and idx["best"] == int(np.argmin(fids))


# -- the verification path -------------------------------------------------------

def _scans(n, canvas, seed):
    rs = np.random.RandomState(seed)
    c = np.full((n, canvas, canvas), 255.0, np.float32)
    hw = np.zeros((n, 2), np.int32)
    for i in range(n):
        h, w = rs.randint(canvas // 2, canvas + 1, 2)
        hw[i] = h, w
        page = rs.randint(200, 256, (h, w)).astype(np.float32)
        for _ in range(rs.randint(8, 16) * (canvas // 128) ** 2 if i % 5 else 0):
            y, x = rs.randint(0, h), rs.randint(0, w)
            page[max(0, y - 2):y + 3, max(0, x - 15):x + 15] = rs.randint(0, 90)
        c[i, :h, :w] = page
    return torch.from_numpy(c), torch.from_numpy(hw)


@pytest.mark.parametrize("flags", [{}, {"binarize": True}, {"remove_margin": False}])
def test_preprocessing_on_the_card_matches_the_cpu(dev, flags):
    """The batched preprocessing on the card against the CPU on 512 px
    canvases: the valid flags and the CLAHE images equal (atol 1e-5; the
    float64 integral image is exact on both, every other op elementwise or
    an exact count), binarized images with at most 0.1 % of the pixels
    flipped (the Gaussian's f32 exp)."""
    from siggan_tpu_torch.data import preprocess as pp
    c, hw = _scans(12, 512, 0)
    cpu_img, cpu_ok = pp.preprocess_batch(c, hw, **flags)
    img, ok = pp.preprocess_batch(c.to(dev), hw.to(dev), **flags)
    assert img.device.type == "cuda"
    assert torch.equal(ok.cpu(), cpu_ok) and 0 < int(cpu_ok.sum()) < 12
    if flags.get("binarize"):
        assert (img.cpu() != cpu_img).float().mean() <= 1e-3
    else:
        torch.testing.assert_close(img.cpu(), cpu_img, rtol=0, atol=1e-5)


def test_verifier_on_the_card_matches_the_cpu(tf32_on):
    """A verifier's scores and its FID features (``verifier:`` backbone,
    64 and 128 px inputs) on the card against the CPU on the same pickle
    (rtol 1e-4 / atol 1e-5; TF32 on outside, the code turns it off), and
    two train steps on the same masks (losses rtol 1e-4)."""
    import tempfile
    from siggan_tpu_torch.eval.common import full_f32
    from siggan_tpu_torch.eval.fid import make_scorer
    from siggan_tpu_torch.verify import models, train
    model = models.init_fn(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    x1, x2 = (np.tanh(rs.randn(40, 64, 64, 1) * 2).astype(np.float32) for _ in range(2))
    with tempfile.TemporaryDirectory() as d:
        pkl = train.save_verifier(train.snapshot(model, 0, 0.5), f"{d}/v.pkl")
        snap = train.load_verifier(pkl)
        scores = {w: train.predict_scores(train.model_from_snapshot(snap, w), x1, x2, 16)
                  for w in ("cpu", "cuda")}
        np.testing.assert_allclose(scores["cuda"], scores["cpu"], rtol=RTOL, atol=ATOL)
        big = np.tanh(rs.randn(6, 128, 128, 1) * 2).astype(np.float32)
        for x in (x1[:10], big):
            feats = {w: make_scorer(f"verifier:{pkl}", 4, device=w).features(x)
                     for w in ("cpu", "cuda")}
            np.testing.assert_allclose(feats["cuda"], feats["cpu"], rtol=RTOL, atol=ATOL)
    assert torch.backends.cudnn.allow_tf32
    losses = {}
    for where in ("cpu", "cuda"):
        st = train.VerifierState(0, models.init_fn(torch.Generator().manual_seed(2),
                                                   device=where),
                                 train.make_optimizer(), None)
        st.opt = st.tx.init(list(st.model.parameters()))
        g = torch.Generator().manual_seed(3)
        out = []
        with full_f32():
            for i in range(2):
                masks = [torch.rand(s, generator=g) < k for s, k in
                         (((8, 512), 0.5), ((8, 512), 0.5), ((8, 64), 0.7))]
                lab = torch.tensor([1.0, 0.0] * 4)
                m = train.train_step(st, *(t.to(where) for t in (
                    torch.from_numpy(x1[i * 8:i * 8 + 8]), torch.from_numpy(x2[i * 8:i * 8 + 8]),
                    lab)), masks=[mk.to(where) for mk in masks])
                out.append([float(m[k]) for k in ("loss", "bce_loss", "contrastive_loss")])
        losses[where] = np.asarray(out)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=1e-6)
