"""Kernel B2's CPU side against the JAX package: the plain version of the
train-mode packed tail against ``tail_forward_train`` (the Pallas kernel in
interpret mode), the generator's discriminator-step route (the fused tail)
against ``generator.apply_fn(train=True, packed_output=True)``, the gate,
and the pack-law zero blocks that the CUDA kernel skips.

Tolerances: f32 throughout; image rtol 1e-4 / atol 1e-4 and running
statistics rtol 1e-4 / atol 1e-5, the bar of ``tests/test_pallas.py`` for
the Pallas kernel against XLA (sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.models import generator as jgen
from siggan_tpu.ops.pallas.train_tail import tail_forward_train as j_tail_forward_train
from siggan_tpu_torch import bridge
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.models.generator import (Generator, channel_schedule,
                                               fused_tail_supported, tail_start)
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.ops.kernels import train_tail as tt

IMG_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def jax_model(size, base, seed):
    """JAX (params, state) with random BN affines and running statistics,
    and the same model as a port generator."""
    jcfg = JModelConfig(image_size=size, base_features=base, latent_dim=16)
    params, state = np_tree(jgen.init_fn(jax.random.key(seed), jcfg))
    rs = np.random.RandomState(seed)
    for p, s in zip([params["fc_bn"]] + [b["bn"] for b in params["blocks"]],
                    [state["fc_bn"]] + state["blocks"]):
        p["offset"] = (rs.randn(*p["offset"].shape) * 0.1).astype(np.float32)
        s["mean"] = (rs.randn(*s["mean"].shape) * 0.1).astype(np.float32)
        s["var"] = (rs.rand(*s["var"].shape) + 0.5).astype(np.float32)
    params["final"]["b"] = np.full((1,), 0.05, np.float32)
    g = bridge.from_jax(params, state, ModelConfig(image_size=size, base_features=base,
                                                   latent_dim=16), "cpu")
    return jcfg, params, state, g


@pytest.mark.parametrize("size,base,batch", [(64, 32, 4), (128, 32, 2)])
def test_plain_version_matches_pallas_tail(size, base, batch):
    jcfg, params, state, g = jax_model(size, base, seed=size)
    start = g.tail_entry()
    rs = np.random.RandomState(1)
    ci = g.blocks[start].weight.shape[0]
    side = 4 * 2 ** start
    h0 = np.maximum(rs.randn(batch, side, side, ci), 0).astype(np.float32)
    img_ref, states_ref = j_tail_forward_train(params, state, jnp.asarray(h0), jcfg,
                                               interpret=True)

    tail = g.blocks[start:]
    ws = pt.pack_tail_reference([b.weight for b in tail] + [g.final.weight], torch.float32)
    bn_params = [(b.bn.scale, b.bn.offset) for b in tail]
    old = [{"mean": b.bn.mean.clone(), "var": b.bn.var.clone()} for b in tail]
    bn_states = [{"mean": b.bn.mean.clone(), "var": b.bn.var.clone()} for b in tail]
    ptrs = [s["mean"].data_ptr() for s in bn_states]
    with torch.no_grad():
        img = tt.tail_forward_train(torch.from_numpy(h0), ws, bn_params, bn_states,
                                    g.final.bias, torch.float32)
        ref_img, ref_new = tt.tail_forward_train_reference(
            torch.from_numpy(h0), ws, bn_params, old, g.final.bias, torch.float32)
    assert img.shape == (batch, size // 2, size // 2, 4) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), **IMG_TOL)
    assert len(bn_states) == len(states_ref)
    for got, want in zip(bn_states, states_ref):
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **STATE_TOL)
    # The wrapper writes the new statistics into the tensors it was given,
    # and they are the plain version's.
    assert [s["mean"].data_ptr() for s in bn_states] == ptrs
    assert torch.equal(img, ref_img)
    for got, want in zip(bn_states, ref_new):
        assert torch.equal(got["mean"], want["mean"]) and torch.equal(got["var"], want["var"])


@pytest.mark.parametrize("size,base", [(64, 32), (128, 32), (64, 192)])
def test_d_step_route_matches_apply_fn(size, base):
    """The fused tail behind the fc, its BN and the wide blocks (at base 192
    the tail starts at block 1, after a wide block, as at full width)."""
    jcfg, params, state, g = jax_model(size, base, seed=7)
    assert g.tail_entry() == (1 if base == 192 else 0)
    z = np.random.RandomState(2).randn(3, 16).astype(np.float32)
    ref, ref_bn = jgen.apply_fn(params, state, jnp.asarray(z), jcfg, train=True,
                                compute_dtype=jnp.float32, packed_output=True)
    launches = tt.LAUNCHES.count
    with torch.no_grad():
        img = g(torch.from_numpy(z), None, torch.float32, train=True,
                packed_output=True, fused_tail=True)
    assert tt.LAUNCHES.count == launches            # CPU tensors: the plain version
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), **IMG_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.to_jax(g)[1]),
                    jax.tree_util.tree_leaves(ref_bn)):
        np.testing.assert_allclose(a, np.asarray(b), **STATE_TOL)


def test_d_step_route_refuses_gradients_and_other_modes():
    g = jax_model(64, 32, seed=3)[3]
    z = torch.zeros(2, 16)
    with pytest.raises(RuntimeError, match="no_grad"):
        g(z, None, torch.float32, train=True, packed_output=True, fused_tail=True)
    with torch.no_grad(), pytest.raises(ValueError, match="train-mode"):
        g(z, None, torch.float32, packed_output=True, fused_tail=True)
    with pytest.raises(RuntimeError, match="no_grad"):
        tt.tail_forward_train(torch.zeros(1, 4, 4, 16), [], [], [], torch.zeros(1),
                              torch.float32)


def test_gate_is_a_gate_on_the_configuration():
    assert fused_tail_supported(TrainConfig().model)
    assert fused_tail_supported(ModelConfig(image_size=128, use_spectral_norm=True))
    assert tail_start(ModelConfig()) == 1
    assert tail_start(ModelConfig(image_size=128)) == 2
    for cfg in (ModelConfig(image_channels=3),
                ModelConfig(g_activation="leaky_relu"),
                ModelConfig(num_classes=4),
                ModelConfig(g_pack_pallas=False),
                ModelConfig(base_features=8)):
        assert not fused_tail_supported(cfg), cfg
    assert fused_tail_supported(ModelConfig(num_classes=4, g_conditioning="concat"))
    # The route refuses a configuration the gate turns away.
    g = Generator(ModelConfig(base_features=8, latent_dim=16))
    with torch.no_grad(), pytest.raises(NotImplementedError, match="fused tail"):
        g(torch.zeros(2, 16), None, torch.float32, train=True, packed_output=True,
          fused_tail=True)


def _block_live(kind, r, c, p, q):
    """The CUDA kernel's ``block_live`` (csrc/train_tail.cu)."""
    qr, qc = q >> 1, q & 1
    if kind == pt.ENTRY:
        u, v = 3 - 2 * r + qr, 3 - 2 * c + qc
    else:
        u, v = 2 * r + qr - 2 * (p >> 1) - 1, 2 * c + qc - 2 * (p & 1) - 1
    return 0 <= u <= 3 and 0 <= v <= 3


def _range_live(kind, r, c, p_lo, p_hi, q_lo, q_hi):
    """The CUDA kernels' ``range_live`` (csrc/train_tail.cu): whether any
    block of input phases p_lo..p_hi and output phases q_lo..q_hi is live."""
    return any(_block_live(kind, r, c, p, q)
               for p in range(p_lo, p_hi + 1) for q in range(q_lo, q_hi + 1))


def _final_live(p, a, b, q):
    """The CUDA kernel's ``final_live`` (csrc/train_tail.cu); p = 4: a chunk
    that spans input phases."""
    if p > 3:
        return True
    u, v = 2 * a - 1 - (q >> 1) + (p >> 1), 2 * b - 1 - (q & 1) + (p & 1)
    return 0 <= u <= 2 and 0 <= v <= 2


# The (input-channel chunk, output-channel range) widths at which the kernels
# skip work: the f32 tile's 16-channel chunk over its 32-channel block, and
# the final conv's 8-channel chunk (over all 4 outputs, with its own rule).
CHUNK_WIDTHS = [(pt.ENTRY, 16, 32), (pt.INTERIOR, 16, 32), (pt.FINAL, 8, 4)]


@pytest.mark.parametrize("kind,kw,nw", [pytest.param(pt.ENTRY, None, None, id="0"),
                                        pytest.param(pt.INTERIOR, None, None, id="1")]
                         + [pytest.param(k, kw, nw, id=f"{k}-k{kw}-n{nw}")
                            for k, kw, nw in CHUNK_WIDTHS])
def test_skipped_weight_blocks_are_the_pack_laws_zeros(kind, kw, nw):
    """Every (kernel index, input phase, output phase) block the CUDA kernel
    skips is zero in B1's packed weight, and every block it keeps is not;
    at each chunk width the kernels use, with canonical widths narrow enough
    that a chunk straddles phases, every chunk they skip is all zeros."""
    if kw is None:
        ci, co = 3, 2
        w = torch.arange(1, ci * co * 16 + 1, dtype=torch.float32).reshape(ci, co, 4, 4)
        ws = pt.pack_tail_reference([w, w, torch.ones(1, co, 3, 3)])
        packed = ws[0] if kind == pt.ENTRY else ws[1]
        for r in range(3 if kind == pt.ENTRY else 4):
            for c in range(3 if kind == pt.ENTRY else 4):
                for p in range(1 if kind == pt.ENTRY else 4):
                    for q in range(4):
                        if kind == pt.ENTRY:
                            blk = packed[q * co:(q + 1) * co, :, r, c]
                        else:
                            blk = packed[p * ci:(p + 1) * ci, q * co:(q + 1) * co, r, c]
                        assert bool((blk != 0).all()) == _block_live(kind, r, c, p, q)
        return
    skipped = 0
    for ci, co in ((4, 4), (8, 2), (16, 16), (32, 32), (64, 32), (128, 64)):
        w = torch.rand(ci, co, 4, 4) + 0.5
        ws = pt.pack_tail_reference([w, w, torch.rand(1, co, 3, 3) + 0.5])
        if kind == pt.FINAL:
            packed, c4 = ws[2], 4 * co          # (4C, 3, 3, 4), C = co
            for k0 in range(0, c4, kw):
                p = k0 // co if co % kw == 0 else 4
                for a in range(3):
                    for b in range(3):
                        for q in range(4):
                            if not _final_live(p, a, b, q):
                                skipped += 1
                                assert not packed[k0:k0 + kw, a, b, q].any()
            continue
        packed = ws[0] if kind == pt.ENTRY else ws[1]
        cin, cout = (ci, 4 * co) if kind == pt.ENTRY else (4 * ci, 4 * co)
        cph = cin if kind == pt.ENTRY else ci    # input channels per phase
        for r in range(packed.shape[2]):
            for c in range(packed.shape[3]):
                for k0 in range(0, cin, kw):
                    k1 = min(k0 + kw, cin)
                    p_lo, p_hi = (0, 0) if kind == pt.ENTRY else (k0 // cph, (k1 - 1) // cph)
                    for n0 in range(0, cout, nw):
                        n1 = min(n0 + nw, cout)
                        if _range_live(kind, r, c, p_lo, p_hi, n0 // co, (n1 - 1) // co):
                            continue
                        skipped += 1
                        blk = (packed[n0:n1, k0:k1, r, c] if kind == pt.ENTRY
                               else packed[k0:k1, n0:n1, r, c])
                        assert not blk.any()
    assert skipped > 0


@pytest.mark.parametrize("size,itemsize,flops,nbytes", [
    (64, 2, 4445962240, 49884164), (128, 2, 17783848960, 193014788),
    (64, 4, 4445962240, 99766276), (128, 4, 17783848960, 386027524)])
def test_tail_cost_pins_the_bound(size, itemsize, flops, nbytes):
    """B2's bound at the full-width tails, batch 64: the canonical FLOPs,
    and the bytes of h0, the packed weights, the image, the BN vectors and
    each pre-BN intermediate written once and read once."""
    cfg = ModelConfig(image_size=size)
    canonical = channel_schedule(cfg)[1][tail_start(cfg):]
    side = size // 2 ** len(canonical)
    assert tt.tail_cost(64, side, canonical, itemsize) == (flops, nbytes)
    # The intermediates (entry 4Co at the h0 grid, then each interior at
    # twice the side) are most of the bytes.
    inter = 64 * sum((side * 2 ** i) ** 2 * 4 * co for i, (_, co) in enumerate(canonical))
    assert 2 * inter * itemsize > 0.9 * nbytes


def _canonical_tap(kind, q, t, ci, co, Co):
    """The CUDA kernel's ``relayout_kernel`` (csrc/train_tail.cu): the packed
    position it reads tap t = (ta, tb) of output phase q = (qr, qc) from, and
    the canonical (ky, kx) that position holds."""
    qr, qc, ta, tb = q >> 1, q & 1, t >> 1, t & 1
    pos = ((q * Co + co, ci, qr + ta, qc + tb) if kind == pt.ENTRY
           else (ci, q * Co + co, 2 - qr - ta, 2 - qc - tb))
    return pos, (3 - qr - 2 * ta, 3 - qc - 2 * tb)


def _phase_gemm(x, taps, kind, ci_n, co_n):
    """The bf16 kernels' ``convt_mma_kernel`` in plain PyTorch: output packed
    pixel (Py, Px), phase q = (qr, qc), sums canonical input pixel
    (Py + qr + ta - 1, Px + qc + tb - 1) times tap (q, t); an interior's
    canonical pixel (y, x) is packed pixel (y / 2, x / 2), channels of input
    phase 2 (y % 2) + x % 2. ``taps``: [q][t][Co][Ci]."""
    n = x.shape[0]
    if kind == pt.ENTRY:
        canon = x
    else:
        hp, wp = x.shape[1], x.shape[2]
        y = torch.arange(2 * hp)[:, None]
        xx = torch.arange(2 * wp)[None, :]
        ph = ((y % 2) * 2 + xx % 2)[..., None] * ci_n + torch.arange(ci_n)
        canon = x[:, (y // 2).expand(-1, 2 * wp), (xx // 2).expand(2 * hp, -1)]
        canon = torch.gather(canon, 3, ph.expand(n, -1, -1, -1))
    ho, wo = canon.shape[1], canon.shape[2]
    pad = F.pad(canon, (0, 0, 1, 1, 1, 1))
    out = torch.zeros(n, ho, wo, 4 * co_n)
    for q in range(4):
        for t in range(4):
            dy, dx = (q >> 1) + (t >> 1), (q & 1) + (t & 1)   # halo offset of the tap
            out[..., q * co_n:(q + 1) * co_n] += pad[:, dy:dy + ho, dx:dx + wo] @ taps[q][t].T
    return out


@pytest.mark.parametrize("kind", [pt.ENTRY, pt.INTERIOR])
@pytest.mark.parametrize("ci,co", [(4, 4), (8, 2), (16, 8)])
def test_canonical_taps_compute_the_packed_layer(kind, ci, co):
    """The bf16 kernels' reading of B1's packed weight: each of the 16
    (phase, tap) pairs reads the canonical weight where the pack law put it,
    the 16 pairs cover the 4 x 4 kernel once, and the phase GEMM over the
    canonical input computes the packed layer (the plain version's conv)."""
    g = torch.Generator().manual_seed(ci + co)
    w = torch.randn(ci, co, 4, 4, generator=g)
    packed = pt.pack_tail_reference([w, w, torch.ones(1, co, 3, 3)])[0 if kind == pt.ENTRY else 1]
    taps = [[torch.zeros(co, ci) for _ in range(4)] for _ in range(4)]
    seen = set()
    for q in range(4):
        for t in range(4):
            seen.add((q, _canonical_tap(kind, q, t, 0, 0, co)[1]))
            for i in range(ci):
                for o in range(co):
                    pos, (ky, kx) = _canonical_tap(kind, q, t, i, o, co)
                    assert packed[pos] == w[i, o, ky, kx]
                    taps[q][t][o, i] = packed[pos]
    assert len({k for _, k in seen}) == 16
    if kind == pt.ENTRY:
        x = torch.randn(2, 5, 6, ci, generator=g)
        ref = F.conv2d(x.permute(0, 3, 1, 2), packed, padding=1).permute(0, 2, 3, 1)
    else:
        x = torch.randn(2, 3, 4, 4 * ci, generator=g)
        ref = F.conv_transpose2d(x.permute(0, 3, 1, 2), packed, stride=2,
                                 padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(_phase_gemm(x, taps, kind, ci, co), ref, rtol=1e-5, atol=1e-5)
