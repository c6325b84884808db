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

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.models import generator as jgen
from siggan_tpu.ops.pallas.train_tail import tail_forward_train as j_tail_forward_train
from siggan_tpu_torch import bridge
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.models.generator import Generator, fused_tail_supported, tail_start
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


@pytest.mark.parametrize("kind", [pt.ENTRY, pt.INTERIOR])
def test_skipped_weight_blocks_are_the_pack_laws_zeros(kind):
    """Every (kernel index, input phase, output phase) block the CUDA kernel
    skips is zero in B1's packed weight, and every block it keeps is not."""
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
