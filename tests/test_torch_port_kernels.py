"""The port's kernels B3 (upsample block) and B4 (generator forward) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions, so these
tests hold that arithmetic (and the weight packing around it) against the
TPU kernels. The CUDA kernels themselves run only on a card:
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` hold them against
the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.models import generator as jgen
from siggan_tpu.ops.conv import conv_transpose2d as j_convt
from siggan_tpu.ops.pallas import generator_fwd as jfwd
from siggan_tpu.ops.pallas import upsample as jup
from siggan_tpu_torch import bridge
from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.ops.kernels import generator_fwd as tfwd
from siggan_tpu_torch.ops.kernels import upsample as tup


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def small_jax_generator(seed, cfg):
    """JAX init plus random BN running stats, as numpy trees."""
    params, state = jgen.init_fn(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rs = np.random.RandomState(seed)
    for st in [state["fc_bn"]] + state["blocks"]:
        st["mean"] = rs.randn(*st["mean"].shape).astype(np.float32) * 0.1
        st["var"] = (rs.rand(*st["var"].shape) + 0.5).astype(np.float32)
    return params, state


def test_pack_w9_matches_jax():
    w = np.random.RandomState(0).randn(4, 4, 6, 8).astype(np.float32)
    np.testing.assert_array_equal(tup.pack_w9(t(w)).numpy(),
                                  np.asarray(jup.pack_w9(jnp.asarray(w))))


def test_pack_block_taps_matches_jax_and_w9_view():
    w = np.random.RandomState(1).randn(4, 4, 6, 8).astype(np.float32)
    taps = tfwd.pack_block_taps(t(w))
    np.testing.assert_array_equal(
        taps.numpy(), np.asarray(jfwd.pack_block_taps(jnp.asarray(w))))
    # The kernel reads only these taps out of pack_w9's matrices.
    np.testing.assert_array_equal(tup.taps_from_w9(tup.pack_w9(t(w))).numpy(),
                                  taps.numpy())


def test_fold_bn_affine_matches_jax():
    rs = np.random.RandomState(2)
    p = {"scale": rs.rand(8).astype(np.float32) + 0.5,
         "offset": rs.randn(8).astype(np.float32)}
    st = {"mean": rs.randn(8).astype(np.float32),
          "var": rs.rand(8).astype(np.float32) + 0.1}
    s, o = tup.fold_bn_affine({k: t(v) for k, v in p.items()},
                              {k: t(v) for k, v in st.items()})
    js, jo = jup.fold_bn_affine(p, st)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)


# The shapes of tests/test_pallas.py's upsample tests: ReLU on and off.
@pytest.mark.parametrize("seed,shape,cout,relu", [
    (0, (3, 8, 8, 16), 8, True),
    (1, (2, 4, 4, 8), 4, False),
])
def test_upsample_block_matches_pallas_interpret(seed, shape, cout, relu):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(4, 4, shape[-1], cout).astype(np.float32) * 0.1
    scale = rs.rand(cout).astype(np.float32) + 0.5
    offset = rs.randn(cout).astype(np.float32)
    ref = jup.upsample_block(jnp.asarray(x), jup.pack_w9(jnp.asarray(w)),
                             jnp.asarray(scale), jnp.asarray(offset),
                             relu=relu, interpret=True)
    w9 = tup.pack_w9(t(w))
    for fn in (tup.upsample_block, tup.upsample_block_reference):
        got = fn(t(x), w9, t(scale), t(offset), relu=relu)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
    # And against the XLA transposed conv the JAX tests use.
    xla = j_convt(jnp.asarray(x), jnp.asarray(w), stride=2, padding=1) * scale + offset
    xla = jnp.maximum(xla, 0.0) if relu else xla
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=1e-4, atol=1e-5)
    assert (got.numpy().min() < 0) == (not relu)


def test_generator_forward_matches_pallas_interpret():
    cfg = JModelConfig(latent_dim=16, base_features=32, num_classes=0)
    params, state = small_jax_generator(3, cfg)
    z = np.random.RandomState(4).randn(8, 16).astype(np.float32)
    jpacked = jfwd.pack_generator(params, state, cfg)
    ref = jfwd.generator_forward(jpacked, jnp.asarray(z), tile=4, interpret=True)

    model = bridge.from_jax(params, state, ModelConfig(latent_dim=16, base_features=32))
    packed = tfwd.pack_generator(model)
    # The packing itself matches the JAX package's.
    np.testing.assert_allclose(packed["wfc16"].numpy(), np.asarray(jpacked["wfc16"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(packed["bfc16"].numpy(), np.asarray(jpacked["bfc16"]),
                               rtol=1e-6, atol=1e-6)
    for b, jb in zip(packed["blocks"], jpacked["blocks"]):
        np.testing.assert_array_equal(b["taps"].numpy(), np.asarray(jb["taps"]))
        np.testing.assert_allclose(b["scale"].numpy(), np.asarray(jb["scale"])[0],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b["offset"].numpy(), np.asarray(jb["offset"])[0],
                                   rtol=1e-6, atol=1e-6)
    for fn in (tfwd.generator_forward, tfwd.generator_forward_reference):
        got = fn(packed, t(z))
        assert got.shape == (8, 64, 64, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


def test_generator_forward_any_batch_matches_module():
    """No tile padding: an odd batch goes straight through, equal to the
    canonical module forward (cuDNN-path arithmetic)."""
    cfg = JModelConfig(latent_dim=16, base_features=32, num_classes=0)
    params, state = small_jax_generator(5, cfg)
    model = bridge.from_jax(params, state, ModelConfig(latent_dim=16, base_features=32))
    z = t(np.random.RandomState(6).randn(5, 16))
    got = tfwd.generator_forward(tfwd.pack_generator(model), z)
    with torch.no_grad():
        ref = model(z)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_pack_generator_refuses_unsupported_models():
    for kw in ({"num_classes": 3}, {"image_size": 128}, {"g_activation": "leaky_relu"}):
        cfg = ModelConfig(latent_dim=16, base_features=32, **kw)
        assert not tfwd.kernel_supported(cfg)
        from siggan_tpu_torch.models.generator import Generator
        with pytest.raises(ValueError, match="64 px unconditional"):
            tfwd.pack_generator(Generator(cfg))


def test_launch_path_refuses_cpu_tensors():
    """The launch path never falls back: given a CPU tensor it raises."""
    x = torch.zeros(1, 2, 2, 4)
    taps = torch.zeros(4, 2, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tup._launch(x, taps, torch.ones(4), torch.zeros(4), True)
    with pytest.raises(ValueError, match="Cout % 4"):
        tup._launch(x, torch.zeros(4, 2, 2, 4, 3), torch.ones(3), torch.zeros(3), True)
