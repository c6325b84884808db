"""The port's generator, weight bridge and checkpoint against the JAX
package: the bridged module's eval forward equals ``generator.apply_fn(
train=False)`` for every conditioning mode, the bridge round-trips, and a
port checkpoint's sidecar loads in both packages."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.models import generator as jgen
from siggan_tpu_torch import bridge
from siggan_tpu_torch.ckpt import manager
from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.models import generator as tgen
from siggan_tpu_torch.ops.conv import linear_oi


def jax_generator(seed, jcfg):
    """JAX init with every parameter and BN statistic randomized, so no
    layout mistake hides behind a constant (fc BN vectors are HWC-ordered:
    a CHW reshape would permute them)."""
    params, state = jgen.init_fn(jax.random.key(seed), jcfg)
    rs = np.random.RandomState(seed)

    def rand_like(a, lo=0.0, scale=1.0):
        return (lo + rs.rand(*np.shape(a)) * scale).astype(np.float32)

    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    for bn in [params["fc_bn"]] + [b["bn"] for b in params["blocks"]]:
        bn["scale"] = rand_like(bn["scale"], 0.5)
        bn["offset"] = rand_like(bn["offset"], -0.5)
    params["fc"]["b"] = rand_like(params["fc"]["b"], -0.1, 0.2)
    params["final"]["b"] = rand_like(params["final"]["b"], -0.1, 0.2)
    for st in [state["fc_bn"]] + state["blocks"]:
        st["mean"] = rand_like(st["mean"], -0.1, 0.2)
        st["var"] = rand_like(st["var"], 0.5)
    return params, state


def port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("cond,act", [
    ("none", "relu"), ("full", "relu"), ("concat", "relu"),
    ("bn_only", "leaky_relu"), ("embed_only", "relu"),
])
def test_bridged_generator_matches_apply_fn(cond, act):
    nc = 0 if cond == "none" else 3
    jcfg = JModelConfig(latent_dim=16, base_features=32, num_classes=nc,
                        g_conditioning=cond if nc else "full", g_activation=act)
    params, state = jax_generator(11, jcfg)
    rs = np.random.RandomState(12)
    z = rs.randn(5, 16).astype(np.float32)
    y = rs.randint(0, 3, 5).astype(np.int32) if nc else None
    ref, _ = jgen.apply_fn(params, state, jnp.asarray(z), jcfg, train=False,
                           y=None if y is None else jnp.asarray(y))
    model = bridge.from_jax(params, state, port_cfg(jcfg))
    got = tgen.apply_fn(model, torch.from_numpy(z),
                        y=None if y is None else torch.from_numpy(y).long())
    assert got.shape == (5, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_fc_output_is_hwc_ordered():
    """Feature f of the fc is pixel f // C0, channel f % C0 of the 4x4 map."""
    cfg = ModelConfig(latent_dim=4, base_features=8)
    model = tgen.Generator(cfg)
    with torch.no_grad():
        model.fc.bias.copy_(torch.arange(16 * 8, dtype=torch.float32))
        model.fc_bn.scale.fill_(1.0)
    h = model.fc_bn(linear_oi(torch.zeros(1, 4), model.fc.weight, model.fc.bias))
    m = h.reshape(1, 4, 4, 8)
    assert float(m[0, 1, 2, 3]) == pytest.approx((1 * 4 + 2) * 8 + 3, rel=1e-5)


def test_bridge_round_trip_is_identity():
    jcfg = JModelConfig(latent_dim=16, base_features=32, num_classes=3,
                        g_conditioning="full")
    params, state = jax_generator(13, jcfg)
    p2, s2 = bridge.to_jax(bridge.from_jax(params, state, port_cfg(jcfg)))
    flat, flat2 = bridge.flatten(params, state), bridge.flatten(p2, s2)
    assert sorted(flat) == sorted(flat2)
    assert "fc/w" in flat and "bn/blocks/0/mean" in flat and "embed" in flat
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat2[k])
    p3, s3 = bridge.unflatten(flat)
    assert len(p3["blocks"]) == 4 and len(s3["blocks"]) == 4
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((p3, s3))):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trip_and_sidecar_schema(tmp_path):
    cfg = TrainConfig(model=ModelConfig(latent_dim=16, base_features=32),
                      compute_dtype="float32", use_pallas=True)
    model = tgen.init_fn(rng.generator(0, rng.STREAM_INIT_G), cfg.model)
    manager.save_generator(tmp_path, model, cfg)
    loaded, cfg2 = manager.load_generator(tmp_path, "cpu")
    assert cfg2 == cfg
    for (k, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), k
    # The sidecar is the JAX package's schema, both ways.
    jcfg = JTrainConfig.from_json((tmp_path / "config.json").read_text())
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())
    assert TrainConfig.from_json(JTrainConfig().to_json()) == TrainConfig()
    assert manager.infer_architecture(manager.load_arrays(tmp_path)) == {
        "latent_dim": 16, "image_size": 64, "base_features": 32}


def test_init_and_param_count_match_jax_at_full_width():
    cfg = ModelConfig()
    model = tgen.init_fn(rng.generator(1, rng.STREAM_INIT_G), cfg)
    jparams, _ = jgen.init_fn(jax.random.key(0), JModelConfig())
    assert tgen.param_count(model) == jgen.param_count(jparams)
    assert 1.1e6 < tgen.param_count(model) < 1.2e6
    assert tgen.channel_schedule(cfg) == jgen.channel_schedule(JModelConfig())
    assert tgen.channel_schedule(ModelConfig(image_size=128)) == \
        jgen.channel_schedule(JModelConfig(image_size=128))
    w = model.blocks[0].weight
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert abs(float(model.fc_bn.scale.mean()) - 1.0) < 1e-2
    again = tgen.init_fn(rng.generator(1, rng.STREAM_INIT_G), cfg)
    assert torch.equal(again.fc.weight, model.fc.weight)


def test_conditional_forward_requires_labels():
    cfg = ModelConfig(latent_dim=16, base_features=32, num_classes=3)
    model = tgen.init_fn(rng.generator(2, rng.STREAM_INIT_G), cfg)
    with pytest.raises(ValueError, match="requires labels"):
        tgen.apply_fn(model, torch.zeros(2, 16))
