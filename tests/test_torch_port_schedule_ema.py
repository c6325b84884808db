"""LR schedules, Adam under a schedule, generator EMA and the whole v2.0
train step of the port against the JAX package.

- ``core/state.py::lr_schedule`` (device values of Adam's int32 count)
  against optax's ``join_schedules`` of ``_lr_schedule`` at every count
  from 0 to total + 3, linear and cosine, end fractions 0 and 0.1, D's span
  stretched for n_critic = 2. Bar: rtol 1e-6 and atol 5e-7 of the base LR
  (1e-10): XLA on the CPU multiplies by the reciprocal of a constant
  divisor and fuses ``1 - c / T`` into an FMA (its linear end value is
  -3e-12, not 0), and ``1 + cos`` near pi loses relative precision.
- One Adam update under a schedule against ``adam_low_mem`` and
  ``optax.adam`` at a count on each side of the decay's start: rtol 1e-6 /
  atol 1e-9 (the same f32 operations; the LR itself within the bar above).
- ``ema_update`` against the JAX function (rtol 1e-6 / atol 1e-8: two f32
  products and a sum, which XLA may fuse into an FMA); the shadow starts
  as a copy; checkpoints carry it, ``load_generator`` serves it, and the
  JAX package's resume rules hold.
- Two whole v2.0 train steps (concat labels, spectral-norm projection
  head, DiffAugment "translation,cutout", linear LR decay, EMA; one case
  with the AC-GAN head on reals and fakes) on the JAX step's own draws
  (latents, fake labels, dropout masks, augment and DiffAugment
  parameters), in f32 and bf16 moments. Bars are stated at each check."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from siggan_tpu.core import rng as jrng
from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import OptimConfig as JOptimConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.core.state import _lr_schedule as j_lr_schedule
from siggan_tpu.core.state import create_train_state as j_create_train_state
from siggan_tpu.core.state import ema_update as j_ema_update
from siggan_tpu.core.state import make_optimizers as j_make_optimizers
from siggan_tpu.models import generator as jgen
from siggan_tpu.train.train_step import _fake_labels as j_fake_labels
from siggan_tpu.train.train_step import make_train_step as j_make_train_step
from siggan_tpu_torch import bridge
from siggan_tpu_torch.ckpt.manager import CheckpointManager, load_generator
from siggan_tpu_torch.core.config import ModelConfig, OptimConfig, TrainConfig
from siggan_tpu_torch.core.state import (TrainState, create_train_state, ema_tensors,
                                         ema_update, eval_generator_weights, lr_schedule,
                                         make_optimizers, set_learning_rates)
from siggan_tpu_torch.data.synthetic import generate_labeled_dataset
from siggan_tpu_torch.train.train_step import make_eval_generate, make_train_step
from test_torch_port_diffaug import jax_params
from test_torch_port_train import TINY, assert_trees_close, jax_draws, jax_opt, np_tree, port_cfg

LR = 2e-4


@pytest.mark.parametrize("n_critic", [1, 2])
@pytest.mark.parametrize("end_frac", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_device_lr_matches_the_optax_schedule(kind, end_frac, n_critic):
    total = 10
    jcfg = JTrainConfig(n_critic=n_critic, optim=JOptimConfig(
        lr_schedule=kind, lr_total_steps=total, lr_end_frac=end_frac))
    want = jax.jit(j_lr_schedule(jcfg, LR, n_critic))
    got = lr_schedule(port_cfg(jcfg), LR, n_critic)
    counts = list(range(total * n_critic + 4))
    ref = np.array([np.float32(want(jnp.int32(c))) for c in counts])
    out = np.array([float(got(torch.tensor(c, dtype=torch.int32))) for c in counts])
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=5e-7 * LR)
    start = int(total * n_critic * 0.5)
    assert (out[:start] == np.float32(LR)).all() and out[-1] < LR
    assert lr_schedule(port_cfg(JTrainConfig()), LR) == LR       # constant: the float
    with pytest.raises(ValueError, match="lr_total_steps"):
        lr_schedule(port_cfg(jcfg).replace(optim=OptimConfig(lr_schedule=kind)), LR)


def jax_update(tx):
    @jax.jit
    def update(params, state, grads):
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state
    return update


@pytest.mark.parametrize("count", [3, 5])      # start = 4: one on each side
@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_adam_step_under_a_schedule_matches_jax(moments, count):
    jcfg = JTrainConfig(optim=JOptimConfig(lr_schedule="linear", lr_total_steps=8,
                                           lr_end_frac=0.1, moment_dtype=moments))
    j_tx = j_make_optimizers(jcfg)[0]
    t_tx = make_optimizers(port_cfg(jcfg))[0]
    rs = np.random.RandomState(count)
    shapes = [(3, 4), (5,)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    jp, tp = [jnp.asarray(p) for p in params], [torch.from_numpy(p.copy()) for p in params]
    js, ts = j_tx.init(jp), t_tx.init(tp)
    update = jax_update(j_tx)
    zeros = [np.zeros(s, np.float32) for s in shapes]
    for _ in range(count):       # zero gradients: the counts advance, nothing else
        jp, js = update(jp, js, [jnp.asarray(z) for z in zeros])
        t_tx.step(tp, [torch.from_numpy(z) for z in zeros], ts)
    g = [rs.randn(*s).astype(np.float32) * 1e-2 for s in shapes]
    jp, js = update(jp, js, [jnp.asarray(x) for x in g])
    t_tx.step(tp, [torch.from_numpy(x) for x in g], ts)
    moved = [a.numpy() - b for a, b in zip(tp, params)]
    for a, b, p in zip(tp, jp, params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    lr = float(ts["lr"])
    want_lr = LR if count < 4 else LR - (LR - 0.1 * LR) * (count - 4) / 4
    assert lr == pytest.approx(want_lr, rel=1e-6) and int(ts["count"]) == count + 1
    assert all(np.abs(m).min() > 0 for m in moved)


def test_ema_update_matches_jax_and_the_shadow_starts_as_a_copy():
    cfg = TrainConfig(model=ModelConfig(**TINY), ema_decay=0.999, compute_dtype="float32")
    st = create_train_state(cfg, "cpu")
    assert st.g_ema is not None
    for a, b in zip(ema_tensors(st.g_ema), ema_tensors(st.g)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    rs = np.random.RandomState(3)
    with torch.no_grad():
        for t in ema_tensors(st.g) + ema_tensors(st.g_ema):
            t.copy_(torch.from_numpy(rs.randn(*t.shape).astype(np.float32)))
    params, bn = bridge.to_jax(st.g)
    shadow = bridge.ema_to_jax(st.g_ema)
    want = j_ema_update(jax.tree_util.tree_map(jnp.asarray, shadow),
                        jax.tree_util.tree_map(jnp.asarray, params),
                        jax.tree_util.tree_map(jnp.asarray, bn), 0.999)
    ema_update(st.g_ema, st.g, 0.999)
    assert_trees_close(bridge.ema_to_jax(st.g_ema), want, rtol=1e-6, atol=1e-8)
    assert eval_generator_weights(st) is st.g_ema
    assert create_train_state(cfg.replace(ema_decay=0.0), "cpu").g_ema is None


def test_eval_generate_samples_the_ema_generator_with_labels():
    cfg = TrainConfig(model=ModelConfig(num_classes=3, g_conditioning="concat", **TINY),
                      ema_decay=0.5, compute_dtype="float32")
    st = create_train_state(cfg, "cpu")
    with torch.no_grad():
        st.g_ema.final.bias.fill_(5.0)        # tanh(x + 5): visibly the shadow
    z = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    y = torch.arange(4) % 3
    imgs = make_eval_generate(cfg)(st, z, y)
    assert torch.equal(imgs, st.g_ema(z, y, torch.float32).float())
    assert not torch.equal(imgs, st.g(z, y, torch.float32).float())
    assert set_learning_rates(cfg, g_lr=1e-4).optim.g_lr == 1e-4
    assert set_learning_rates(cfg, d_lr=3e-4).optim == dataclasses.replace(cfg.optim, d_lr=3e-4)


def ema_cfg(tmp_path, ema: float) -> TrainConfig:
    return TrainConfig(model=ModelConfig(num_classes=3, g_conditioning="concat",
                                         use_spectral_norm=True, aux_classifier=True, **TINY),
                       ema_decay=ema, compute_dtype="float32", checkpoint_dir=str(tmp_path),
                       optim=OptimConfig(lr_schedule="cosine", lr_total_steps=8))


def test_checkpoint_round_trips_g_ema_and_serves_it(tmp_path):
    cfg = ema_cfg(tmp_path, 0.9)
    st = create_train_state(cfg, "cpu")
    with torch.no_grad():
        for t in ema_tensors(st.g_ema):
            t.add_(0.25)
        st.d.class_embed_u.copy_(torch.nn.functional.normalize(torch.randn(8192), dim=0))
        st.g_opt["lr"].fill_(1.5e-4)
    mgr = CheckpointManager(tmp_path, cfg, authoritative=True)
    path = mgr.save(st, epoch=0, fixed_noise=torch.zeros(2, 16), g_loss=1.0)
    assert (path / "generator_ema.npz").exists()
    back, _ = mgr.restore("latest", "cpu")
    for a, b in zip(ema_tensors(back.g_ema) + list(back.d.buffers()),
                    ema_tensors(st.g_ema) + list(st.d.buffers())):
        assert torch.equal(a, b)
    shapes = {k: tuple(t.shape) for k, t in back.d.named_buffers()}
    assert shapes["class_embed_u"] == (8192,) and shapes["aux.u"] == (3,)
    assert float(back.g_opt["lr"]) == pytest.approx(1.5e-4) and float(back.d_opt["lr"]) == 0
    served, _ = load_generator(tmp_path, "cpu")        # the EMA weights
    for a, b in zip(ema_tensors(served), ema_tensors(st.g_ema)):
        assert torch.equal(a, b)
    # The d_state tree carries the heads' u's under the JAX keys and shapes.
    state = bridge.d_to_jax(back.d)[1]
    assert state["class_embed"]["u"].shape == (8192,) and state["aux"]["u"].shape == (3,)


def test_resume_rules_for_the_shadow(tmp_path):
    # A checkpoint without a shadow, restored with EMA on: a copy of the weights.
    plain = ema_cfg(tmp_path / "a", 0.0)
    st = create_train_state(plain, "cpu")
    CheckpointManager(tmp_path / "a", plain).save(st, epoch=0, fixed_noise=torch.zeros(2, 16))
    back, _ = CheckpointManager(tmp_path / "a", plain.replace(ema_decay=0.9)).restore(
        "latest", "cpu")
    for a, b in zip(ema_tensors(back.g_ema), ema_tensors(back.g)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    # A shadow restored with EMA off is dropped, and serving takes the weights.
    tracked = ema_cfg(tmp_path / "b", 0.9)
    st = create_train_state(tracked, "cpu")
    with torch.no_grad():
        st.g_ema.final.bias.fill_(3.0)
    CheckpointManager(tmp_path / "b", tracked).save(st, epoch=0, fixed_noise=torch.zeros(2, 16))
    back, _ = CheckpointManager(tmp_path / "b", tracked.replace(ema_decay=0.0)).restore(
        "latest", "cpu")
    assert back.g_ema is None
    (tmp_path / "b" / "epoch_0000" / "config.json").write_text(
        tracked.replace(ema_decay=0.0).to_json())
    served, _ = load_generator(tmp_path / "b", "cpu")
    assert torch.equal(served.final.bias, st.g.final.bias)


V20 = dict(num_classes=3, g_conditioning="concat", use_spectral_norm=True, **TINY)


def v20_jcfg(moments: str, aux: bool) -> JTrainConfig:
    return JTrainConfig(
        model=JModelConfig(aux_classifier=aux, **V20), batch_size=4, compute_dtype="float32",
        seed=0, rng_impl="threefry2x32", diffaugment="translation,cutout", ema_decay=0.9,
        aux_weight=0.5 if aux else 0.0, aux_d_on_fakes=aux,
        # v2.0's d_lr / g_lr ratio at 1/100 of its scale: Adam's first
        # steps are sign-like (tiny gradients move by +-lr whichever side
        # f32 rounding puts them), so small rates keep the second step on
        # weights within ~1e-5 of each other and its checks tight.
        optim=JOptimConfig(moment_dtype=moments, lr_schedule="linear", lr_total_steps=2,
                           lr_decay_start_frac=0.0, lr_end_frac=0.1, d_lr=1e-6, g_lr=2e-6))


def jax_draws_v20(jcfg: JTrainConfig, step: int, b: int):
    """``jax_draws`` for a conditional DiffAugment step: each sub-step's
    noise key splits into the latents' key and the fake labels' key, and
    DiffAugment draws from fold_in(dropout key, 7) over 2b images in a D
    step and b in the G step."""
    draws = jax_draws(jcfg, step, b)
    root = jrng.root_key(jcfg.seed, jcfg.rng_impl)
    k = jcfg.n_critic + 1
    nkeys = jax.random.split(jrng.at_step(jrng.stream(root, jrng.STREAM_NOISE), step), k)
    dkeys = jax.random.split(jrng.at_step(jrng.stream(root, jrng.STREAM_DROPOUT), step), k)
    draws["z"], draws["y"], draws["diffaug"] = [], [], []
    for i, (nk, dk) in enumerate(zip(nkeys, dkeys)):
        nk, yk = jax.random.split(nk)
        draws["y"].append(torch.from_numpy(np.array(j_fake_labels(yk, b, jcfg))).long())
        draws["z"].append(torch.from_numpy(np.array(jgen.generate_latent(nk, b, jcfg.model))))
        n = 2 * b if i < jcfg.n_critic else b
        draws["diffaug"].append(jax_params(jax.random.fold_in(dk, 7), jcfg.diffaugment, n,
                                           jcfg.model.image_size))
    return draws


def port_state(js, cfg: TrainConfig) -> TrainState:
    g = bridge.from_jax(np_tree(js.g_params), np_tree(js.g_bn), cfg.model, "cpu")
    d = bridge.d_from_jax(np_tree(js.d_params), cfg.model, "cpu", d_state=np_tree(js.d_state))
    mdt = getattr(torch, cfg.optim.moment_dtype)
    return TrainState(step=int(js.step), g=g, d=d,
                      g_opt=bridge.opt_from_jax(jax_opt(js.g_opt), g, mdt),
                      d_opt=bridge.opt_from_jax(jax_opt(js.d_opt), d, mdt),
                      g_ema=bridge.ema_from_jax(np_tree(js.g_ema), cfg.model, "cpu"))


@pytest.mark.parametrize("moments,aux", [("float32", False), ("bfloat16", False),
                                         ("float32", True)])
def test_v20_train_step_matches_jax_step(moments, aux):
    jcfg = v20_jcfg(moments, aux)
    cfg = port_cfg(jcfg)
    js = j_create_train_state(jcfg)
    st = port_state(js, cfg)
    images, labels = generate_labeled_dataset(3, 3, 64, seed=2)
    real, y = images[[0, 3, 6, 1]], labels[[0, 3, 6, 1]]
    j_step, t_step = jax.jit(j_make_train_step(jcfg)), make_train_step(cfg)
    for step in range(2):
        js, jm = j_step(js, jnp.asarray(real), jnp.asarray(y))
        st, m = t_step(st, torch.from_numpy(real), jax_draws_v20(jcfg, step, 4),
                       torch.from_numpy(y))
        assert set(m) == set(jm), (set(m) ^ set(jm))
        for k, v in m.items():
            np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{step} {k}")
    assert st.step == int(js.step) == 2
    tol = dict(rtol=1e-4, atol=1e-5)
    assert_trees_close(bridge.params_to_jax(st.g), js.g_params, **tol)
    assert_trees_close(bridge.params_to_jax(st.d), js.d_params, **tol)
    assert_trees_close(bridge.ema_to_jax(st.g_ema), js.g_ema, **tol)
    assert_trees_close(bridge.to_jax(st.g)[1], js.g_bn, **tol)
    # u's: unit vectors, 1e-5 of the unit (entries near zero carry f32
    # rounding of the weights they iterate on).
    assert_trees_close(bridge.d_to_jax(st.d)[1], js.d_state, rtol=1e-4, atol=1e-5)
    for opt, jopt, model in ((st.g_opt, js.g_opt, st.g), (st.d_opt, js.d_opt, st.d)):
        j = jax_opt(jopt)
        assert int(opt["count"]) == int(j["count"]) == 2
        # The second update ran at lr(1) = lr * (1 - 0.9 / 2).
        base = cfg.optim.g_lr if model is st.g else cfg.optim.d_lr
        assert float(opt["lr"]) == pytest.approx(base * 0.55, rel=1e-6)
        # The moments are sums of both steps' gradients: 1e-3 of each
        # tensor's largest entry (bf16 moments: their rounding), and 1e-8
        # / 1e-16 where BatchNorm cancels a gradient to rounding noise (G's
        # fc bias, ~5e-9).
        rel = 1e-2 if moments == "bfloat16" else 1e-3
        for k, floor in (("m", 1e-8), ("v", 1e-16)):
            got = jax.tree_util.tree_leaves(bridge.tensors_to_jax(model, opt[k]))
            for a, b in zip(got, jax.tree_util.tree_leaves(j[k])):
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a, b, rtol=rel,
                                           atol=max(rel * np.abs(b).max(), floor))
