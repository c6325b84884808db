"""The shared-fake step (``share_fakes``) of the port against the JAX
package's ``shared_fakes_step``, on the JAX step's own draws: one latent
batch (and, conditional, one set of fake labels) from the step's noise key,
the D pass's dropout masks and DiffAugment draw from the first half of its
dropout key (2b images), the G head's from the second (b images), and the
per-step augmentation. Two whole steps at a small width in f32, then
params, BN state, spectral-norm u's, the EMA shadow, both Adam states and
the metrics are compared. Bars: rtol 1e-4 / atol 1e-5 (metrics atol
1e-6); the Adam moments, as the repo's other step tests hold them, at
1e-3 of each tensor's largest entry, and 1e-8 / 1e-16 where BatchNorm
cancels a gradient to rounding noise (G's fc bias). Learning rates are
small for the reasons ``test_torch_port_ablation.py`` gives (Adam's
sign-like first steps; G's BatchNorm backward over 4 samples):
unconditional 1e-6, v2.0 as ``test_torch_port_schedule_ema.py::v20_jcfg``
sets them.
Also: the trainer and the CLI train with ``--share_fakes`` on the CPU, its
draws have the step's layout, and ``n_critic != 1`` raises as in JAX."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.core import rng as jrng
from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import OptimConfig as JOptimConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.core.state import create_train_state as j_create_train_state
from siggan_tpu.models import generator as jgen
from siggan_tpu.train.train_step import _fake_labels as j_fake_labels
from siggan_tpu.train.train_step import make_train_step as j_make_train_step
from siggan_tpu_torch import bridge
from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import TrainState, create_train_state
from siggan_tpu_torch.data.synthetic import (generate_dataset, generate_labeled_dataset,
                                             save_dataset_pngs)
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.ops.regularizers import keep_mask
from siggan_tpu_torch.train.train_step import Streams, make_train_step, step_draws
from test_torch_port_diffaug import jax_params
from test_torch_port_schedule_ema import v20_jcfg
from test_torch_port_train import (TINY, assert_trees_close, jax_draws, jax_masks, jax_opt,
                                   np_tree, widths)


def shared_draws(jcfg: JTrainConfig, step: int, b: int):
    """The JAX shared-fake step's draws at ``step`` in the port's form."""
    root = jrng.root_key(jcfg.seed, jcfg.rng_impl)
    nk = jrng.at_step(jrng.stream(root, jrng.STREAM_NOISE), step)
    dk = jrng.at_step(jrng.stream(root, jrng.STREAM_DROPOUT), step)
    draws = {"augment": jax_draws(jcfg, step, b)["augment"]}
    if jcfg.model.num_classes > 0:
        nk, yk = jax.random.split(nk)
        draws["y"] = [torch.from_numpy(np.array(j_fake_labels(yk, b, jcfg))).long()]
    draws["z"] = [torch.from_numpy(np.array(jgen.generate_latent(nk, b, jcfg.model)))]
    dk_d, dk_g = jax.random.split(dk)
    ws = widths(jcfg.model)
    draws["masks"] = [jax_masks(dk_d, 2 * b, ws), jax_masks(dk_g, b, ws)]
    if jcfg.diffaugment:
        draws["diffaug"] = [
            jax_params(jax.random.fold_in(k, 7), jcfg.diffaugment, n, jcfg.model.image_size)
            for k, n in ((dk_d, 2 * b), (dk_g, b))]
    return draws


def port_state(js, cfg: TrainConfig) -> TrainState:
    g = bridge.from_jax(np_tree(js.g_params), np_tree(js.g_bn), cfg.model, "cpu")
    d = bridge.d_from_jax(np_tree(js.d_params), cfg.model, "cpu", d_state=np_tree(js.d_state))
    mdt = getattr(torch, cfg.optim.moment_dtype)
    ema = None if js.g_ema is None else bridge.ema_from_jax(np_tree(js.g_ema), cfg.model, "cpu")
    return TrainState(step=int(js.step), g=g, d=d, g_ema=ema,
                      g_opt=bridge.opt_from_jax(jax_opt(js.g_opt), g, mdt),
                      d_opt=bridge.opt_from_jax(jax_opt(js.d_opt), d, mdt))


LR = 1e-6


def unconditional_jcfg() -> JTrainConfig:
    return JTrainConfig(model=JModelConfig(**TINY), batch_size=4, compute_dtype="float32",
                        seed=0, rng_impl="threefry2x32", share_fakes=True,
                        optim=JOptimConfig(moment_dtype="float32", d_lr=LR, g_lr=LR))


@pytest.mark.parametrize("case", ["unconditional", "v20"])
def test_shared_fakes_step_matches_jax(case):
    if case == "unconditional":
        jcfg = unconditional_jcfg()
        real, y = generate_dataset(4, 64, seed=6), None
    else:
        jcfg = v20_jcfg("float32", False).replace(share_fakes=True)
        images, labels = generate_labeled_dataset(3, 3, 64, seed=2)
        real, y = images[[0, 3, 6, 1]], labels[[0, 3, 6, 1]]
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    assert cfg.share_fakes and cfg.packed_io and cfg.model.g_pack_pallas
    js = j_create_train_state(jcfg)
    st = port_state(js, cfg)
    j_step, t_step = jax.jit(j_make_train_step(jcfg)), make_train_step(cfg)
    yt = None if y is None else torch.from_numpy(y)
    for step in range(2):
        if y is None:
            js, jm = j_step(js, jnp.asarray(real))
        else:
            js, jm = j_step(js, jnp.asarray(real), jnp.asarray(y))
        st, m = t_step(st, torch.from_numpy(real), shared_draws(jcfg, step, 4), yt)
        assert set(m) == set(jm), set(m) ^ set(jm)
        for k, v in m.items():
            np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{step} {k}")
    assert st.step == int(js.step) == 2
    tol = dict(rtol=1e-4, atol=1e-5)
    assert_trees_close(bridge.params_to_jax(st.g), js.g_params, **tol)
    assert_trees_close(bridge.params_to_jax(st.d), js.d_params, **tol)
    assert_trees_close(bridge.to_jax(st.g)[1], js.g_bn, **tol)
    assert_trees_close(bridge.d_to_jax(st.d)[1], js.d_state, **tol)
    if jcfg.ema_decay > 0:
        assert_trees_close(bridge.ema_to_jax(st.g_ema), js.g_ema, **tol)
    for opt, jopt, model in ((st.g_opt, js.g_opt, st.g), (st.d_opt, js.d_opt, st.d)):
        j = jax_opt(jopt)
        assert int(opt["count"]) == int(j["count"]) == 2
        for k, floor in (("m", 1e-8), ("v", 1e-16)):
            got = jax.tree_util.tree_leaves(bridge.tensors_to_jax(model, opt[k]))
            for a, b in zip(got, jax.tree_util.tree_leaves(j[k])):
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a, b, rtol=1e-3,
                                           atol=max(1e-3 * np.abs(b).max(), floor))


def test_shared_fakes_draws_have_the_step_layout():
    """One latent batch and one set of fake labels; D's masks and
    DiffAugment draw over 2b images, the G head's over b; the D pass's
    numbers are those of the default step's first sub-step."""
    base = TrainConfig(model=ModelConfig(num_classes=3, g_conditioning="concat", **TINY),
                       diffaugment="translation,cutout", seed=3)
    got = step_draws(base.replace(share_fakes=True), Streams(3, "cpu"), 2, 4, "cpu")
    want = step_draws(base, Streams(3, "cpu"), 2, 4, "cpu")
    assert len(got["z"]) == len(got["y"]) == 1 and len(want["z"]) == 2
    assert [t.shape[0] for t in (got["u"][0][0], got["u"][1][0])] == [8, 4]
    assert [torch.utils._pytree.tree_leaves(p)[0].shape[0] for p in got["diffaug"]] == [8, 4]
    assert torch.equal(got["z"][0], want["z"][0]) and torch.equal(got["y"][0], want["y"][0])
    with pytest.raises(ValueError, match="n_critic == 1"):
        make_train_step(base.replace(share_fakes=True, n_critic=2))


def test_cli_trains_with_shared_fakes(tmp_path, capsys):
    """``cli.train --share_fakes`` trains on the CPU (the plain versions of
    B1 and B1', no launch), and a step runs one generator forward: G's BN
    running statistics are those of one train-mode forward on its z."""
    data = save_dataset_pngs(16, tmp_path / "data", seed=4)
    f0, b0 = pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count
    argv = ["--data_dir", str(data), "--epochs", "1", "--batch_size", "8",
            "--compute_dtype", "float32", "--run_dir", str(tmp_path / "run"),
            "--device", "cpu", "--share_fakes", "--latent_dim", "16"]
    assert train_cli.main(argv) == 0
    assert (pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count) == (f0, b0)
    assert (tmp_path / "run" / "checkpoints" / "index.json").exists()
    cfg = TrainConfig(model=ModelConfig(**TINY), batch_size=4, compute_dtype="float32",
                      share_fakes=True, augment=False, seed=1)
    st = create_train_state(cfg, "cpu")
    g0 = copy.deepcopy(st.g)
    draws = step_draws(cfg, Streams(1, "cpu"), 0, 4, "cpu")
    draws["masks"] = [[keep_mask(t, cfg.model.dropout) for t in u] for u in draws.pop("u")]
    st, _ = make_train_step(cfg)(st, torch.from_numpy(generate_dataset(4, 64, seed=1)), draws)
    g0(draws["z"][0], None, torch.float32, train=True, packed_output=True)
    for a, b in zip(g0.buffers(), st.g.buffers()):
        assert torch.equal(a, b)
