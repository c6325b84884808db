"""The ablation grid of the port against the JAX package's
``train/ablation.py``.

- ``make_ablation_train_step``: two steps on the JAX step's own draws (its
  latents and the three dropout masks of each step) from the same weights,
  ReLU and leaky-ReLU generators with spectral norm off and on, at a small
  width in f32: params, BN state, spectral-norm u's, both Adam states and
  the losses. Bars: rtol 1e-4 / atol 1e-5 (losses atol 1e-6); the Adam
  moments, as the repo's other step tests hold them, at 1e-3 of each
  tensor's largest entry, and 1e-8 / 1e-16 where BatchNorm cancels a
  gradient to rounding noise (G's fc bias). The learning rate is small,
  5e-7: Adam's first steps are sign-like (a weight whose gradient is
  rounding noise moves by +-lr on either side), and at batch 4 G's
  second-step gradients pass through BatchNorm backwards over 4 samples,
  a sum that cancels to ~1e-3 of its terms, so that rounding of the first
  step's weights moves some of them by up to ~1 % at larger rates (the
  default step shows the same at lr 2e-6).
- The grid's order and short names, ``results.csv`` and ``results.md``
  against the JAX package's ``save_tables`` on the same results, and a tiny
  run of the manager and of ``cli.ablate`` on the CPU (tables, plot data,
  sample grids, the epoch order of the JAX package)."""

import json

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
from siggan_tpu.train import ablation as jablation
from siggan_tpu_torch import bridge
from siggan_tpu_torch.cli import ablate as ablate_cli
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.data.synthetic import generate_dataset, save_dataset_pngs
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.ops.kernels import train_tail as tt
from siggan_tpu_torch.train import ablation as tablation
from test_torch_port_share_fakes import port_state
from test_torch_port_train import TINY, assert_trees_close, jax_masks, jax_opt, widths

LR = 5e-7
B = 4


def jax_ablation_draws(jcfg: JTrainConfig, step: int, b: int):
    root = jrng.root_key(jcfg.seed, jcfg.rng_impl)
    nk = jrng.at_step(jrng.stream(root, jrng.STREAM_NOISE), step)
    dk = jax.random.split(jrng.at_step(jrng.stream(root, jrng.STREAM_DROPOUT), step), 3)
    return {"z": torch.from_numpy(np.array(jgen.generate_latent(nk, b, jcfg.model))),
            "masks": [jax_masks(k, b, widths(jcfg.model)) for k in dk]}


@pytest.mark.parametrize("sn", [False, True])
@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_ablation_step_matches_jax(act, sn):
    jcfg = JTrainConfig(model=JModelConfig(g_activation=act, use_spectral_norm=sn, **TINY),
                        batch_size=B, compute_dtype="float32", seed=0,
                        rng_impl="threefry2x32", augment=False,
                        optim=JOptimConfig(moment_dtype="float32", d_lr=LR, g_lr=LR))
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    js = j_create_train_state(jcfg)
    st = port_state(js, cfg)
    j_step = jax.jit(jablation.make_ablation_train_step(jcfg))
    t_step = tablation.make_ablation_train_step(cfg)
    real = generate_dataset(B, 64, seed=3)
    counts = (pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count, tt.LAUNCHES.count)
    for step in range(2):
        js, jm = j_step(js, jnp.asarray(real))
        st, m = t_step(st, torch.from_numpy(real), jax_ablation_draws(jcfg, step, B))
        assert set(m) == set(jm) == {"d_loss", "g_loss"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{step} {k}")
    assert (pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count, tt.LAUNCHES.count) == counts
    assert st.step == int(js.step) == 2
    tol = dict(rtol=1e-4, atol=1e-5)
    assert_trees_close(bridge.params_to_jax(st.g), js.g_params, **tol)
    assert_trees_close(bridge.params_to_jax(st.d), js.d_params, **tol)
    assert_trees_close(bridge.to_jax(st.g)[1], js.g_bn, **tol)
    assert_trees_close(bridge.d_to_jax(st.d)[1], js.d_state, **tol)
    for opt, jopt, model in ((st.g_opt, js.g_opt, st.g), (st.d_opt, js.d_opt, st.d)):
        j = jax_opt(jopt)
        assert int(opt["count"]) == int(j["count"]) == 2
        for k, floor in (("m", 1e-8), ("v", 1e-16)):
            got = jax.tree_util.tree_leaves(bridge.tensors_to_jax(model, opt[k]))
            for a, b in zip(got, jax.tree_util.tree_leaves(j[k])):
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a, b, rtol=1e-3,
                                           atol=max(1e-3 * np.abs(b).max(), floor))


def test_grid_names_and_tables_match_jax(tmp_path):
    images = np.zeros((8, 64, 64, 1), np.float32)
    jm = jablation.AblationStudyManager(images, tmp_path / "j", epochs=3, batch_size=4)
    tm = tablation.AblationStudyManager(images, tmp_path / "t", epochs=3, batch_size=4,
                                        device="cpu")
    want = [(c.short_name, c.to_train_config().to_dict()) for c in jm.grid()]
    got = [(c.short_name, c.to_train_config().to_dict()) for c in tm.grid()]
    assert got == want and len(got) == 12 and got[0][0] == "z50_relu_sn0"
    over = {"latent_dim": [64], "use_spectral_norm": [True]}
    assert [c.short_name for c in tm.grid(over)] == [c.short_name for c in jm.grid(over)]
    rs = np.random.RandomState(0)
    for i, (jc, tc) in enumerate(zip(jm.grid(), tm.grid())):
        vals = dict(final_d_loss=float(rs.rand()), final_g_loss=float(rs.rand()),
                    d_loss_variance=float(rs.rand()), g_loss_variance=float(rs.rand()),
                    fid=None if i == 3 else float(rs.rand() * 100),
                    wall_time_sec=float(rs.rand()), g_params=1000 + i, d_params=7)
        jm.results.append(jablation.AblationResult(config=jc, **vals))
        tm.results.append(tablation.AblationResult(config=tc, **vals))
    jm.save_tables()
    tm.save_tables()
    for name in ("results.csv", "results.md", "results.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text(), name


def test_manager_runs_a_tiny_grid_on_the_jax_epoch_order(tmp_path, monkeypatch):
    """Two configurations, 2 epochs of 2 steps on the CPU, with FID: the
    batches follow ``RandomState((seed, epoch)).permutation``, the tables,
    plot data and sample grids are written, the losses are finite."""
    images = generate_dataset(8, 64, seed=5)
    seen = []
    step_fn = tablation.make_ablation_train_step

    def spy(cfg):
        step = step_fn(cfg)

        def wrapped(state, real, draws=None):
            seen.append(real.clone())
            return step(state, real, draws)
        return wrapped
    monkeypatch.setattr(tablation, "make_ablation_train_step", spy)
    mgr = tablation.AblationStudyManager(images, tmp_path, epochs=2, batch_size=4,
                                         compute_dtype="float32", fid_real_cap=6,
                                         fid_samples=6, device="cpu")
    res = mgr.run_all({"latent_dim": [16], "g_activation": ["relu", "leaky_relu"],
                       "use_spectral_norm": [True]})
    assert [r.config.short_name for r in res] == ["z16_relu_sn1", "z16_lrelu_sn1"]
    order = [np.random.RandomState((42, e)).permutation(8) for e in range(2)]
    want = [images[o[b * 4:(b + 1) * 4]] for o in order for b in range(2)]
    for got, w in zip(seen, want * 2):
        np.testing.assert_array_equal(got.numpy(), w)
    for r in res:
        assert np.isfinite([r.final_d_loss, r.final_g_loss, r.fid]).all()
        assert r.g_params == sum(p.numel() for p in
                                 tablation.create_train_state(r.config.to_train_config(),
                                                              "cpu").g.parameters())
        assert (tmp_path / "samples" / f"{r.config.short_name}.png").exists()
    plots = json.loads((tmp_path / "plots.json").read_text())
    assert sorted(plots) == ["fid_comparison.png", "loss_curves.png", "params_vs_fid.png",
                             "stability.png", "wall_time.png"]
    assert len(plots["loss_curves.png"]["z16_relu_sn1"]["d_loss"]) == 2
    header = (tmp_path / "results.csv").read_text().splitlines()[0]
    assert header == "short_name,final_d_loss,final_g_loss,stability,fid,wall_time_sec,g_params"


def test_cli_ablate_runs_and_needs_a_card(tmp_path, monkeypatch, capsys):
    data = save_dataset_pngs(8, tmp_path / "data", seed=6)
    out = tmp_path / "out"
    argv = ["--data_dir", str(data), "--output_dir", str(out), "--epochs", "1",
            "--batch_size", "4", "--latent_dims", "16", "--activations", "relu",
            "--spectral_norm", "off", "--no_fid"]
    assert ablate_cli.main(argv + ["--device", "cpu"]) == 0
    assert "1 runs complete" in capsys.readouterr().out
    for name in ("results.csv", "results.md", "results.json", "plots.json",
                 "samples/z16_relu_sn0.png"):
        assert (out / name).exists(), name
    assert json.loads((out / "results.json").read_text())[0]["fid"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ablate_cli.main(argv)
