"""JAX (Orbax) runs imported into the port by ``scripts/import_jax_run.py``,
against the JAX package on the CPU.

A small JAX run (64 px, base 32, EMA on, bf16 Adam moments) is trained for
two epochs of 48 steps by the JAX train step and saved by the JAX
``CheckpointManager``; the script converts it. Then: the port serves JAX's
eval images for the same z (rtol 1e-4, atol 1e-5, f32), through the EMA
shadow; D, its spectral-norm u's and both Adam states equal the JAX trees
exactly (bf16 moments exact after the cast); one resumed step on JAX's
draws matches the JAX step from the same restored state (the tolerances of
``test_torch_port_train.py``); ``cli.train --resume`` continues at the next
epoch with the step counter, the fixed noise and the best alias; a
conditional (``concat``, 2 classes, spectral norm, the AC-GAN head, linear
LR schedule, f32 moments) run round-trips with the schedule's LR at the restored count; a
shadow under ``ema_decay == 0`` is dropped as JAX drops it; the committed
fixture under ``tests/data/torch_port/jax_run/`` (the script's conversion
of the same run's latest epoch without D and the Adam states, with JAX's
eval images) has the layout the script writes now and serves its JAX
images. ``python tests/test_torch_port_import.py
--write-fixture`` rewrites the fixture.
"""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.ckpt.manager import CheckpointManager as JManager
from siggan_tpu.ckpt.manager import load_generator as j_load_generator
from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import OptimConfig as JOptimConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.core.state import _lr_schedule as j_lr_schedule
from siggan_tpu.core.state import create_train_state as j_create_train_state
from siggan_tpu.models import generator as jgen
from siggan_tpu.train.train_step import make_train_step as j_make_train_step
from siggan_tpu_torch import bridge
from siggan_tpu_torch.ckpt.manager import CheckpointManager, load_generator
from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.core.state import lr_schedule
from siggan_tpu_torch.data.synthetic import generate_dataset, save_dataset_pngs
from siggan_tpu_torch.infer.generate import load_session
from siggan_tpu_torch.train.train_step import make_train_step
from test_torch_port_multistep import few_threads  # noqa: F401  (autouse)
from test_torch_port_train import assert_trees_close, jax_draws, jax_opt, np_tree

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import import_jax_run  # noqa: E402

FIXTURE = Path(__file__).parent / "data" / "torch_port" / "jax_run"
# The fixture's run: what chip_smoke.py serves through B4 (64 px, ReLU,
# unconditional, every block's Cout a multiple of 4) and this file tests.
RUN_CFG = JTrainConfig(model=JModelConfig(base_features=32), batch_size=4,
                       compute_dtype="float32", seed=5, rng_impl="threefry2x32",
                       ema_decay=0.9, use_pallas=True, fixed_noise_samples=16)
COND_CFG = JTrainConfig(
    model=JModelConfig(latent_dim=16, base_features=32, num_classes=2,
                       g_conditioning="concat", use_spectral_norm=True, aux_classifier=True),
    batch_size=4, compute_dtype="float32", seed=6, rng_impl="threefry2x32", aux_weight=0.5,
    optim=JOptimConfig(lr_schedule="linear", moment_dtype="float32"),
    fixed_noise_samples=8)
EPOCHS = 2
# Steps an epoch: the served run trains long enough (48 steps an epoch) for
# its BN running statistics to settle (momentum 0.9), so that its eval
# images are not the near-constant ones of an untrained generator.
STEPS = {"main": 48, "cond": 2}


def make_jax_run(ckpt_dir: Path, jcfg: JTrainConfig, steps: int):
    """``EPOCHS`` epochs of ``steps`` JAX train steps, each epoch saved by
    the JAX manager (the trainer's saves, without its compile of a scan);
    returns the run's config and its jitted step."""
    if jcfg.optim.lr_schedule != "constant":
        jcfg = jcfg.replace(optim=dataclasses.replace(jcfg.optim,
                                                      lr_total_steps=EPOCHS * steps))
    b = jcfg.batch_size
    images = generate_dataset(b * steps, 64, seed=jcfg.seed)
    labels = np.arange(b * steps, dtype=np.int32) % max(jcfg.model.num_classes, 1)
    state = j_create_train_state(jcfg)
    step = jax.jit(j_make_train_step(jcfg))
    mgr = JManager(ckpt_dir, jcfg, authoritative=True)
    noise = jgen.generate_latent(jax.random.PRNGKey(7), jcfg.fixed_noise_samples, jcfg.model)
    for epoch in range(EPOCHS):
        for s in range(steps):
            batch = jnp.asarray(images[s * b:(s + 1) * b])
            if jcfg.model.num_classes:
                state, m = step(state, batch, jnp.asarray(labels[s * b:(s + 1) * b]))
            else:
                state, m = step(state, batch)
        mgr.save(state, epoch=epoch, fixed_noise=noise, g_loss=float(m["g_loss"]))
    return jcfg, step


def jax_images(ckpt_dir: Path, z: np.ndarray, y=None) -> np.ndarray:
    """The JAX package's eval images of its run's served generator."""
    g_params, g_bn, cfg = j_load_generator(ckpt_dir)
    img, _ = jgen.apply_fn(g_params, g_bn, jnp.asarray(z), cfg.model, train=False,
                           y=None if y is None else jnp.asarray(y))
    return np.asarray(img)


def eval_z(jcfg: JTrainConfig, n: int = 16) -> np.ndarray:
    return np.random.default_rng(11).standard_normal((n, jcfg.model.latent_dim)
                                                      ).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("import")
    out = {}
    for name, jcfg in (("main", RUN_CFG), ("cond", COND_CFG)):
        src, dst = root / f"{name}_jax", root / f"{name}_port"
        jcfg, step = make_jax_run(src, jcfg, STEPS[name])
        out[name] = (jcfg, src, dst)
        out[f"{name}_step"] = step
        import_jax_run.main([str(src), str(dst)])
    return out


def test_imported_run_serves_jax_images_through_the_shadow(runs):
    jcfg, src, dst = runs["main"]
    assert json.loads((dst / "index.json").read_text()) == JManager(src, jcfg).available()
    z = eval_z(jcfg)
    session = load_session(str(dst), device="cpu")
    assert session.uses_kernel                     # B4's plain version on the CPU
    with torch.no_grad():
        got = session._fwd(torch.from_numpy(z)).numpy()
    want = jax_images(src, z)
    assert want.std() > 0.05 and np.abs(want).max() > 0.2      # not a flat, untrained image
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # The served weights are the shadow, not the raw weights.
    epoch = dst / "epoch_0001"
    model, _ = load_generator(dst, "cpu")
    served = bridge.flatten(*bridge.to_jax(model))
    with np.load(epoch / "generator_ema.npz") as ema, np.load(epoch / "generator.npz") as raw:
        for k, v in served.items():
            np.testing.assert_array_equal(v, ema[k], err_msg=k)
        assert not np.array_equal(raw["fc/w"], ema["fc/w"])
    js, _ = JManager(src, jcfg).restore("latest")
    assert_trees_close(bridge.params_to_jax(model), js.g_ema["params"], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["main", "cond"])
def test_imported_state_equals_the_jax_trees(runs, name):
    """G, D, the u's, both Adam states (bf16 moments exact after the cast),
    the step, the fixed noise and the best G loss, for every epoch."""
    jcfg, src, dst = runs[name]
    steps = STEPS[name]
    cfg = TrainConfig.from_json((dst / "config.json").read_text())
    for epoch in range(EPOCHS):
        js, jx = JManager(src, jcfg).restore(epoch)
        st, ex = CheckpointManager(dst, cfg).restore(epoch, device="cpu")
        assert st.step == int(js.step) == (epoch + 1) * steps
        assert ex["epoch"] == jx["epoch"] == epoch
        assert ex["best_g_loss"] == jx["best_g_loss"]
        np.testing.assert_array_equal(ex["fixed_noise"].numpy(), np.asarray(jx["fixed_noise"]))
        exact = dict(rtol=0, atol=0)
        assert_trees_close(bridge.to_jax(st.g), (js.g_params, js.g_bn), **exact)
        d_params, d_state = bridge.d_to_jax(st.d)
        assert_trees_close(d_params, js.d_params, **exact)
        assert_trees_close(d_state, js.d_state, **exact)
        assert (len(jax.tree_util.tree_leaves(js.d_state)) > 0) == (name == "cond")
        assert ("aux" in js.d_params and "class_embed" in js.d_params) == (name == "cond")
        for got, want, model in ((st.g_opt, js.g_opt, st.g), (st.d_opt, js.d_opt, st.d)):
            mdt = getattr(torch, jcfg.optim.moment_dtype)
            assert got["m"][0].dtype == mdt
            j = jax_opt(want)
            assert int(got["count"]) == int(j["count"]) == (epoch + 1) * steps
            tree = bridge.opt_to_jax(got, model)
            assert_trees_close(tree["m"], j["m"], **exact)
            assert_trees_close(tree["v"], j["v"], **exact)
        assert (st.g_ema is not None) == (name == "main")


def test_resumed_step_matches_the_jax_step(runs):
    """One step from the imported latest epoch, on JAX's draws, against the
    JAX step from the same restored state."""
    jcfg, src, dst = runs["main"]
    js, _ = JManager(src, jcfg).restore("latest")
    cfg = TrainConfig.from_json((dst / "config.json").read_text())
    st, _ = CheckpointManager(dst, cfg).restore("latest", device="cpu")
    real = generate_dataset(4, 64, seed=9)
    js1, jm = runs["main_step"](js, jnp.asarray(real))
    st, m = make_train_step(cfg)(st, torch.from_numpy(real), jax_draws(jcfg, int(js.step), 4))
    assert st.step == int(js1.step) == EPOCHS * STEPS["main"] + 1
    for k, v in m.items():
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert_trees_close(bridge.to_jax(st.g)[1], js1.g_bn, rtol=1e-4, atol=1e-6)
    assert_trees_close(bridge.params_to_jax(st.g), js1.g_params, rtol=2e-3, atol=1e-3)
    assert_trees_close(bridge.params_to_jax(st.d), js1.d_params, rtol=2e-3, atol=1e-3)
    assert_trees_close(bridge.params_to_jax(st.g_ema), js1.g_ema["params"],
                       rtol=2e-3, atol=1e-3)


def test_cli_resume_continues_the_imported_run(runs, tmp_path, capsys):
    """``cli.train --resume`` on the imported run (its flags; base_features,
    which no flag sets, from the run's sidecar) trains the next epoch with
    the step counter, the fixed noise and the best alias kept."""
    jcfg, src, dst = runs["main"]
    run = tmp_path / "run"
    shutil.copytree(dst, run)
    before = json.loads((run / "index.json").read_text())
    noise = np.load(run / "epoch_0001" / "fixed_noise.npy")
    data = tmp_path / "data"
    save_dataset_pngs(8, data, seed=4)      # 2 steps an epoch: 2 divides the restored step
    train_cli.main(["--data_dir", str(data), "--checkpoint_dir", str(run),
                    "--sample_dir", str(tmp_path / "s"), "--log_dir", str(tmp_path / "l"),
                    "--resume", "--epochs", "3", "--batch_size", "4", "--seed", "5",
                    "--ema_decay", "0.9", "--compute_dtype", "float32",
                    "--rng_impl", "threefry2x32", "--checkpoint_interval", "1",
                    "--sample_interval", "0", "--device", "cpu"])
    assert f"Resumed from epoch 1 (step {EPOCHS * STEPS['main']})" in capsys.readouterr().out
    idx = json.loads((run / "index.json").read_text())
    assert idx["epochs"] == [0, 1, 2] and idx["latest"] == 2
    assert idx["best"] in (before["best"], 2)
    assert idx["best_g_loss"] <= before["best_g_loss"]
    meta = json.loads((run / "epoch_0002" / "state.json").read_text())
    assert meta == {"step": EPOCHS * STEPS["main"] + 2, "epoch": 2,
                    "best_g_loss": idx["best_g_loss"]}
    np.testing.assert_array_equal(np.load(run / "epoch_0002" / "fixed_noise.npy"), noise)
    cfg = TrainConfig.from_json((run / "epoch_0002" / "config.json").read_text())
    assert cfg.model.base_features == 32 and cfg.ema_decay == 0.9
    assert (run / "epoch_0002" / "generator_ema.npz").exists()


def test_conditional_scheduled_run_round_trips(runs):
    """``concat`` with 2 classes: JAX's images per class; the linear
    schedule's LR at the restored count, as recorded and as the next port
    update applies it."""
    jcfg, src, dst = runs["cond"]
    z = eval_z(jcfg, 8)
    y = np.arange(8) % 2
    session = load_session(str(dst), device="cpu")
    assert not session.uses_kernel
    with torch.no_grad():
        got = session._fwd(torch.from_numpy(z), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, jax_images(src, z, y), rtol=1e-4, atol=1e-5)
    cfg = TrainConfig.from_json((dst / "config.json").read_text())
    assert cfg.optim.lr_total_steps == EPOCHS * STEPS["cond"]
    st, _ = CheckpointManager(dst, cfg).restore("latest", device="cpu")
    count = int(st.g_opt["count"])
    for key, lr in (("g", cfg.optim.g_lr), ("d", cfg.optim.d_lr)):
        j_sched = j_lr_schedule(jcfg.replace(optim=cfg.optim), lr)
        applied = float(getattr(st, f"{key}_opt")["lr"])
        assert applied == pytest.approx(float(j_sched(count - 1)), rel=1e-6)
        assert float(lr_schedule(cfg, lr)(torch.tensor(count, dtype=torch.int32))) == \
            pytest.approx(float(j_sched(count)), rel=1e-6)
    real = generate_dataset(4, 64, seed=2)
    st, _ = make_train_step(cfg)(st, torch.from_numpy(real),
                                 None, torch.tensor([0, 1, 0, 1]))
    j_sched = j_lr_schedule(jcfg.replace(optim=cfg.optim), cfg.optim.g_lr)
    assert float(st.g_opt["lr"]) == pytest.approx(float(j_sched(count)), rel=1e-6)


def test_shadow_is_dropped_at_ema_decay_zero(runs, tmp_path):
    """A run saved with a shadow whose sidecar now says ``ema_decay == 0``:
    JAX's restore drops the shadow, so the import writes none and both
    packages serve the raw weights."""
    jcfg, src, _ = runs["main"]
    off = tmp_path / "off_jax"
    shutil.copytree(src, off)
    (off / "config.json").write_text(jcfg.replace(ema_decay=0.0).to_json())
    dst = tmp_path / "off_port"
    import_jax_run.convert(off, dst, ["latest"])
    assert not (dst / "epoch_0001" / "generator_ema.npz").exists()
    z = eval_z(jcfg, 4)
    model, _ = load_generator(dst, "cpu")
    with torch.no_grad():
        got = load_session(str(dst), device="cpu")._fwd(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, jax_images(off, z), rtol=1e-4, atol=1e-5)
    g_params, _, _ = j_load_generator(off)
    assert_trees_close(bridge.params_to_jax(model), np_tree(g_params), rtol=0, atol=0)


def test_which_selects_epochs():
    idx = {"epochs": [0, 2, 4], "latest": 4, "best": 2}
    assert import_jax_run.select(idx, ["all"]) == [0, 2, 4]
    assert import_jax_run.select(idx, ["best", "latest", "2"]) == [2, 4]
    assert import_jax_run.select(idx, ["0"]) == [0]
    with pytest.raises(SystemExit):
        import_jax_run.select(idx, ["3"])


# What the fixture leaves out of the script's epoch: D and the Adam states
# (D keeps its 2.76 M parameters at every generator width).
NOT_SERVED = ("discriminator.npz", "optimizer.npz")


def write_fixture(out: Path, src: Path, jcfg: JTrainConfig) -> None:
    """The script's conversion of the run's latest epoch without
    ``NOT_SERVED``, and JAX's eval images of 16 fixed latents."""
    if out.exists():
        shutil.rmtree(out)
    import_jax_run.main([str(src), str(out), "--which", "latest"])
    for name in NOT_SERVED:
        for p in out.rglob(name):
            p.unlink()
    z = eval_z(jcfg)
    np.savez(out / "jax_eval.npz", z=z, images=jax_images(src, z))


def _arrays(path: Path) -> dict:
    """The arrays of a .npz by name, or a .npy's under ""."""
    if path.suffix == ".npy":
        return {"": np.load(path)}
    with np.load(path) as f:
        return dict(f)


def test_committed_fixture_is_what_the_script_writes(runs, tmp_path):
    """The committed fixture has the layout the script writes now: the same
    files, arrays of the same names, shapes and dtypes, the same config,
    step, epoch and index, and the same fixed noise (drawn, not trained).
    Its trained arrays are held to its own JAX images instead of to a run
    trained again here: after 96 Adam steps another host's f32 summation
    order need not land within rounding of them. JAX's forward of the
    committed served weights, and the port's, give the committed images at
    the serving bar (rtol 1e-4, atol 1e-5)."""
    jcfg, src, _ = runs["main"]
    fresh = tmp_path / "fixture"
    write_fixture(fresh, src, jcfg)
    committed = sorted(p.relative_to(FIXTURE) for p in FIXTURE.rglob("*") if p.is_file())
    assert committed == sorted(p.relative_to(fresh) for p in fresh.rglob("*") if p.is_file())
    assert sum((FIXTURE / p).stat().st_size for p in committed) < 2 << 20
    for rel in committed:
        a, b = FIXTURE / rel, fresh / rel
        if rel.suffix in (".npy", ".npz"):
            x, y = _arrays(a), _arrays(b)
            assert sorted(x) == sorted(y), rel
            for k in x:
                assert (x[k].shape, x[k].dtype) == (y[k].shape, y[k].dtype), f"{rel}:{k}"
            if rel.name == "fixed_noise.npy":
                np.testing.assert_allclose(x[""], y[""], rtol=1e-5, atol=1e-6)
        elif rel.name == "index.json" or rel.name == "state.json":
            x, y = json.loads(a.read_text()), json.loads(b.read_text())
            assert np.isfinite(x.pop("best_g_loss")) and np.isfinite(y.pop("best_g_loss"))
            assert x == y, rel
        else:
            assert a.read_text() == b.read_text(), rel
    index = json.loads((FIXTURE / "index.json").read_text())
    state = json.loads((FIXTURE / "epoch_0001" / "state.json").read_text())
    assert index["best_g_loss"] == state["best_g_loss"]
    with np.load(FIXTURE / "jax_eval.npz") as f:
        z, want = f["z"], f["images"]
    assert want.std() > 0.05 and np.abs(want).max() > 0.2      # not a flat, untrained image
    model, _ = load_generator(FIXTURE, "cpu")
    g_params, g_bn = bridge.to_jax(model)
    jax_img, _ = jgen.apply_fn(g_params, g_bn, jnp.asarray(z), jcfg.model, train=False)
    np.testing.assert_allclose(np.asarray(jax_img), want, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        got = load_session(str(FIXTURE), device="cpu")._fwd(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            jcfg, _ = make_jax_run(Path(td) / "jax", RUN_CFG, STEPS["main"])
            write_fixture(FIXTURE, Path(td) / "jax", jcfg)
        print(sorted(str(p.relative_to(FIXTURE)) for p in FIXTURE.rglob("*") if p.is_file()))
