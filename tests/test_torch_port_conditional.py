"""Conditional (v2.0) training of the port against the JAX package: the
labeled writer-style data (bit-equal), ``writer_labels``, the
discriminator's projection and AC-GAN heads with and without spectral norm,
the train-mode generator in every ``g_conditioning`` mode (and kernel B2's
route for ``concat``), labels through the resident and K-step routes
(their graph buffers replayed on the CPU), and the conditional trainer and
CLI end to end on the CPU (grid, checkpoint, resume with the schedule
going on, served with ``class_id``).

Tolerances: f32 rtol 1e-4 / atol 1e-5 (the same math, sums in another
order); spectral-norm vectors rtol 1e-5 / atol 1e-6 (unit vectors); the
pack-tail route against the module route as ``test_torch_port_train_tail``
holds it (rtol 1e-4 / atol 1e-5)."""

import base64
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.data import synthetic as jsynth
from siggan_tpu.data.dataset import SignatureDataset as JSignatureDataset
from siggan_tpu.models import discriminator as jdisc
from siggan_tpu.models import generator as jgen
from siggan_tpu_torch import bridge
from siggan_tpu_torch.ckpt.manager import CheckpointManager
from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import ModelConfig, OptimConfig, TrainConfig
from siggan_tpu_torch.core.state import create_train_state, lr_schedule
from siggan_tpu_torch.data import synthetic
from siggan_tpu_torch.data.dataset import SignatureDataset
from siggan_tpu_torch.infer.export import decode_png
from siggan_tpu_torch.models.generator import fused_tail_supported
from siggan_tpu_torch.ops.kernels import train_tail as tt
from siggan_tpu_torch.serve.api import ApiCore
from siggan_tpu_torch.train.train_step import (make_resident_multi_step,
                                               make_resident_train_step, state_tensors)
from test_torch_port_multistep import assert_states_equal, uncaptured, windows
from test_torch_port_train import TINY, jax_masks, np_tree, port_cfg, widths

TOL = dict(rtol=1e-4, atol=1e-5)


def port_model(jcfg: JModelConfig) -> ModelConfig:
    return port_cfg(JTrainConfig(model=jcfg)).model


def test_labeled_dataset_is_bit_equal_to_jax(monkeypatch):
    monkeypatch.delenv("SIGGAN_SYNTH_CACHE", raising=False)
    got, gl = synthetic.generate_labeled_dataset(3, 4, 64, seed=5)
    want, wl = jsynth.generate_labeled_dataset(3, 4, 64, seed=5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gl, wl)
    assert got.dtype == np.float32 and gl.dtype == np.int32 and got.shape == (12, 64, 64, 1)


def test_writer_labels_match_jax_and_refuse_a_flat_directory(tmp_path):
    root = synthetic.save_labeled_dataset_pngs(3, 2, tmp_path / "w", seed=1)
    assert sorted(p.name for p in root.iterdir()) == ["writer_000", "writer_001", "writer_002"]
    got = SignatureDataset(root, 64, use_cache=False).writer_labels()
    want = JSignatureDataset(root, 64, use_cache=False).writer_labels()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and list(got[0]) == [0, 0, 1, 1, 2, 2]
    flat = synthetic.save_dataset_pngs(2, tmp_path / "flat", seed=1)
    for ds in (SignatureDataset(flat, 64, use_cache=False),
               JSignatureDataset(flat, 64, use_cache=False)):
        with pytest.raises(ValueError, match="per-writer subdirectories"):
            ds.writer_labels()


def random_unit(rs, n):
    u = rs.randn(n).astype(np.float32)
    return u / np.linalg.norm(u)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("sn", [False, True])
@pytest.mark.parametrize("heads", ["projection", "aux", "both"])
def test_conditional_discriminator_matches_apply_fn(heads, sn, train):
    jcfg = JModelConfig(num_classes=3, d_projection=heads != "aux",
                        aux_classifier=heads != "projection", use_spectral_norm=sn, **TINY)
    params, state = np_tree(jdisc.init_fn(jax.random.key(1), jcfg))
    rs = np.random.RandomState(2)
    for blk in params["blocks"]:
        blk["b"] = (rs.randn(*blk["b"].shape) * 0.1).astype(np.float32)
    if sn:   # u's away from the fixed start e_0, so one iteration moves them
        state = jax.tree_util.tree_map(lambda u: random_unit(rs, u.shape[0]), state)
    x = rs.uniform(-1, 1, (6, 32, 32, 4)).astype(np.float32)
    y = rs.randint(0, 3, 6).astype(np.int32)
    key = jax.random.key(3, impl="threefry2x32")
    aux = heads != "projection"
    out, new_state = jdisc.apply_fn(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, state),
        jnp.asarray(x), jcfg, train=train, rng=key, compute_dtype=jnp.float32,
        packed_input=True, y=jnp.asarray(y), aux=aux)
    logits, aux_logits = out if aux else (out, None)

    d = bridge.d_from_jax(params, port_model(jcfg), "cpu", d_state=state if sn else None)
    masks = jax_masks(key, 6, widths(port_model(jcfg))) if train else None
    got = d(torch.from_numpy(x), train=train, compute_dtype=torch.float32, packed_input=True,
            masks=masks, y=torch.from_numpy(y).long(), aux=aux)
    got_logits, got_aux = got if aux else (got, None)
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(logits), **TOL)
    if aux:
        assert got_aux.dtype == torch.float32 and got_aux.shape == (6, 3)
        np.testing.assert_allclose(got_aux.detach().numpy(), np.asarray(aux_logits), **TOL)
    got_state = bridge.d_to_jax(d)[1]
    assert jax.tree_util.tree_structure(got_state) == jax.tree_util.tree_structure(
        np_tree(new_state))
    for a, b in zip(jax.tree_util.tree_leaves(got_state), jax.tree_util.tree_leaves(new_state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    if heads != "aux":
        with pytest.raises(ValueError, match="labels"):
            d(torch.from_numpy(x), train=False, packed_input=True)


MODES = ["full", "bn_only", "embed_only", "concat", "none"]


@pytest.mark.parametrize("mode", MODES)
def test_train_mode_conditional_generator_matches_apply_fn(mode):
    jcfg = JModelConfig(num_classes=3, g_conditioning=mode, **TINY)
    params, state = np_tree(jgen.init_fn(jax.random.key(4), jcfg))
    rs = np.random.RandomState(5)
    if mode in ("full", "bn_only"):   # class rows that differ
        for bn in [params["fc_bn"]] + [b["bn"] for b in params["blocks"]]:
            bn["scale"] = (bn["scale"] + rs.randn(*bn["scale"].shape) * 0.1).astype(np.float32)
            bn["offset"] = (rs.randn(*bn["offset"].shape) * 0.1).astype(np.float32)
    z = rs.randn(6, 16).astype(np.float32)
    y = np.array([0, 1, 2, 2, 1, 0], np.int32)
    ref, ref_bn = jgen.apply_fn(params, jax.tree_util.tree_map(jnp.asarray, state),
                                jnp.asarray(z), jcfg, train=True, compute_dtype=jnp.float32,
                                packed_output=True, y=jnp.asarray(y))
    cfg = port_model(jcfg)
    g = bridge.from_jax(params, state, cfg, "cpu")
    g2 = copy.deepcopy(g)
    img = g(torch.from_numpy(z), torch.from_numpy(y).long(), torch.float32, train=True,
            packed_output=True)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.to_jax(g)[1]),
                    jax.tree_util.tree_leaves(ref_bn)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    # The D step's route: B2's plain version on the CPU where the gate admits it.
    assert fused_tail_supported(cfg) == (mode in ("embed_only", "concat", "none"))
    if fused_tail_supported(cfg):
        launches = tt.LAUNCHES.count
        with torch.no_grad():
            fused = g2(torch.from_numpy(z), torch.from_numpy(y).long(), torch.float32,
                       train=True, packed_output=True, fused_tail=True)
        assert tt.LAUNCHES.count == launches
        np.testing.assert_allclose(fused.numpy(), img.detach().numpy(), **TOL)
        for a, b in zip(g2.buffers(), g.buffers()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def v20_cfg(**kw) -> TrainConfig:
    return TrainConfig(
        model=ModelConfig(num_classes=3, g_conditioning="concat", use_spectral_norm=True,
                          aux_classifier=True, **TINY),
        batch_size=4, compute_dtype="float32", seed=3, diffaugment="color,translation,cutout",
        ema_decay=0.9, aux_weight=0.5, aux_d_on_fakes=True,
        optim=OptimConfig(lr_schedule="linear", lr_total_steps=8, lr_end_frac=0.1), **kw)


def eager_run(cfg, images, labels, state, steps):
    fn, _ = make_resident_train_step(cfg, len(images))
    ms = []
    for _ in range(steps):
        state, m = fn(state, images, labels=labels)
        ms.append(m)
    return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


@pytest.mark.parametrize("k,class_balanced", [(2, True), (4, False)])
def test_conditional_multi_step_equals_resident_steps(k, class_balanced):
    """K steps per call on the CPU, and the graph route's buffers (fake
    labels, DiffAugment parameters, labels gathered with the batch rows)
    replayed with each capture replaced by a direct call, against eager
    resident steps over two epochs; the LR records follow the schedule."""
    cfg = v20_cfg(class_balanced_fakes=class_balanced)
    images, labels = synthetic.generate_labeled_dataset(3, 6, 64, seed=4)
    images = torch.from_numpy(images[:16])
    labels = torch.from_numpy(labels[:16]).long()
    want_state, want = eager_run(cfg, images, labels, create_train_state(cfg, "cpu"), 8)
    assert set(want) >= {"aux_acc_real", "d_loss", "g_loss"}
    multi, spe = make_resident_multi_step(cfg, 16, k)
    a, got = windows(lambda s, im: multi(s, im, labels), create_train_state(cfg, "cpu"),
                     images, 8 // k)
    assert_states_equal(a, want_state)
    graphed = uncaptured(make_resident_multi_step(cfg, 16, k)[0])
    b, got_g = windows(lambda s, im: graphed(s, im, labels), create_train_state(cfg, "cpu"),
                       images, 8 // k)
    assert_states_equal(b, want_state)
    for key, v in want.items():
        assert torch.equal(got[key], v) and torch.equal(got_g[key], v), key
    assert len(state_tensors(b)) == len(state_tensors(want_state))
    sched = lr_schedule(cfg, cfg.optim.g_lr)
    assert torch.equal(b.g_opt["lr"], sched(torch.tensor(7, dtype=torch.int32)))
    with pytest.raises(ValueError, match="other images or labels"):
        graphed(b, images, labels.clone())


def test_conditional_cli_trains_samples_checkpoints_resumes_and_serves(tmp_path, capsys):
    data = synthetic.save_labeled_dataset_pngs(3, 8, tmp_path / "data", seed=2)
    run = tmp_path / "run"
    argv = ["--data_dir", str(data), "--epochs", "2", "--batch_size", "8",
            "--compute_dtype", "float32", "--checkpoint_interval", "1", "--sample_interval", "1",
            "--run_dir", str(run), "--device", "cpu", "--num_classes", "3",
            "--g_conditioning", "concat", "--spectral_norm", "--latent_dim", "20",
            "--d_lr", "1e-4", "--g_lr", "2e-4", "--lr_schedule", "linear",
            "--diffaugment", "translation,cutout", "--ema_decay", "0.9", "--aux_weight", "0.5"]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Writers: 3" in out and "aux_acc_real" in out
    ckpt = run / "checkpoints"
    cfg = TrainConfig.from_json((ckpt / "config.json").read_text())
    # The span was filled in (2 epochs x 3 steps) and travels with the config.
    assert cfg.optim.lr_total_steps == 6 and cfg.model.num_classes == 3
    ep = ckpt / "epoch_0001"
    assert (ep / "generator_ema.npz").exists()
    state, extras = CheckpointManager(ckpt, cfg).restore("latest", "cpu")
    assert state.step == 6 and int(state.g_opt["count"]) == 6
    for opt, lr in ((state.g_opt, 2e-4), (state.d_opt, 1e-4)):
        assert float(opt["lr"]) == pytest.approx(lr * (1 - 2 / 3), rel=1e-6)  # lr(5)
    assert sorted(p.name for p in (run / "samples").glob("*.png"))[-1] == "epoch_0002.png"

    # Resume for a third epoch: the schedule goes on from the restored count.
    assert train_cli.main([a if a != "2" else "3" for a in argv] + ["--resume"]) == 0
    assert "Resumed from epoch 1 (step 6)" in capsys.readouterr().out
    cfg3 = TrainConfig.from_json((ckpt / "config.json").read_text())
    assert cfg3.optim.lr_total_steps == 9
    state, _ = CheckpointManager(ckpt, cfg3).restore("latest", "cpu")
    assert state.step == 9
    assert float(state.g_opt["lr"]) == pytest.approx(2e-4 * (1 - 4 / 5), rel=1e-6)  # lr(8)

    # Served with class_id: the EMA generator, images that repeat for a
    # seed and differ between classes.
    core = ApiCore(device="cpu")
    core.load_model(str(ckpt))
    assert core.info()["num_classes"] == 3

    def images(class_id):
        payload, _ = core.generate({"n": 2, "seed": 5, "format": "base64",
                                    "class_id": class_id})
        return [decode_png(base64.b64decode(s)) for s in json.loads(payload)["images"]]
    a0, a0_again, a2 = images(0), images(0), images(2)
    assert all(np.array_equal(p, q) for p, q in zip(a0, a0_again))
    assert not all(np.array_equal(p, q) for p, q in zip(a0, a2))
    assert a0[0].shape[:2] == (64, 64)


def test_cli_refuses_a_num_classes_mismatch(tmp_path):
    data = synthetic.save_labeled_dataset_pngs(2, 2, tmp_path, seed=0)
    with pytest.raises(SystemExit, match="--num_classes=3 but found 2 writer subdirs"):
        train_cli.main(["--data_dir", str(data), "--num_classes", "3", "--batch_size", "2",
                        "--device", "cpu", "--run_dir", str(tmp_path / "run")])
