"""The port's training path against the JAX package: the discriminator and
the train-mode generator (packed tail through the B1/B1' autograd Function,
CPU side) with their gradients, one whole train step on the JAX package's
exact randomness (latents, dropout masks, augmentation), the D and
optimizer bridge, and the trainer and CLI end to end on the CPU (checkpoint,
resume, the trained generator served)."""

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
from siggan_tpu.data.augment import augment_params as j_augment_params
from siggan_tpu.models import discriminator as jdisc
from siggan_tpu.models import generator as jgen
from siggan_tpu.train.train_step import make_train_step as j_make_train_step
from siggan_tpu_torch import bridge
from siggan_tpu_torch.ckpt.manager import CheckpointManager, load_generator
from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import Adam, TrainState, create_train_state
from siggan_tpu_torch.data.synthetic import generate_dataset, save_dataset_pngs
from siggan_tpu_torch.infer.generate import GeneratorSession
from siggan_tpu_torch.models.discriminator import channel_schedule as d_schedule
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.train.train_step import make_resident_train_step, make_train_step
from siggan_tpu_torch.train.trainer import GANTrainer

TINY = dict(latent_dim=16, base_features=32)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def port_cfg(jcfg: JTrainConfig) -> TrainConfig:
    return TrainConfig.from_dict(jcfg.to_dict())


def jax_masks(key, n, widths, rate=0.25):
    """The keep-masks the JAX discriminator draws from ``key``: one split
    per block, in block order."""
    masks = []
    for c in widths:
        key, sub = jax.random.split(key)
        masks.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 1.0 - rate, (n, 1, 1, c)))))
    return masks


def widths(mcfg):
    return [co for _, co in d_schedule(mcfg)]


def assert_trees_close(got, want, **tol):
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   **tol)


@pytest.mark.parametrize("packed", [False, True])
def test_discriminator_with_jax_masks_matches_apply_fn(packed):
    jcfg = JModelConfig(**TINY)
    params = np_tree(jdisc.init_fn(jax.random.key(1), jcfg)[0])
    rs = np.random.RandomState(2)
    for blk in params["blocks"]:
        blk["b"] = (rs.randn(*blk["b"].shape) * 0.1).astype(np.float32)
    x = rs.uniform(-1, 1, (6, 32, 32, 4) if packed else (6, 64, 64, 1)).astype(np.float32)
    key = jax.random.key(3, impl="threefry2x32")
    ct = rs.randn(6, 1).astype(np.float32)

    def jfwd(p, xx):
        return jdisc.apply_fn(p, {"blocks": [{}] * 4, "fc": {}}, xx, jcfg, train=True,
                              rng=key, compute_dtype=jnp.float32, packed_input=packed)[0]
    ref, vjp = jax.vjp(jfwd, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))

    cfg = port_cfg(JTrainConfig(model=jcfg))
    d = bridge.d_from_jax(params, cfg.model, "cpu")
    assert bridge.d_to_jax(d)[0]["fc"]["w"].shape == (8192, 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = d(xt, train=True, compute_dtype=torch.float32, packed_input=packed,
            masks=jax_masks(key, 6, widths(cfg.model)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    grads = torch.autograd.grad(got, [xt] + list(d.parameters()), torch.from_numpy(ct))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5)
    assert_trees_close(bridge.tensors_to_jax(d, grads[1:]), jgp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("packed", [True, False])
def test_train_mode_generator_matches_apply_fn(packed):
    jcfg = JModelConfig(**TINY)
    params, state = np_tree(jgen.init_fn(jax.random.key(4), jcfg))
    rs = np.random.RandomState(5)
    z = rs.randn(6, 16).astype(np.float32)

    def jfwd(p):
        return jgen.apply_fn(p, jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(z),
                             jcfg, train=True, compute_dtype=jnp.float32,
                             packed_output=packed)
    (ref, ref_bn), vjp = jax.vjp(jfwd, jax.tree_util.tree_map(jnp.asarray, params))
    ct = rs.randn(*ref.shape).astype(np.float32)
    (jg,) = vjp((jnp.asarray(ct), jax.tree_util.tree_map(jnp.zeros_like, ref_bn)))

    g = bridge.from_jax(params, state, port_cfg(JTrainConfig(model=jcfg)).model, "cpu")
    f0 = pt.FWD_LAUNCHES.count
    img = g(torch.from_numpy(z), None, torch.float32, train=True, packed_output=packed)
    assert pt.FWD_LAUNCHES.count == f0            # CPU tensors: the plain version
    assert img.shape == ((6, 32, 32, 4) if packed else (6, 64, 64, 1))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    assert_trees_close(bridge.to_jax(g)[1], ref_bn, rtol=1e-4, atol=1e-6)
    grads = torch.autograd.grad(img, list(g.parameters()), torch.from_numpy(ct))
    assert_trees_close(bridge.tensors_to_jax(g, grads), jg, rtol=1e-2, atol=1e-3)


def jax_opt(opt):
    """{count, m, v} of a JAX optimizer chain's Adam state."""
    inner = opt[-1]
    if isinstance(inner, dict):
        return inner
    adam = inner[0]
    return {"count": adam.count, "m": adam.mu, "v": adam.nu}


def port_state(js, cfg: TrainConfig) -> TrainState:
    g = bridge.from_jax(np_tree(js.g_params), np_tree(js.g_bn), cfg.model, "cpu")
    d = bridge.d_from_jax(np_tree(js.d_params), cfg.model, "cpu")
    mdt = getattr(torch, cfg.optim.moment_dtype)
    return TrainState(step=int(js.step), g=g, d=d,
                      g_opt=bridge.opt_from_jax(jax_opt(js.g_opt), g, mdt),
                      d_opt=bridge.opt_from_jax(jax_opt(js.d_opt), d, mdt))


def jax_draws(jcfg: JTrainConfig, step: int, b: int):
    """The latents, dropout masks and augmentation parameters the JAX step
    draws at ``step``, in the port step's ``draws`` form."""
    root = jrng.root_key(jcfg.seed, jcfg.rng_impl)
    k = jcfg.n_critic + 1
    nkeys = jax.random.split(jrng.at_step(jrng.stream(root, jrng.STREAM_NOISE), step), k)
    dkeys = jax.random.split(jrng.at_step(jrng.stream(root, jrng.STREAM_DROPOUT), step), k)
    ws = widths(jcfg.model)
    theta, scale, flip = j_augment_params(
        jrng.at_step(jrng.stream(root, jrng.STREAM_AUGMENT), step), b, hflip=jcfg.hflip)
    return {"z": [torch.from_numpy(np.array(jgen.generate_latent(nk, b, jcfg.model)))
                  for nk in nkeys],
            "masks": [jax_masks(dk, 2 * b if i < jcfg.n_critic else b, ws)
                      for i, dk in enumerate(dkeys)],
            "augment": (torch.from_numpy(np.array(theta)),
                        torch.from_numpy(np.array(scale)),
                        None if flip is None else torch.from_numpy(np.array(flip)))}


@pytest.mark.parametrize("moments,hflip", [("float32", False), ("bfloat16", True)])
def test_train_step_matches_jax_step(moments, hflip):
    jcfg = JTrainConfig(model=JModelConfig(**TINY), batch_size=4, compute_dtype="float32",
                        seed=0, rng_impl="threefry2x32", hflip=hflip,
                        optim=JOptimConfig(moment_dtype=moments))
    cfg = port_cfg(jcfg)
    assert cfg.packed_io and cfg.model.g_pack_pallas and cfg.augment
    js = j_create_train_state(jcfg)
    st = port_state(js, cfg)
    real = generate_dataset(4, 64, seed=6)
    js1, jm = jax.jit(j_make_train_step(jcfg))(js, jnp.asarray(real))
    st, m = make_train_step(cfg)(st, torch.from_numpy(real), jax_draws(jcfg, 0, 4))

    assert st.step == int(js1.step) == 1
    for k, v in m.items():
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    if moments == "float32":
        # After one step m = (1 - beta1) * grad exactly: the step's gradients.
        # D's come from the same weights on both sides; G's flow through D
        # after its sign-like first Adam step, which moves tiny-gradient
        # weights by +-2 lr where f32 rounding flips their sign: held within
        # 1 % of each tensor's largest entry (and 1e-8 for the fc bias, whose
        # gradient BatchNorm cancels to rounding noise).
        assert_trees_close(bridge.tensors_to_jax(st.d, st.d_opt["m"]),
                           jax_opt(js1.d_opt)["m"], rtol=1e-3, atol=1e-7)
        got = jax.tree_util.tree_leaves(bridge.tensors_to_jax(st.g, st.g_opt["m"]))
        for a, b in zip(got, jax.tree_util.tree_leaves(jax_opt(js1.g_opt)["m"])):
            b = np.asarray(b, np.float32)
            np.testing.assert_allclose(a, b, rtol=1e-2,
                                       atol=max(1e-2 * np.abs(b).max(), 1e-8))
    assert st.g_opt["count"] == st.d_opt["count"] == 1
    assert_trees_close(bridge.to_jax(st.g)[1], js1.g_bn, rtol=1e-4, atol=1e-6)
    # The first Adam step is sign-like: hold parameters to the drift bound.
    assert_trees_close(bridge.params_to_jax(st.g), js1.g_params, rtol=2e-3, atol=1e-3)
    assert_trees_close(bridge.params_to_jax(st.d), js1.d_params, rtol=2e-3, atol=1e-3)


def test_bridge_round_trips_discriminator_and_optimizer():
    cfg = TrainConfig(model=ModelConfig(**TINY), batch_size=4,
                      compute_dtype="float32", seed=1)
    st = create_train_state(cfg, "cpu")
    for p in st.g.parameters():
        p.grad = torch.randn(p.shape)
    Adam(1e-3, 0.5, 0.999).step(list(st.g.parameters()),
                                [p.grad for p in st.g.parameters()], st.g_opt)
    tree = bridge.opt_to_jax(st.g_opt, st.g)
    assert tree["count"] == 1 and tree["m"]["blocks"][0]["w"].shape == (4, 4, 32, 16)
    back = bridge.opt_from_jax(tree, st.g, torch.bfloat16)
    for a, b in zip(back["m"] + back["v"], st.g_opt["m"] + st.g_opt["v"]):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    d_params, d_state = bridge.d_to_jax(st.d)
    d2 = bridge.d_from_jax(d_params, cfg.model, "cpu")
    for a, b in zip(d2.parameters(), st.d.parameters()):
        assert torch.equal(a, b)
    assert d_state == {"blocks": [{}] * 4, "fc": {}}


def test_resident_step_gathers_and_warps_its_epoch_batch():
    """The resident step equals the plain step on the batch it gathers:
    the epoch's permutation slice, warped with the epoch's parameters."""
    cfg = TrainConfig(model=ModelConfig(**TINY), batch_size=4,
                      compute_dtype="float32", seed=2)
    images = torch.from_numpy(generate_dataset(8, 64, seed=7))
    fn, spe = make_resident_train_step(cfg, 8)
    assert spe == 2
    a = create_train_state(cfg, "cpu")
    b = create_train_state(cfg, "cpu")
    draws = {"z": [torch.randn(4, 16, generator=torch.Generator().manual_seed(i))
                   for i in range(2)]}
    a, ma = fn(a, images, draws)
    b, mb = fn(b, images, draws)
    for k in ma:
        assert torch.equal(ma[k], mb[k])
    for p, q in zip(a.g.parameters(), b.g.parameters()):
        assert torch.equal(p, q)
    assert a.step == 1
    with pytest.raises(NotImplementedError, match="share_fakes"):
        make_train_step(cfg.replace(share_fakes=True))


def test_trainer_and_cli_train_resume_and_serve(tmp_path, capsys):
    data = save_dataset_pngs(32, tmp_path / "data", seed=3)
    run = tmp_path / "run"
    argv = ["--data_dir", str(data), "--epochs", "2", "--batch_size", "8",
            "--compute_dtype", "float32", "--checkpoint_interval", "1",
            "--sample_interval", "1", "--run_dir", str(run), "--device", "cpu"]
    f0, b0 = pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count
    assert train_cli.main(argv) == 0
    assert (pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count) == (f0, b0)
    out = capsys.readouterr().out
    assert "Epoch 1 |" in out and "images_per_sec" in out
    idx = json.loads((run / "checkpoints" / "index.json").read_text())
    assert idx["latest"] == 1 and idx["epochs"] == [0, 1] and idx["best"] in (0, 1)
    ep = run / "checkpoints" / "epoch_0001"
    for f in ("config.json", "generator.npz", "discriminator.npz", "optimizer.npz",
              "fixed_noise.npy", "state.json"):
        assert (ep / f).exists(), f
    assert json.loads((ep / "state.json").read_text())["step"] == 8
    assert sorted(p.name for p in (run / "samples").glob("*.png"))[-1] == "epoch_0002.png"
    logs = json.loads(next((run / "logs").glob("*.json")).read_text())["metrics"]
    assert len(logs) == 2 and all(np.isfinite(m["d_loss"]) for m in logs)

    # The trained generator serves (its latest epoch) through the session.
    model, cfg = load_generator(run / "checkpoints", "cpu")
    assert cfg.compute_dtype == "float32" and cfg.batch_size == 8
    imgs = GeneratorSession(model, compute_dtype="float32", use_pallas=True,
                            device="cpu").sample(5, seed=1)
    assert imgs.shape == (5, 64, 64, 1) and np.isfinite(imgs).all()
    assert np.abs(imgs).max() <= 1.0

    # Resume: the state comes back at step 8 and one more epoch runs on it.
    state, extras = CheckpointManager(run / "checkpoints", cfg).restore("latest", "cpu")
    assert state.step == 8 and extras["epoch"] == 1 and state.g_opt["count"] == 8
    assert train_cli.main(argv[:3] + ["3"] + argv[4:] + ["--resume"]) == 0
    assert "Resumed from epoch 1 (step 8)" in capsys.readouterr().out
    assert json.loads((run / "checkpoints" / "index.json").read_text())["latest"] == 2

    # A stop file ends the run before its first epoch and saves nothing new.
    stop = tmp_path / "STOP"
    stop.touch()
    trainer = GANTrainer(cfg.replace(epochs=5), np.zeros((16, 64, 64, 1), np.float32),
                         stop_file=str(stop), device="cpu")
    assert trainer.resume("latest") and trainer.start_epoch == 3
    trainer.train()
    assert json.loads((run / "checkpoints" / "index.json").read_text())["latest"] == 2


def test_resumed_run_continues_the_uninterrupted_one(tmp_path):
    """Randomness is keyed by (seed, stream, step) and the checkpoint holds
    the whole state, so 1 epoch + resume + 1 epoch equals 2 epochs."""
    images = generate_dataset(16, 64, seed=8)

    def trainer(name, epochs):
        cfg = TrainConfig(model=ModelConfig(**TINY), batch_size=4, seed=4,
                          compute_dtype="float32", epochs=epochs, sample_interval=0,
                          checkpoint_interval=1, checkpoint_dir=str(tmp_path / name / "c"),
                          sample_dir=str(tmp_path / name / "s"),
                          log_dir=str(tmp_path / name / "l"))
        return GANTrainer(cfg, images, device="cpu")

    whole = trainer("whole", 2)
    whole.train()
    trainer("split", 1).train()
    resumed = trainer("split", 2)
    assert resumed.resume("latest") and resumed.state.step == 4
    resumed.train()
    a, b = whole.state, resumed.state
    assert a.step == b.step == 8
    for p, q in zip(list(a.g.state_dict().values()) + list(a.d.parameters())
                    + a.g_opt["m"] + a.g_opt["v"] + a.d_opt["m"] + a.d_opt["v"],
                    list(b.g.state_dict().values()) + list(b.d.parameters())
                    + b.g_opt["m"] + b.g_opt["v"] + b.d_opt["m"] + b.d_opt["v"]):
        assert torch.equal(p, q)
    assert torch.equal(whole.fixed_noise, resumed.fixed_noise)


def test_cli_refuses_without_a_card(tmp_path, monkeypatch):
    save_dataset_pngs(2, tmp_path, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--data_dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="share_fakes"):
        train_cli.main(["--data_dir", str(tmp_path), "--device", "cpu",
                        "--share_fakes", "--batch_size", "2"])
