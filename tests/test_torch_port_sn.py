"""Spectral norm and the 128 px spectral-norm GAN (v1.1) of the port against
the JAX package: ``spectral_norm`` (train and eval, the new ``u``, the
gradient through sigma), the 128 px spectral-norm discriminator on injected
dropout masks, one whole 128 px train step on the JAX step's own draws, and
D's spectral-norm state through the bridge, checkpoints and resume.

Tolerances are stated at each comparison: f32, sums in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.core.state import create_train_state as j_create_train_state
from siggan_tpu.models import discriminator as jdisc
from siggan_tpu.ops.regularizers import sn_init as j_sn_init
from siggan_tpu.ops.regularizers import spectral_norm as j_spectral_norm
from siggan_tpu.train.train_step import make_train_step as j_make_train_step
from siggan_tpu_torch import bridge
from siggan_tpu_torch.ckpt.manager import CheckpointManager, load_generator
from siggan_tpu_torch.cli import train as train_cli
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import TrainState, create_train_state
from siggan_tpu_torch.data.synthetic import generate_dataset
from siggan_tpu_torch.infer.generate import GeneratorSession
from siggan_tpu_torch.models.discriminator import Discriminator
from siggan_tpu_torch.models.generator import fused_tail_supported, tail_start
from siggan_tpu_torch.ops.regularizers import sn_init, spectral_norm
from siggan_tpu_torch.train.train_step import make_train_step
from siggan_tpu_torch.train.trainer import GANTrainer, check_trainer_supported
from test_torch_port_train import (assert_trees_close, jax_draws, jax_masks, jax_opt,
                                   np_tree, port_cfg, widths)

V11 = dict(image_size=128, base_features=32, latent_dim=16, use_spectral_norm=True)


def to_port(w: np.ndarray) -> torch.Tensor:
    """A JAX weight (HWIO conv or (in, out) linear) in the port's layout."""
    t = torch.from_numpy(w)
    return t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()


def to_jax(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(2, 3, 1, 0) if t.ndim == 4 else t.t()).numpy()


@pytest.mark.parametrize("shape", [(4, 4, 8, 16), (512, 1)])
@pytest.mark.parametrize("train", [True, False])
def test_spectral_norm_matches_jax(shape, train):
    rs = np.random.RandomState(len(shape))
    w = (rs.randn(*shape) * 0.1).astype(np.float32)
    u0 = rs.randn(shape[-1]).astype(np.float32)
    u0 /= np.linalg.norm(u0)
    c = rs.randn(*shape).astype(np.float32)

    def f(wj):
        w_sn, st = j_spectral_norm(wj, {"u": jnp.asarray(u0)}, train=train)
        return jnp.sum(w_sn * c), (w_sn, st["u"])
    (_, (wsn_j, u_j)), g_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(w))

    wt = to_port(w).requires_grad_(True)
    wsn, u = spectral_norm(wt, torch.from_numpy(u0), train=train)
    (g,) = torch.autograd.grad((wsn * to_port(c)).sum(), [wt])
    # rtol 1e-4 / atol 1e-6: f32 matrix-vector products summed in another order.
    np.testing.assert_allclose(to_jax(wsn), np.asarray(wsn_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(to_jax(g), np.asarray(g_j), rtol=1e-4, atol=1e-5)
    assert not u.requires_grad
    if not train:
        np.testing.assert_array_equal(u.numpy(), u0)


def test_sn_init_is_the_jax_unit_vector():
    np.testing.assert_array_equal(sn_init(7).numpy(), np.asarray(j_sn_init(7)["u"]))


@pytest.mark.parametrize("packed", [False, True])
def test_sn_discriminator_128_matches_apply_fn(packed):
    jcfg = JModelConfig(**V11)
    params, state = np_tree(jdisc.init_fn(jax.random.key(1), jcfg))
    rs = np.random.RandomState(2)
    for layer in params["blocks"] + [params["fc"]]:
        layer["b"] = (rs.randn(*layer["b"].shape) * 0.1).astype(np.float32)
    for st in state["blocks"] + [state["fc"]]:      # a u away from e_0
        u = rs.randn(*st["u"].shape).astype(np.float32)
        st["u"] = u / np.linalg.norm(u)
    x = rs.uniform(-1, 1, (3, 64, 64, 4) if packed else (3, 128, 128, 1)).astype(np.float32)
    key = jax.random.key(3, impl="threefry2x32")
    ct = rs.randn(3, 1).astype(np.float32)

    def jfwd(p, xx):
        return jdisc.apply_fn(p, state, xx, jcfg, train=True, rng=key,
                              compute_dtype=jnp.float32, packed_input=packed)
    (ref, new_state), vjp = jax.vjp(jfwd, jax.tree_util.tree_map(jnp.asarray, params),
                                    jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(ct), jax.tree_util.tree_map(jnp.zeros_like, new_state)))

    cfg = port_cfg(JTrainConfig(model=jcfg)).model
    d = bridge.d_from_jax(params, cfg, "cpu", d_state=state)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = d(xt, train=True, compute_dtype=torch.float32, packed_input=packed,
            masks=jax_masks(key, 3, widths(cfg)))
    # Logits and gradients rtol 1e-4 / atol 1e-5 (f32, another summation
    # order); the new u's rtol 1e-5 / atol 1e-6 (one power iteration).
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    assert_trees_close(bridge.d_to_jax(d)[1], new_state, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(got, [xt] + list(d.parameters()), torch.from_numpy(ct))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5)
    assert_trees_close(bridge.tensors_to_jax(d, grads[1:]), jgp, rtol=1e-4, atol=1e-5)

    # Eval mode leaves the u's as they are.
    before = [t.clone() for t in d.buffers()]
    with torch.no_grad():
        d(xt, train=False, compute_dtype=torch.float32, packed_input=packed)
    assert all(torch.equal(a, b) for a, b in zip(before, d.buffers()))


def port_state(js, cfg: TrainConfig) -> TrainState:
    g = bridge.from_jax(np_tree(js.g_params), np_tree(js.g_bn), cfg.model, "cpu")
    d = bridge.d_from_jax(np_tree(js.d_params), cfg.model, "cpu",
                          d_state=np_tree(js.d_state))
    mdt = getattr(torch, cfg.optim.moment_dtype)
    return TrainState(step=int(js.step), g=g, d=d,
                      g_opt=bridge.opt_from_jax(jax_opt(js.g_opt), g, mdt),
                      d_opt=bridge.opt_from_jax(jax_opt(js.d_opt), d, mdt))


def test_train_step_128_sn_matches_jax_step():
    """One v1.1 step (128 px, spectral norm) on the JAX step's own latents,
    dropout masks and augmentation draws, to the bars of the 64 px step
    test; D's u's advance twice (D step, then G step) on both sides."""
    jcfg = JTrainConfig(model=JModelConfig(**V11), batch_size=2, compute_dtype="float32",
                        seed=0, rng_impl="threefry2x32")
    cfg = port_cfg(jcfg)
    assert fused_tail_supported(cfg.model)
    js = j_create_train_state(jcfg)
    st = port_state(js, cfg)
    u0 = [t.clone() for t in st.d.buffers()]
    real = generate_dataset(2, 128, seed=6)
    js1, jm = jax.jit(j_make_train_step(jcfg))(js, jnp.asarray(real))
    st, m = make_train_step(cfg)(st, torch.from_numpy(real), jax_draws(jcfg, 0, 2))

    assert st.step == int(js1.step) == 1
    for k, v in m.items():
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    # u after the step, rtol 1e-5 / atol 1e-6 of the unit vector: its second
    # iteration reads D after the Adam update, whose entries drift by f32
    # rounding, so entries near zero carry an absolute error of ~5e-7.
    assert_trees_close(bridge.d_to_jax(st.d)[1], js1.d_state, rtol=1e-5, atol=1e-6)
    # Every block's u moved (the head's is the 1-vector [1] for good).
    assert not any(torch.equal(a, b) for a, b in zip(u0[:-1], list(st.d.buffers())[:-1]))
    assert_trees_close(bridge.to_jax(st.g)[1], js1.g_bn, rtol=1e-4, atol=1e-6)
    # The first Adam step is sign-like: hold parameters to the drift bound.
    assert_trees_close(bridge.params_to_jax(st.g), js1.g_params, rtol=2e-3, atol=1e-3)
    assert_trees_close(bridge.params_to_jax(st.d), js1.d_params, rtol=2e-3, atol=1e-3)


def test_sn_state_round_trips_bridge_and_checkpoint(tmp_path):
    cfg = TrainConfig(model=ModelConfig(**V11), batch_size=2, compute_dtype="float32",
                      seed=1, checkpoint_dir=str(tmp_path))
    st = create_train_state(cfg, "cpu")
    assert [tuple(b.u.shape) for b in st.d.blocks] == [(c,) for c in (64, 128, 256, 512, 512)]
    assert torch.equal(st.d.fc.u, torch.ones(1))
    st, _ = make_train_step(cfg)(st, torch.from_numpy(generate_dataset(2, 128, seed=2)))
    params, state = bridge.d_to_jax(st.d)
    assert state["fc"]["u"].shape == (1,) and state["blocks"][4]["u"].shape == (512,)
    d2 = bridge.d_from_jax(params, cfg.model, "cpu", d_state=state)
    for a, b in zip(list(d2.parameters()) + list(d2.buffers()),
                    list(st.d.parameters()) + list(st.d.buffers())):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="d_state"):
        bridge.d_from_jax(params, cfg.model, "cpu")

    mgr = CheckpointManager(tmp_path, cfg)
    mgr.save(st, epoch=0, fixed_noise=torch.zeros(2, 16))
    back, _ = mgr.restore("latest", "cpu")
    for b0, b1 in zip(st.d.buffers(), back.d.buffers()):
        assert torch.equal(b0, b1)
    for u in back.d.buffers():
        assert abs(float(torch.linalg.vector_norm(u)) - 1.0) < 1e-5


def test_resumed_sn_run_continues_the_uninterrupted_one(tmp_path):
    images = generate_dataset(4, 128, seed=8)

    def trainer(name, epochs):
        cfg = TrainConfig(model=ModelConfig(**V11), batch_size=2, seed=4,
                          compute_dtype="float32", epochs=epochs, sample_interval=0,
                          checkpoint_interval=1, checkpoint_dir=str(tmp_path / name / "c"),
                          sample_dir=str(tmp_path / name / "s"),
                          log_dir=str(tmp_path / name / "l"))
        return GANTrainer(cfg, images, device="cpu")

    whole = trainer("whole", 2)
    whole.train()
    trainer("split", 1).train()
    resumed = trainer("split", 2)
    assert resumed.resume("latest") and resumed.state.step == 2
    resumed.train()
    a, b = whole.state, resumed.state
    assert a.step == b.step == 4
    for p, q in zip(list(a.g.state_dict().values()) + list(a.d.state_dict().values()),
                    list(b.g.state_dict().values()) + list(b.d.state_dict().values())):
        assert torch.equal(p, q)
    assert len(a.d.state_dict()) == 2 * 6 + 6       # weights, biases and u's

    # The 128 px checkpoint serves through the module path (the generator
    # kernel B4 is 64 px only).
    model, cfg = load_generator(tmp_path / "split" / "c", "cpu")
    session = GeneratorSession(model, compute_dtype="float32", use_pallas=True, device="cpu")
    imgs = session.sample(3, seed=1)
    assert not session.uses_kernel and cfg.model.image_size == 128
    assert imgs.shape == (3, 128, 128, 1) and np.isfinite(imgs).all()
    assert np.abs(imgs).max() <= 1.0


def test_discriminator_without_sn_has_no_state():
    d = Discriminator(ModelConfig(latent_dim=16))
    assert list(d.buffers()) == []
    assert bridge.d_to_jax(d)[1] == {"blocks": [{}] * 4, "fc": {}}


def test_cli_builds_the_v11_configuration():
    """``--image_size 128 --spectral_norm`` reaches the trainer as v1.1 at
    full width (base features 256, so G's stem is 512) and is supported."""
    args = train_cli.parse_arguments(["--data_dir", "d", "--image_size", "128",
                                      "--spectral_norm", "--device", "cpu"])
    cfg = train_cli.build_config(args)
    assert cfg.model.image_size == 128 and cfg.model.use_spectral_norm
    assert cfg.model.base_features == 256 and cfg.packed_io
    check_trainer_supported(cfg, np.zeros((8, 128, 128, 1), np.float32))
    assert fused_tail_supported(cfg.model) and tail_start(cfg.model) == 2
    # Conditional models train too now; the profiler hook still raises.
    check_trainer_supported(cfg.replace(model=dataclasses.replace(cfg.model, num_classes=3)),
                            np.zeros((8, 128, 128, 1), np.float32))
    with pytest.raises(NotImplementedError, match="profiler"):
        check_trainer_supported(cfg.replace(profile_dir="trace"),
                                np.zeros((8, 128, 128, 1), np.float32))
