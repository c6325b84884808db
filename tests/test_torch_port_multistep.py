"""The K-step resident dispatch (``make_resident_multi_step``) and what it
needed: the trainer's choice of K against the JAX trainer's, the step's
draws written into the graph route's buffers, and Adam's device count and
bias corrections against optax / ``adam_low_mem``; and the helpers of the
dispatch's step tests (``test_torch_port_multistep_epoch.py``: K steps per
call against K resident steps over an epoch boundary;
``test_torch_port_multistep_graph.py``: the graph route's buffers replayed
on the CPU with each capture replaced by a direct call of the step it
would capture)."""

import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.core.state import adam_low_mem as j_adam_low_mem
from siggan_tpu.train import trainer as jtrainer
from siggan_tpu_torch import bridge
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.state import Adam, create_train_state
from siggan_tpu_torch.train.train_step import (make_resident_train_step, state_tensors,
                                               step_draws, Streams)
from siggan_tpu_torch.train.trainer import choose_scan_steps

TINY = dict(latent_dim=16, base_features=32)


def jax_scan_steps(monkeypatch, tmp_path, spe: int, scan_steps: int) -> int:
    """K as the JAX GANTrainer picks it for ``spe`` steps per epoch (batch
    1, its train state and multi-step stubbed out)."""
    seen = {}

    def multi_step(cfg, n_images, k, batch_sharding=None):
        seen["k"] = k
        return (lambda *a: None), n_images // cfg.batch_size

    monkeypatch.setattr(jtrainer, "make_resident_multi_step", multi_step)
    monkeypatch.setattr(jtrainer, "create_train_state", lambda cfg: None)
    cfg = JTrainConfig(model=JModelConfig(**TINY), batch_size=1, scan_steps=scan_steps,
                       checkpoint_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"),
                       sample_dir=str(tmp_path / "s"))
    jtrainer.GANTrainer(cfg, np.zeros((spe, 1, 1, 1), np.float32), use_mesh=False)
    return seen["k"]


@pytest.mark.parametrize("spe,scan_steps",
                         [(s, 0) for s in (1, 7, 13, 32, 48, 64, 97, 128, 200)]
                         + [(32, 8), (48, 16), (7, 7), (32, 5), (97, 3)])
def test_scan_steps_rule_matches_the_jax_trainer(spe, scan_steps, monkeypatch, tmp_path):
    if scan_steps and spe % scan_steps:
        with pytest.raises(ValueError, match="must divide"):
            jax_scan_steps(monkeypatch, tmp_path, spe, scan_steps)
        with pytest.raises(ValueError, match="must divide"):
            choose_scan_steps(spe, scan_steps)
        return
    assert choose_scan_steps(spe, scan_steps) == jax_scan_steps(monkeypatch, tmp_path, spe,
                                                                scan_steps)


def tiny_cfg(**kw):
    return TrainConfig(model=ModelConfig(**TINY), batch_size=4, compute_dtype="float32",
                       **kw)


def assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)


def eager_run(cfg, images, state, steps):
    fn, _ = make_resident_train_step(cfg, len(images))
    ms = []
    for _ in range(steps):
        state, m = fn(state, images)
        ms.append(m)
    return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def windows(fn, state, images, n):
    ms = []
    for _ in range(n):
        state, m = fn(state, images)
        ms.append(m)
    return state, {k: torch.cat([m[k] for m in ms]) for k in ms[0]}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the CPU train steps of the files that use
    it: the suite runs files in parallel workers, and a full-width pool in
    each oversubscribes the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def uncaptured(multi):
    """The graph route of ``multi`` on the CPU, each capture replaced by a
    graph whose replay calls the step it would have captured."""
    g = multi.graphed

    def capture(state):
        g.graph = types.SimpleNamespace(replay=lambda: g._step(state))
        g.capture_s = 0.0

    g._capture = capture
    return g


def test_step_draws_fill_buffers_with_the_eager_numbers():
    cfg = tiny_cfg(seed=2, hflip=True)
    fresh = step_draws(cfg, Streams(cfg.seed, "cpu"), 5, 4, "cpu")
    out = {"z": [torch.empty_like(t) for t in fresh["z"]],
           "u": [[torch.empty_like(t) for t in ui] for ui in fresh["u"]],
           "augment": tuple(torch.empty_like(t) for t in fresh["augment"])}
    step_draws(cfg, Streams(cfg.seed, "cpu"), 5, 4, "cpu", out=out)
    for x, y in zip(fresh["z"] + sum(fresh["u"], []) + list(fresh["augment"]),
                    out["z"] + sum(out["u"], []) + list(out["augment"])):
        assert torch.equal(x, y)
    assert [t.shape for t in fresh["u"][0]] == [(8, 1, 1, c) for c in (64, 128, 256, 512)]
    assert [t.shape for t in fresh["u"][1]] == [(4, 1, 1, c) for c in (64, 128, 256, 512)]


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_adam_device_count_matches_jax_over_many_steps(moments):
    """The count is an int32 tensor on the parameters' device and the bias
    corrections f32 device values; 300 updates stay on JAX's trajectory
    (b2 = 0.999 is where a host numpy power rounds differently)."""
    rs = np.random.RandomState(9)
    shapes = [(3, 4), (5,)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    tx = (j_adam_low_mem(2e-4, 0.5, 0.999) if moments == "bfloat16"
          else optax.adam(2e-4, b1=0.5, b2=0.999, eps=1e-8))
    update = jax_jit_update(tx)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    port = Adam(2e-4, 0.5, 0.999, 1e-8, moments)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = port.init(tp)
    assert ts["count"].dtype == torch.int32 and ts["count"].device == tp[0].device
    for _ in range(300):
        g = [rs.randn(*s).astype(np.float32) * 1e-2 for s in shapes]
        jp, js = update(jp, js, [jnp.asarray(x) for x in g])
        port.step(tp, [torch.from_numpy(x) for x in g], ts)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    assert int(ts["count"]) == 300 and ts["count"].dtype == torch.int32


def jax_jit_update(tx):
    import jax

    @jax.jit
    def update(params, state, grads):
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state
    return update


def test_optimizer_bridge_keeps_the_count_on_disk_as_an_integer():
    cfg = tiny_cfg(seed=1)
    st = create_train_state(cfg, "cpu")
    st.g_opt["count"].fill_(7)
    tree = bridge.opt_to_jax(st.g_opt, st.g)
    assert isinstance(tree["count"], np.int32) and tree["count"] == 7
    back = bridge.opt_from_jax(tree, st.g, torch.bfloat16)
    assert back["count"].dtype == torch.int32 and int(back["count"]) == 7
