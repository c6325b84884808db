"""The fused generator forwards (``fuse_g_forwards``) of the port against the
JAX package: grouped BatchNorm (``ops/norm.py`` ``groups=``), the
generator's ``bn_groups``, one whole fused step against JAX's
``fused_iteration`` on its own draws, the fused step against the port's
sequential step on the same draws, and the resident, graph-buffer and
streamed routes against ``make_train_step``.

Bars: BatchNorm and the generator's outputs and running statistics at f32
rtol 1e-4 / atol 1e-5, their gradients as
``test_torch_port_train.py::test_train_mode_generator_matches_apply_fn``
holds the generator's (rtol 1e-2 / atol 1e-3; BN over 4 rows a group);
the whole step as ``test_torch_port_share_fakes.py`` holds the shared-fake
step (rtol 1e-4 / atol 1e-5, metrics atol 1e-6, Adam's moments at 1e-3 of
each tensor's largest entry); fused against sequential at the JAX
package's own bars (``tests/test_train_step.py``: 2e-5 at n_critic 1, 5e-4
at n_critic 2 and conditional). The learning rates are 1e-6 (v2.0's 1e-6 /
2e-6): Adam's first steps are sign-like, so a gradient that rounding puts
on the other side of zero moves its weight by 2 lr, and at the default
2e-4 that alone is 4e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.core.state import create_train_state as j_create_train_state
from siggan_tpu.models import generator as jgen
from siggan_tpu.ops import norm as jnorm
from siggan_tpu.train.train_step import make_train_step as j_make_train_step
from siggan_tpu_torch import bridge
from siggan_tpu_torch.core.config import ModelConfig, OptimConfig, TrainConfig
from siggan_tpu_torch.core.state import create_train_state
from siggan_tpu_torch.data.loader import BatchLoader
from siggan_tpu_torch.data.synthetic import generate_dataset, generate_labeled_dataset
from siggan_tpu_torch.ops import norm
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.train.train_step import (Streams, _epoch_tables, _keep_masks,
                                               make_resident_multi_step,
                                               make_resident_train_step, make_stream_step,
                                               make_train_step, state_tensors, step_draws)
from test_torch_port_dp import batch_of as dp_batch_of
from test_torch_port_dp import draws_of as dp_draws_of
from test_torch_port_dp import jcfg_of as dp_jcfg
from test_torch_port_dp import port_state_of as dp_port_state_of
from test_torch_port_multistep import few_threads  # noqa: F401  (autouse)
from test_torch_port_multistep import assert_states_equal, eager_run, uncaptured, windows
from test_torch_port_schedule_ema import jax_draws_v20, v20_jcfg
from test_torch_port_share_fakes import port_state
from test_torch_port_train import TINY, assert_trees_close, jax_opt, np_tree, port_cfg

TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-6


# -- grouped BatchNorm ---------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("groups,conditional", [(2, False), (3, False), (3, True)])
def test_grouped_batch_norm_matches_jax(packed, groups, conditional):
    """Per-group statistics, the running estimate folded group by group,
    the per-row affine of conditional BN; outputs, state and gradients."""
    rs = np.random.RandomState(groups + 10 * packed + 100 * conditional)
    n, c = 4 * groups, 6
    shape = (n, 3, 5, 4 * c) if packed else (n, 4, 4, c)
    x = (rs.randn(*shape) * 1.5 + rs.randn(*shape[-1:]) * 0.5).astype(np.float32)
    aff = (n, c) if conditional else (c,)
    scale = (1 + 0.1 * rs.randn(*aff)).astype(np.float32)
    offset = (0.1 * rs.randn(*aff)).astype(np.float32)
    state = {"mean": (0.1 * rs.randn(c)).astype(np.float32),
             "var": (1 + 0.1 * rs.rand(c)).astype(np.float32)}
    ct = rs.randn(*shape).astype(np.float32)
    jfn = jnorm.batch_norm_packed if packed else jnorm.batch_norm

    def jfwd(xx, a, b):
        return jfn(xx, a, b, jax.tree_util.tree_map(jnp.asarray, state), train=True,
                   groups=groups)
    (ref, ref_state), vjp = jax.vjp(jfwd, jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(offset))
    jgrads = vjp((jnp.asarray(ct), jax.tree_util.tree_map(jnp.zeros_like, ref_state)))

    tfn = norm.batch_norm_packed if packed else norm.batch_norm
    xt, st, ot = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, offset))
    y, new_state = tfn(xt, st, ot, {k: torch.from_numpy(v) for k, v in state.items()},
                       train=True, groups=groups)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[k].numpy(), np.asarray(ref_state[k]), **TOL)
    grads = torch.autograd.grad(y, [xt, st, ot], torch.from_numpy(ct))
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_grouped_batch_norm_is_a_loop_of_calls():
    """Each group's rows are what a call on that group alone gives, and the
    state is that of the calls made in order."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(9, 4, 4, 5).astype(np.float32))
    scale, offset = torch.rand(5) + 0.5, torch.randn(5)
    state = norm.init_state(5)
    y, got = norm.batch_norm(x, scale, offset, state, train=True, groups=3)
    for i in range(3):
        yi, state = norm.batch_norm(x[3 * i:3 * i + 3], scale, offset, state, train=True)
        np.testing.assert_allclose(y[3 * i:3 * i + 3].numpy(), yi.numpy(), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k].numpy(), state[k].numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="does not split into 2 groups"):
        norm.batch_norm(x, scale, offset, state, train=True, groups=2)


# -- the generator's bn_groups ------------------------------------------------

@pytest.mark.parametrize("conditioning,packed", [(None, True), (None, False),
                                                 ("full", True), ("concat", True)])
def test_generator_bn_groups_matches_apply_fn(conditioning, packed):
    mkw = dict(TINY) if conditioning is None else dict(num_classes=3,
                                                       g_conditioning=conditioning, **TINY)
    jcfg = JModelConfig(**mkw)
    params, state = np_tree(jgen.init_fn(jax.random.key(4), jcfg))
    rs = np.random.RandomState(5)
    for bn in [params["fc_bn"]] + [b["bn"] for b in params["blocks"]]:
        bn["offset"] = (0.1 * rs.randn(*bn["offset"].shape)).astype(np.float32)
    k, b = 3, 4
    z = rs.randn(k * b, 16).astype(np.float32)
    y = None if conditioning is None else rs.randint(0, 3, k * b)

    def jfwd(p):
        return jgen.apply_fn(p, jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(z),
                             jcfg, train=True, compute_dtype=jnp.float32,
                             packed_output=packed, y=None if y is None else jnp.asarray(y),
                             bn_groups=k)
    (ref, ref_bn), vjp = jax.vjp(jfwd, jax.tree_util.tree_map(jnp.asarray, params))
    ct = rs.randn(*ref.shape).astype(np.float32)
    (jg,) = vjp((jnp.asarray(ct), jax.tree_util.tree_map(jnp.zeros_like, ref_bn)))

    g = bridge.from_jax(params, state, port_cfg(JTrainConfig(model=jcfg)).model, "cpu")
    f0 = pt.FWD_LAUNCHES.count
    img = g(torch.from_numpy(z), None if y is None else torch.from_numpy(y).long(),
            torch.float32, train=True, packed_output=packed, bn_groups=k)
    assert pt.FWD_LAUNCHES.count == f0            # CPU tensors: the plain version
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref), **TOL)
    assert_trees_close(bridge.to_jax(g)[1], ref_bn, rtol=1e-4, atol=1e-6)
    grads = torch.autograd.grad(img, list(g.parameters()), torch.from_numpy(ct))
    assert_trees_close(bridge.tensors_to_jax(g, grads), jg, rtol=1e-2, atol=1e-3)


def test_fused_tail_refuses_groups():
    """Kernel B2 computes one group's statistics over the whole batch."""
    cfg = TrainConfig(model=ModelConfig(**TINY), compute_dtype="float32")
    g = create_train_state(cfg, "cpu").g
    with torch.no_grad(), pytest.raises(ValueError, match="bn_groups > 1"):
        g(torch.randn(8, 16), None, torch.float32, train=True, packed_output=True,
          fused_tail=True, bn_groups=2)


# -- the fused step against JAX's fused_iteration ----------------------------

def fused_jcfg(case: str) -> JTrainConfig:
    if case == "v20_aux":
        return v20_jcfg("float32", True).replace(fuse_g_forwards=True)
    return dp_jcfg("default").replace(fuse_g_forwards=True,
                                      n_critic=2 if case == "n_critic2" else 1)


@pytest.mark.parametrize("case", ["n_critic1", "n_critic2", "v20_aux"])
def test_fused_step_matches_jax_fused_iteration(case):
    """Two fused steps of the port against JAX's on JAX's draws: the
    default 64 px model with dropout, hflip and all three DiffAugment
    policies at batch 8 (``test_torch_port_dp.py``'s configuration) at
    n_critic 1 and 2, and v2.0 with the AC-GAN head at batch 4. Adam's
    moments: 1e-3 of each tensor's largest entry, except at n_critic 2,
    where D's moments after its fourth update are held to 2e-2: there the
    port's sequential step misses JAX's sequential step by the same 1.07 %
    (D's second block, whose gradient is small), on these inputs."""
    jcfg = fused_jcfg(case)
    cfg = port_cfg(jcfg)
    assert cfg.fuse_g_forwards and cfg.packed_io and cfg.model.g_pack_pallas
    if jcfg.model.num_classes:
        images, labels = generate_labeled_dataset(3, 3, 64, seed=2)
        real, y = images[[0, 3, 6, 1]], labels[[0, 3, 6, 1]]
        st = port_state(j_create_train_state(jcfg), cfg)

        def draws_of(step):
            return jax_draws_v20(jcfg, step, 4)
    else:
        (real, y), st = dp_batch_of("default"), dp_port_state_of(jcfg, cfg)

        def draws_of(step):
            return dp_draws_of(jcfg, step)
    js = j_create_train_state(jcfg)
    j_step, t_step = jax.jit(j_make_train_step(jcfg)), make_train_step(cfg)
    yt = None if y is None else torch.from_numpy(y)
    for step in range(2):
        js, jm = j_step(js, *([jnp.asarray(real)] + ([] if y is None else [jnp.asarray(y)])))
        st, m = t_step(st, torch.from_numpy(real), draws_of(step), yt)
        assert set(m) == set(jm), set(m) ^ set(jm)
        for k, v in m.items():
            np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{step} {k}")
    assert st.step == int(js.step) == 2
    assert_trees_close(bridge.params_to_jax(st.g), js.g_params, **TOL)
    assert_trees_close(bridge.params_to_jax(st.d), js.d_params, **TOL)
    assert_trees_close(bridge.to_jax(st.g)[1], js.g_bn, **TOL)
    assert_trees_close(bridge.d_to_jax(st.d)[1], js.d_state, **TOL)
    if jcfg.ema_decay > 0:
        assert_trees_close(bridge.ema_to_jax(st.g_ema), js.g_ema, **TOL)
    for opt, jopt, model in ((st.g_opt, js.g_opt, st.g), (st.d_opt, js.d_opt, st.d)):
        j = jax_opt(jopt)
        updates = 2 * (jcfg.n_critic if model is st.d else 1)
        assert int(opt["count"]) == int(j["count"]) == updates
        bar = 2e-2 if updates == 4 else 1e-3
        for k, floor in (("m", 1e-8), ("v", 1e-16)):
            got = jax.tree_util.tree_leaves(bridge.tensors_to_jax(model, opt[k]))
            for a, b in zip(got, jax.tree_util.tree_leaves(j[k])):
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a, b, rtol=1e-3,
                                           atol=max(bar * np.abs(b).max(), floor))


# -- fused against the port's sequential step --------------------------------

def own_cfg(case: str) -> TrainConfig:
    model = ModelConfig(**TINY)
    extra = {}
    if case == "conditional":
        model = ModelConfig(num_classes=3, g_conditioning="full", aux_classifier=True, **TINY)
        extra = dict(aux_weight=0.5, diffaugment="translation,cutout", ema_decay=0.9)
    return TrainConfig(model=model, batch_size=16, compute_dtype="float32", seed=1,
                       n_critic=2 if case == "n_critic2" else 1, log_grad_norms=True,
                       optim=OptimConfig(moment_dtype="float32", d_lr=LR, g_lr=LR), **extra)


@pytest.mark.parametrize("case,tol", [("n_critic1", 2e-5), ("n_critic2", 5e-4),
                                      ("conditional", 5e-4)])
def test_fused_step_matches_the_sequential_step(case, tol):
    """Two steps of each mode from one state on the same draws (JAX's
    ``test_fused_g_forwards_equals_sequential`` at the port's batch 16)."""
    cfg = own_cfg(case)
    a = create_train_state(cfg, "cpu")
    b = copy.deepcopy(a)
    real = torch.from_numpy(generate_dataset(16, 64, seed=1))
    y = torch.arange(16) % 3 if cfg.model.num_classes else None
    seq, fused = make_train_step(cfg), make_train_step(cfg.replace(fuse_g_forwards=True))
    for step in range(2):
        draws = step_draws(cfg, Streams(1, "cpu"), step, 16, "cpu")
        draws["masks"] = _keep_masks(cfg, draws.pop("u"))
        a, ma = seq(a, real, draws, y)
        b, mb = fused(b, real, draws, y)
        assert set(ma) == set(mb)
        for k in ma:
            np.testing.assert_allclose(float(mb[k]), float(ma[k]), rtol=tol, atol=tol,
                                       err_msg=f"{step} {k}")
    for x, w in zip(state_tensors(b), state_tensors(a)):
        np.testing.assert_allclose(x.detach().float().numpy(), w.detach().float().numpy(),
                                   rtol=tol, atol=tol)


# -- every route of the trainer -----------------------------------------------

def route_cfg(**kw) -> TrainConfig:
    return TrainConfig(model=ModelConfig(**TINY), batch_size=4, compute_dtype="float32",
                       seed=6, fuse_g_forwards=True, **kw)


def test_resident_route_equals_make_train_step():
    """The resident step is ``make_train_step`` on the rows of the epoch's
    permutation it gathers."""
    cfg = route_cfg(augment=False, n_critic=2)
    images = torch.from_numpy(generate_dataset(8, 64, seed=7))
    res, spe = make_resident_train_step(cfg, 8)
    plain = make_train_step(cfg)
    a, b = create_train_state(cfg, "cpu"), create_train_state(cfg, "cpu")
    for step in range(3):
        perm, _ = _epoch_tables(cfg, 8, step // spe, "cpu")
        rows = perm[(step % spe) * 4:(step % spe + 1) * 4]
        a, ma = res(a, images)
        b, mb = plain(b, images[rows])
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    assert_states_equal(a, b)


@pytest.mark.parametrize("k,overrides", [(4, dict(hflip=True)), (2, dict(n_critic=2))])
def test_graph_route_buffers_reproduce_eager_fused_steps(k, overrides):
    """The K-step graph route's buffers (captures replaced by direct calls
    of the step they would capture) over two epochs, bit-equal to eager
    resident steps."""
    cfg = route_cfg(**overrides)
    images = torch.from_numpy(generate_dataset(16, 64, seed=7))
    multi, _ = make_resident_multi_step(cfg, 16, k)
    graphed = uncaptured(multi)
    a, got = windows(graphed, create_train_state(cfg, "cpu"), images, 8 // k)
    assert graphed.graph is not None
    b, want = eager_run(cfg, images, create_train_state(cfg, "cpu"), 8)
    assert_states_equal(a, b)
    for key, v in want.items():
        assert torch.equal(got[key], v), key


def test_streamed_route_equals_make_train_step():
    cfg = route_cfg(n_critic=2)
    images = generate_dataset(12, 64, seed=9)
    loader = BatchLoader(images, batch_size=4, seed=cfg.seed, device="cpu")
    stream, plain = make_stream_step(cfg), make_train_step(cfg)
    a, b = create_train_state(cfg, "cpu"), create_train_state(cfg, "cpu")
    for batch in loader.epoch(0):
        a, ma = stream(a, batch)
        b, mb = plain(b, batch)
        for k in ma:
            assert torch.equal(ma[k], mb[k].reshape(1)), k
    assert a.step == 3
    assert_states_equal(a, b)
