"""Data parallelism (``parallel/mesh.py``) on the CPU: gloo ranks spawned
through the port's launcher against the JAX step on the conftest's
8-device mesh and against the port's one-process step at the same global
batch.

Each rank is a spawned process (2 torch threads) that imports neither JAX
nor ``siggan_tpu`` (``torch_port_dp_worker``); two jobs run per module, one
of 2 ranks (every case) and one of 4 (the default step), on free ports.
The steps run with dropout and DiffAugment, so each rank's rows of a D
step's ``[real; fake]`` masks and DiffAugment parameters are exercised,
on the JAX package's exact draws made for the global batch.

Tolerances (f32): rtol 1e-4 / atol 1e-5 on losses, G's BN running
statistics, parameters, spectral-norm vectors and (against the port's own
one-process step) Adam's moments. The learning rates are 1/100 of the
defaults, as in ``test_torch_port_schedule_ema.py``: Adam's first steps are
sign-like, so a gradient that rounding puts on the other side of zero
moves its weight by 2 lr. Against the JAX step the moments keep that
file's bar (1e-3 of each tensor's largest entry): they are the gradients
themselves, whose f32 sums JAX and PyTorch take in other orders.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from siggan_tpu.core.config import MeshConfig as JMeshConfig
from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.core.config import OptimConfig as JOptimConfig
from siggan_tpu.core.config import TrainConfig as JTrainConfig
from siggan_tpu.core.state import create_train_state as j_create_train_state
from siggan_tpu.ops.pallas.train_tail import tail_forward_train as j_tail_forward_train
from siggan_tpu.parallel.mesh import make_mesh as j_make_mesh
from siggan_tpu.parallel.mesh import replicate as j_replicate
from siggan_tpu.train.train_step import make_train_step as j_make_train_step
from siggan_tpu_torch import bridge
from siggan_tpu_torch.core.config import MeshConfig, TrainConfig
from siggan_tpu_torch.data.synthetic import generate_dataset, generate_labeled_dataset
from siggan_tpu_torch.ops.kernels import pack_tail as pt
from siggan_tpu_torch.parallel.mesh import DataMesh, make_mesh, spawn
from siggan_tpu_torch.train.train_step import (make_resident_train_step, make_train_step,
                                               state_tensors)
import torch_port_dp_worker
from test_torch_port_multistep import few_threads  # noqa: F401  (autouse)
from test_torch_port_schedule_ema import jax_draws_v20, port_state
from test_torch_port_train import TINY, jax_draws, jax_opt, port_cfg
from test_torch_port_train_tail import jax_model

TOL = dict(rtol=1e-4, atol=1e-5)
B = 8
STEPS = 2


def jcfg_of(kind: str) -> JTrainConfig:
    """The default 64 px model with all three DiffAugment policies, or a
    v2.0-style conditional model (concat conditioning, SN, AC-GAN head on
    reals and fakes, EMA, linear LR schedule); both with D's dropout."""
    optim = dict(moment_dtype="float32", d_lr=2e-6, g_lr=2e-6)
    if kind == "default":
        return JTrainConfig(model=JModelConfig(**TINY), batch_size=B, compute_dtype="float32",
                            seed=0, rng_impl="threefry2x32", hflip=True,
                            diffaugment="color,translation,cutout", log_grad_norms=True,
                            optim=JOptimConfig(**optim))
    return JTrainConfig(
        model=JModelConfig(num_classes=3, g_conditioning="concat", use_spectral_norm=True,
                           aux_classifier=True, **TINY),
        batch_size=B, compute_dtype="float32", seed=0, rng_impl="threefry2x32",
        diffaugment="translation,cutout", ema_decay=0.9, aux_weight=0.5, aux_d_on_fakes=True,
        optim=JOptimConfig(lr_schedule="linear", lr_total_steps=2, lr_decay_start_frac=0.0,
                           lr_end_frac=0.1, **{**optim, "d_lr": 1e-6}))


def batch_of(kind: str):
    if kind == "default":
        return generate_dataset(B, 64, seed=6), None
    images, labels = generate_labeled_dataset(3, 3, 64, seed=2)
    return images[:B], labels[:B]


def draws_of(jcfg: JTrainConfig, step: int):
    if jcfg.model.num_classes:
        return jax_draws_v20(jcfg, step, B)
    draws = jax_draws(jcfg, step, B)
    from test_torch_port_diffaug import jax_params
    from siggan_tpu.core import rng as jrng
    root = jrng.root_key(jcfg.seed, jcfg.rng_impl)
    dkeys = jax.random.split(jrng.at_step(jrng.stream(root, jrng.STREAM_DROPOUT), step),
                             jcfg.n_critic + 1)
    draws["diffaug"] = [jax_params(jax.random.fold_in(dk, 7), jcfg.diffaugment,
                                   2 * B if i < jcfg.n_critic else B, 64)
                        for i, dk in enumerate(dkeys)]
    return draws


def jax_mesh_run(jcfg: JTrainConfig, n: int, real, labels):
    """STEPS steps of the JAX step jitted over a mesh of n CPU devices."""
    mesh = j_make_mesh(JMeshConfig(num_data=n))
    assert mesh.shape["data"] == n
    batch = NamedSharding(mesh, P("data"))
    args = (jnp.asarray(real),) + (() if labels is None else (jnp.asarray(labels),))
    step = jax.jit(j_make_train_step(jcfg),
                   in_shardings=(NamedSharding(mesh, P()),) + (batch,) * len(args))
    js = j_replicate(mesh, j_create_train_state(jcfg))
    metrics = []
    for _ in range(STEPS):
        js, m = step(js, *args)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(js), metrics


def tail_case(size: int):
    """B2's plain version at the 64 or 128 px tail (base 32), global batch
    4: the inputs and JAX's ``tail_forward_train`` (interpret mode)."""
    jcfg, params, state, g = jax_model(size, 32, seed=size)
    start = g.tail_entry()
    ci = g.blocks[start].weight.shape[0]
    side = 4 * 2 ** start
    h0 = np.maximum(np.random.RandomState(1).randn(4, side, side, ci), 0).astype(np.float32)
    img, states = j_tail_forward_train(params, state, jnp.asarray(h0), jcfg, interpret=True)
    tail = g.blocks[start:]
    case = {"run": "tail", "h0": torch.from_numpy(h0),
            "ws": pt.pack_tail_reference([b.weight for b in tail] + [g.final.weight],
                                         torch.float32),
            "bn": [(b.bn.scale.detach(), b.bn.offset.detach()) for b in tail],
            "states": [{"mean": b.bn.mean.clone(), "var": b.bn.var.clone()} for b in tail],
            "bias": g.final.bias.detach()}
    return case, (np.asarray(img), jax.device_get(states))


def window_case():
    """The resident K-step route's graph buffers (K 2, 2 windows over a set
    of 32, bulk augmentation) on the port's own draws."""
    cfg = TrainConfig(model=port_cfg(jcfg_of("default")).model, batch_size=B,
                      compute_dtype="float32", seed=5, diffaugment="translation",
                      optim=port_cfg(jcfg_of("default")).optim)
    from siggan_tpu_torch.core.state import create_train_state
    images = torch.from_numpy(generate_dataset(32, 64, seed=8))
    return {"run": "windows", "cfg": cfg.to_json(), "state": create_train_state(cfg, "cpu"),
            "images": images, "labels": None, "k": 2, "windows": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's inputs, its ranks' results (2 ranks; the default step
    also on 4) and its references."""
    cases, refs = {}, {}
    for kind in ("default", "v20"):
        jcfg = jcfg_of(kind)
        cfg = port_cfg(jcfg)
        real, labels = batch_of(kind)
        cases[kind] = {"run": "steps", "cfg": cfg.to_json(),
                       "state": port_state_of(jcfg, cfg),
                       "real": torch.from_numpy(real),
                       "labels": None if labels is None else torch.from_numpy(labels).long(),
                       "draws": [draws_of(jcfg, s) for s in range(STEPS)]}
        refs[kind] = {n: jax_mesh_run(jcfg, n, real, labels)
                      for n in ((2, 4) if kind == "default" else (2,))}
    for size in (64, 128):
        cases[f"tail{size}"], refs[f"tail{size}"] = tail_case(size)
    cases["windows"] = window_case()
    out = {}
    for n, names in ((2, list(cases)), (4, ["default"])):
        d = tmp_path_factory.mktemp(f"dp{n}")
        torch.save({k: cases[k] for k in names}, d / "cases.pt")
        spawn(torch_port_dp_worker.run_cases, n, str(d / "cases.pt"))
        out[n] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
    return cases, refs, out


def port_state_of(jcfg, cfg):
    js = j_create_train_state(jcfg)
    if jcfg.model.num_classes:
        return port_state(js, cfg)
    from test_torch_port_train import port_state as plain_port_state
    return plain_port_state(js, cfg)


def one_process(case):
    """The case's steps in this process, without a mesh."""
    cfg = TrainConfig.from_json(case["cfg"])
    state, step, metrics = copy.deepcopy(case["state"]), make_train_step(cfg), []
    for draws in case["draws"]:
        state, m = step(state, case["real"], draws, case["labels"])
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def rank_state(template, tensors):
    """A copy of ``template`` holding a rank's saved state tensors."""
    state = copy.deepcopy(template)
    with torch.no_grad():
        for dst, src in zip(state_tensors(state), tensors):
            dst.copy_(src)
    return state


STEP_CASES = [("default", 2), ("v20", 2), ("default", 4)]


@pytest.mark.parametrize("kind,n", STEP_CASES)
def test_ranks_match_the_jax_mesh_step(runs, kind, n):
    cases, refs, out = runs
    js, jm = refs[kind][n]
    got = out[n][0][kind]
    cfg = TrainConfig.from_json(cases[kind]["cfg"])
    assert got["step"] == int(js.step) == STEPS
    for s in range(STEPS):
        assert set(got["metrics"][s]) == set(jm[s])
        for k, v in got["metrics"][s].items():
            np.testing.assert_allclose(float(v), jm[s][k], **TOL, err_msg=f"{s} {k}")
    st = rank_state(cases[kind]["state"], got["state"])
    for a, b in ((bridge.params_to_jax(st.g), js.g_params),
                 (bridge.params_to_jax(st.d), js.d_params), (bridge.to_jax(st.g)[1], js.g_bn)):
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_allclose(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                       **TOL)
    if cfg.model.use_spectral_norm:
        for x, y in zip(jax.tree_util.tree_leaves(bridge.d_to_jax(st.d)[1]),
                        jax.tree_util.tree_leaves(js.d_state)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL)
    if cfg.ema_decay > 0:
        for x, y in zip(jax.tree_util.tree_leaves(bridge.ema_to_jax(st.g_ema)),
                        jax.tree_util.tree_leaves(js.g_ema)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL)
    for opt, jopt, model in ((st.g_opt, js.g_opt, st.g), (st.d_opt, js.d_opt, st.d)):
        j = jax_opt(jopt)
        assert int(opt["count"]) == int(j["count"]) == STEPS
        for k, floor in (("m", 1e-8), ("v", 1e-16)):
            got_k = jax.tree_util.tree_leaves(bridge.tensors_to_jax(model, opt[k]))
            for a, b in zip(got_k, jax.tree_util.tree_leaves(j[k])):
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a, b, rtol=1e-3,
                                           atol=max(1e-3 * np.abs(b).max(), floor))


@pytest.mark.parametrize("kind,n", STEP_CASES)
def test_ranks_match_the_one_process_step(runs, kind, n):
    cases, _, out = runs
    want, wm = one_process(cases[kind])
    got = out[n][0][kind]
    for s in range(STEPS):
        for k, v in got["metrics"][s].items():
            np.testing.assert_allclose(float(v), wm[s][k], **TOL, err_msg=f"{s} {k}")
    for a, b in zip(got["state"], state_tensors(want)):
        np.testing.assert_allclose(a.float().numpy(), b.detach().float().numpy(), **TOL)


@pytest.mark.parametrize("kind,n", STEP_CASES + [("windows", 2), ("tail64", 2),
                                                 ("tail128", 2)])
def test_ranks_hold_bitwise_equal_states(runs, kind, n):
    """Parameters, BN running statistics, u's and Adam states are the same
    bits on every rank (the averaged gradients and the global statistics
    are); B2's running statistics too."""
    out = runs[2][n]
    key = "states" if kind.startswith("tail") else "state"
    ref = out[0][kind][key]
    for r in range(1, n):
        for a, b in zip(jax.tree_util.tree_leaves(ref),
                        jax.tree_util.tree_leaves(out[r][kind][key])):
            assert torch.equal(a, b), r


@pytest.mark.parametrize("kind,n", STEP_CASES)
def test_collectives_per_step(runs, kind, n):
    """Per step: one all-reduce per G BatchNorm in the D step's G forward
    (B2's plain version's layers included), one per BN in the G step's
    forward and one in its backward, one per gradient update (D, G) and
    one for the metrics."""
    cases, _, out = runs
    cfg = TrainConfig.from_json(cases[kind]["cfg"])
    n_bn = 1 + len(cases[kind]["state"].g.blocks)
    want = 3 * n_bn + cfg.n_critic + 1 + 1
    assert out[n][0][kind]["collectives"] == STEPS * want


@pytest.mark.parametrize("size", [64, 128])
def test_b2_plain_route_over_ranks_matches_jax_tail(runs, size):
    """B2's plain version with the cross-rank hook, 2 ranks of 2 rows,
    against the Pallas ``tail_forward_train`` (interpret mode) on the
    global batch of 4: the ranks' images stacked, and each rank's running
    statistics (the global batch's)."""
    _, refs, out = runs
    img_ref, states_ref = refs[f"tail{size}"]
    got = [out[2][r][f"tail{size}"] for r in range(2)]
    img = torch.cat([g["image"] for g in got]).numpy()
    np.testing.assert_allclose(img, img_ref, rtol=1e-4, atol=1e-4)
    for r in range(2):
        for st, want in zip(got[r]["states"], states_ref):
            for k in ("mean", "var"):
                np.testing.assert_allclose(st[k].numpy(), np.asarray(want[k]), **TOL)


def test_graph_route_buffers_over_ranks_match_one_process(runs):
    """The resident K-step route's graph buffers on 2 ranks (each capture
    replaced by a direct call): each rank gathers its rows of the window's
    global batches and takes its rows of the draws; the states equal one
    process's eager resident steps."""
    cases, _, out = runs
    case = cases["windows"]
    cfg = TrainConfig.from_json(case["cfg"])
    step, _ = make_resident_train_step(cfg, len(case["images"]))
    state, metrics = copy.deepcopy(case["state"]), []
    for _ in range(case["k"] * case["windows"]):
        state, m = step(state, case["images"])
        metrics.append(m)
    got = out[2][0]["windows"]
    assert got["step"] == state.step == 4
    for key in metrics[0]:
        rows = torch.cat([m[key] for m in got["metrics"]])
        np.testing.assert_allclose(rows.numpy(), [float(m[key]) for m in metrics], **TOL)
    for a, b in zip(got["state"], state_tensors(state)):
        np.testing.assert_allclose(a.float().numpy(), b.detach().float().numpy(), **TOL)


def test_data_mesh_rows_and_refusals():
    mesh = DataMesh(4, 2, "cpu")
    assert mesh.rows(8) == slice(4, 6) and mesh.local_batch_size(8) == 2
    t = torch.arange(16)
    assert mesh.shard_rows(t[:8], 8).tolist() == [4, 5]
    assert mesh.shard_rows(t, 8).tolist() == [4, 5, 12, 13]   # [real; fake]
    with pytest.raises(ValueError, match="global batch 6 not divisible by data-axis size 4"):
        mesh.local_batch_size(6)
    with pytest.raises(ValueError, match="not whole global batches"):
        mesh.shard_rows(t[:12], 8)
    with pytest.raises(ValueError, match="rank 4 outside"):
        DataMesh(4, 4, "cpu")
    # One process that joined no group: the one-card run, no mesh.
    assert make_mesh(MeshConfig(), "cpu") is None
    assert make_mesh(MeshConfig(num_data=1), "cpu") is None
    with pytest.raises(ValueError, match=r"mesh \(2 data ranks\) exceeds the launched "
                                         r"ranks \(1\)"):
        make_mesh(MeshConfig(num_data=2), "cpu")
    with pytest.raises(ValueError, match="num_model=2"):
        make_mesh(MeshConfig(num_model=2), "cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_loader_ranks_split_each_global_batch(n):
    """Over a mesh every rank walks the global order and takes its rows of
    each global batch: the ranks' batches, stacked, are the global ones."""
    from siggan_tpu_torch.data.loader import BatchLoader
    images = np.arange(20 * 4, dtype=np.float32).reshape(20, 2, 2, 1)
    labels = np.arange(20, dtype=np.int64)
    plain = list(BatchLoader(images, 8, labels=labels, seed=3, device="cpu").epoch(1))
    ranks = [list(BatchLoader(images, 8, labels=labels, seed=3, device="cpu",
                              mesh=DataMesh(n, r, "cpu")).epoch(1)) for r in range(n)]
    assert all(len(r) == len(plain) == 2 for r in ranks)
    for b, (x, y) in enumerate(plain):
        assert torch.equal(torch.cat([r[b][0] for r in ranks]), x)
        assert torch.equal(torch.cat([r[b][1] for r in ranks]), y)
        assert ranks[0][b][0].shape[0] == 8 // n
