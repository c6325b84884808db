"""The fused generator forwards (``fuse_g_forwards``) over a mesh on the CPU:
two gloo ranks spawned through the port's launcher
(``torch_port_dp_worker``) against the port's one-process fused step at the
same global batch, on the JAX package's draws.

Each rank takes its rows of every sub-step's latents (and labels) and
concatenates its groups locally; each group's BatchNorm sums are
all-reduced in one call, so its statistics are the global batch's of that
sub-step, and the G and D gradients are averaged over the ranks. Cases:
the default 64 px model with dropout, hflip and DiffAugment at n_critic 1
and 2, the v2.0-style conditional model of ``test_torch_port_dp.py``, and
the resident K-step route's graph buffers. Bars as in
``test_torch_port_dp.py``: f32 rtol 1e-4 / atol 1e-5 on metrics and every
state tensor (Adam's moments included) against one process, and every
rank's state the same bits.
"""

import numpy as np
import pytest
import torch

import torch_port_dp_worker
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.parallel.mesh import spawn
from siggan_tpu_torch.train.train_step import state_tensors
from test_torch_port_dp import (TOL, batch_of, draws_of, jcfg_of, one_process, port_state_of,
                                window_case)
from test_torch_port_multistep import few_threads  # noqa: F401  (autouse)
from test_torch_port_train import port_cfg

CASES = {"default": ("default", 1), "n_critic2": ("default", 2), "v20": ("v20", 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {}
    for name, (kind, n_critic) in CASES.items():
        jcfg = jcfg_of(kind).replace(fuse_g_forwards=True, n_critic=n_critic)
        cfg = port_cfg(jcfg)
        real, labels = batch_of(kind)
        cases[name] = {"run": "steps", "cfg": cfg.to_json(), "state": port_state_of(jcfg, cfg),
                       "real": torch.from_numpy(real),
                       "labels": None if labels is None else torch.from_numpy(labels).long(),
                       "draws": [draws_of(jcfg, s) for s in range(2)]}
    win = window_case()
    win["cfg"] = TrainConfig.from_json(win["cfg"]).replace(fuse_g_forwards=True).to_json()
    cases["windows"] = win
    d = tmp_path_factory.mktemp("fuse_dp")
    torch.save(cases, d / "cases.pt")
    spawn(torch_port_dp_worker.run_cases, 2, str(d / "cases.pt"))
    return cases, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_the_one_process_fused_step(runs, name):
    cases, out = runs
    assert TrainConfig.from_json(cases[name]["cfg"]).fuse_g_forwards
    want, wm = one_process(cases[name])
    got = out[0][name]
    assert got["step"] == want.step == 2
    for s in range(2):
        assert set(got["metrics"][s]) == set(wm[s])
        for k, v in got["metrics"][s].items():
            np.testing.assert_allclose(float(v), wm[s][k], **TOL, err_msg=f"{s} {k}")
    for a, b in zip(got["state"], state_tensors(want)):
        np.testing.assert_allclose(a.float().numpy(), b.detach().float().numpy(), **TOL)


@pytest.mark.parametrize("name", list(CASES) + ["windows"])
def test_ranks_hold_bitwise_equal_fused_states(runs, name):
    """Every rank ends with the same bits: averaged gradients, global
    group statistics."""
    _, out = runs
    for a, b in zip(out[0][name]["state"], out[1][name]["state"]):
        assert torch.equal(a, b)
    assert out[0][name]["collectives"] == out[1][name]["collectives"] > 0
