"""Rank functions of the port's data-parallel tests, started through
``siggan_tpu_torch.parallel.mesh.spawn``.

A spawned rank imports this module by name, so it imports neither JAX nor
``siggan_tpu``. Each rank joins the job's gloo group (the CPU), runs the
cases of a file the test wrote (``torch.save``: global inputs, the rank
takes its rows) and saves what it got to ``rank{r}.pt`` beside it.
"""

from __future__ import annotations

import types
from pathlib import Path

import torch
import torch.distributed as dist

from siggan_tpu_torch.core.config import MeshConfig, TrainConfig
from siggan_tpu_torch.core.platform import init_distributed
from siggan_tpu_torch.ops.kernels import train_tail
from siggan_tpu_torch.parallel.mesh import make_mesh
from siggan_tpu_torch.train.train_step import (make_resident_multi_step, make_train_step,
                                               state_tensors)


def _steps(case, mesh):
    """Eager steps on this rank's rows of the global batch, on the case's
    global draws."""
    cfg = TrainConfig.from_json(case["cfg"])
    state, rows = case["state"], mesh.rows(cfg.batch_size)
    step = make_train_step(cfg, mesh=mesh)
    metrics = []
    for draws in case["draws"]:
        y = None if case["labels"] is None else case["labels"][rows]
        state, m = step(state, case["real"][rows], draws, y)
        metrics.append({k: v.clone() for k, v in m.items()})
    return {"state": [t.detach().clone() for t in state_tensors(state)],
            "step": state.step, "metrics": metrics}


def _windows(case, mesh):
    """The resident K-step route's graph buffers over the mesh, each
    capture replaced by a direct call of the step it would capture (the
    CPU has no graphs)."""
    cfg = TrainConfig.from_json(case["cfg"])
    images, labels, state = case["images"], case["labels"], case["state"]
    multi, _ = make_resident_multi_step(cfg, len(images), case["k"], mesh)
    g = multi.graphed

    def capture(st):
        g.graph = types.SimpleNamespace(replay=lambda: g._step(st))
        g.capture_s = 0.0

    g._capture = capture
    metrics = []
    for _ in range(case["windows"]):
        state, m = g(state, images, labels)
        metrics.append({k: v.clone() for k, v in m.items()})
    return {"state": [t.detach().clone() for t in state_tensors(state)],
            "step": state.step, "metrics": metrics}


def _tail(case, mesh):
    """B2's plain version over the mesh on this rank's rows of h0."""
    rows = mesh.rows(case["h0"].shape[0])
    states = [{k: v.clone() for k, v in st.items()} for st in case["states"]]
    with torch.no_grad():
        img = train_tail.tail_forward_train(case["h0"][rows], case["ws"], case["bn"], states,
                                            case["bias"], torch.float32, mesh=mesh)
    return {"image": img, "states": states}


RUNS = {"steps": _steps, "windows": _windows, "tail": _tail}


def run_cases(path: str) -> int:
    """Every case of the file at ``path`` on this rank; the results go to
    ``rank{r}.pt`` in its directory."""
    torch.set_num_threads(2)
    init_distributed("cpu")
    try:
        mesh = make_mesh(MeshConfig(), "cpu")
        cases = torch.load(path, weights_only=False)
        out = {}
        for name, case in cases.items():
            before = mesh.collectives.count
            out[name] = RUNS[case["run"]](case, mesh)
            out[name]["collectives"] = mesh.collectives.count - before
        torch.save(out, Path(path).parent / f"rank{mesh.rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0
