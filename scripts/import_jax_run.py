#!/usr/bin/env python3
"""Import a run of the JAX package (``siggan_tpu``, Orbax checkpoints) into
the PyTorch port's run layout, so the port serves and resumes it.

    python scripts/import_jax_run.py SRC DST [--which all|latest|best|N ...]

``SRC`` is a JAX checkpoint directory (``config.json``, ``index.json`` and
one Orbax ``epoch_NNNN`` directory per saved epoch); ``DST`` receives the
port's layout (``siggan_tpu_torch/ckpt/manager.py``): ``config.json``,
``index.json`` and, per epoch, ``generator.npz``, ``generator_ema.npz``
when the run has a shadow, ``discriminator.npz`` (the spectral-norm u's
under ``state/``), ``optimizer.npz`` (moments as f32, the learning rate
each Adam state last applied), ``fixed_noise.npy`` and ``state.json``.
``--which`` picks the epochs (default ``all``: every epoch of the index).

It runs where JAX and the JAX package are installed (a TPU host, or a CPU
host with ``JAX_PLATFORMS=cpu``): each epoch is restored through the JAX
package's own ``CheckpointManager.restore``, whose rules it keeps (a shadow
present while ``ema_decay == 0`` is dropped; one missing while EMA is on
starts as a copy of the weights). Copy ``DST`` to the machine with the card;
there ``python -m siggan_tpu_torch.cli.serve --checkpoint DST`` serves the
latest epoch and ``python -m siggan_tpu_torch.cli.train --checkpoint_dir
DST --resume ...`` (the run's flags) trains on from the next epoch.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def adam_state(opt) -> Dict:
    """{count, m, v} of a JAX optimizer chain's Adam state (``adam_low_mem``'s
    dict, or optax.adam's ``ScaleByAdamState``), as numpy."""
    import jax
    inner = opt[-1]
    if not isinstance(inner, dict):
        inner = {"count": inner[0].count, "m": inner[0].mu, "v": inner[0].nu}
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return {"count": np.int32(np.asarray(inner["count"])),
            "m": as_np(inner["m"]), "v": as_np(inner["v"])}


def applied_lr(cfg, lr: float, step_mult: int, count: int) -> float:
    """The learning rate the Adam update number ``count`` applied (0 before
    the first), from the JAX package's own schedule of ``cfg``: the record
    the port keeps in each Adam state (its schedules recompute the rate
    from the count)."""
    from siggan_tpu.core.state import _lr_schedule
    if count <= 0:
        return 0.0
    sched = _lr_schedule(cfg, lr, step_mult)
    return float(np.asarray(sched(count - 1))) if callable(sched) else float(sched)


def select(index: Dict, which: Sequence[str]) -> List[int]:
    epochs = list(index.get("epochs", []))
    if "all" in which:
        return epochs
    out = []
    for w in which:
        e = index.get(w) if w in ("latest", "best") else int(w)
        if e is None or e not in epochs:
            raise SystemExit(f"no epoch {w!r} in the run's index ({epochs})")
        if e not in out:
            out.append(e)
    return sorted(out)


def convert(src: str | Path, dst: str | Path, which: Sequence[str] = ("all",)) -> Dict:
    """Convert the epochs ``which`` names; returns the written index."""
    import jax
    from siggan_tpu.ckpt.manager import CheckpointManager
    from siggan_tpu_torch.ckpt import manager as port

    src, dst = Path(src), Path(dst)
    sidecar = (src / port.SIDECAR).read_text()
    cfg = CheckpointManager.load_config(src)
    mgr = CheckpointManager(src, cfg)
    index = mgr.available()
    epochs = select(index, which)
    if not epochs:
        raise SystemExit(f"{src} holds no saved epoch")
    dst.mkdir(parents=True, exist_ok=True)
    (dst / port.SIDECAR).write_text(sidecar)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    for epoch in epochs:
        state, extras = mgr.restore(epoch)
        g_opt, d_opt = adam_state(state.g_opt), adam_state(state.d_opt)
        g_opt["lr"] = applied_lr(cfg, cfg.optim.g_lr, 1, int(g_opt["count"]))
        d_opt["lr"] = applied_lr(cfg, cfg.optim.d_lr, max(cfg.n_critic, 1),
                                 int(d_opt["count"]))
        g_ema = state.g_ema
        port.write_epoch(
            dst / f"epoch_{epoch:04d}", sidecar, epoch=extras["epoch"],
            step=int(np.asarray(state.step)), best_g_loss=extras["best_g_loss"],
            g=(as_np(state.g_params), as_np(state.g_bn)),
            d=(as_np(state.d_params), as_np(state.d_state)), g_opt=g_opt, d_opt=d_opt,
            fixed_noise=np.asarray(extras["fixed_noise"]),
            g_ema=None if g_ema is None else (as_np(g_ema["params"]), as_np(g_ema["bn"])))
        print(f"epoch {epoch}: step {int(np.asarray(state.step))}, "
              f"EMA {'yes' if g_ema is not None else 'no'} -> {dst / f'epoch_{epoch:04d}'}",
              flush=True)
    out = {k: v for k, v in index.items() if k in ("best_g_loss", "best_fid")}
    out["epochs"] = epochs
    out["latest"] = index.get("latest") if index.get("latest") in epochs else max(epochs)
    if index.get("best") in epochs:
        out["best"] = index["best"]
    port.write_index(dst, out)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Import a JAX package run into the "
                                            "PyTorch port's run layout")
    p.add_argument("src", help="the JAX run's checkpoint directory")
    p.add_argument("dst", help="the port run directory to write")
    p.add_argument("--which", nargs="+", default=["all"],
                   help="'all' (default), 'latest', 'best' or epoch numbers")
    args = p.parse_args(argv)
    idx = convert(args.src, args.dst, args.which)
    print(f"wrote {args.dst}: epochs {idx['epochs']}, latest {idx['latest']}, "
          f"best {idx.get('best')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
