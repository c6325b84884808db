#!/usr/bin/env python3
"""Time ``cli.train`` on 1 and on N cards at several global batches.

    python3 scripts/dp_train_bench.py [--ranks 1 4] [--batches 64 256]
        [--steps 256] [--images 4096] [--device cuda] [--out DIR]

Writes ``--images`` synthetic 64 px PNGs once, then for each global batch
and each rank count runs ``python -m siggan_tpu_torch.cli.train`` in a fresh
process at ``TrainConfig()`` defaults (``--num_data_devices`` N; one rank is
the one-card run, with no process group) for about ``--steps`` steps, in
the order ranks 1, N, N, 1 per batch, with ``--profile_dir`` on: rank 0
traces its second epoch. Prints one JSON line per run: the CLI's
ms/step and images/s of every epoch after the first (the first holds the
warm-up steps and the capture), and from rank 0's trace the card's busy ms
a step (the union of its kernels' and copies' intervals over the traced
epoch, divided by its steps) and the share of it in NCCL kernels. The
card's name and power limit come first. ``--device cpu --ranks 1 2`` runs
the same on gloo ranks of the CPU (a rehearsal; the trace then holds no
card time).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def busy(trace: Path):
    """(busy ms, NCCL ms) of the device events of a Chrome trace: the
    union of their intervals, and the same for NCCL's kernels."""
    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    def union(evs):
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in evs)
        total, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e3
    return union(dev), union([e for e in dev if "nccl" in e.get("name", "").lower()])


def run(data: Path, out: Path, ranks: int, batch: int, epochs: int, device: str) -> dict:
    run_dir = out / f"r{ranks}_b{batch}_{time.time_ns()}"
    cmd = [sys.executable, "-m", "siggan_tpu_torch.cli.train", "--data_dir", str(data),
           "--batch_size", str(batch), "--epochs", str(epochs), "--num_data_devices",
           str(ranks), "--sample_interval", "0", "--checkpoint_interval", "0",
           "--run_dir", str(run_dir), "--profile_dir", str(run_dir / "trace"),
           "--device", device]
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=ROOT, check=True, stdout=subprocess.DEVNULL)
    wall = time.perf_counter() - t0
    logs = json.loads(next((run_dir / "logs").glob("*.json")).read_text())["metrics"]
    steady = logs[1:]
    traces = sorted((run_dir / "trace").glob("*.json"))
    result = {"ranks": ranks, "global_batch": batch, "rows_per_rank": batch // ranks,
              "epochs": len(logs), "process_s": wall,
              "ms_per_step": [m["ms_per_step"] for m in steady],
              "images_per_sec": [m["images_per_sec"] for m in steady],
              "d_loss_last": logs[-1]["d_loss"], "g_loss_last": logs[-1]["g_loss"]}
    if traces:
        b, n = busy(traces[0])
        per_epoch = len(list(data.glob("*.png"))) // batch   # the traced epoch's steps
        result.update(busy_ms_per_step=b / per_epoch, nccl_ms_per_step=n / per_epoch,
                      traced_steps=per_epoch)
    shutil.rmtree(run_dir)
    return result


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 4])
    p.add_argument("--batches", type=int, nargs="+", default=[64, 256])
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--images", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=str(ROOT / "build" / "dp_train_bench"))
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from siggan_tpu_torch.data.synthetic import save_dataset_pngs

    print(card_line(), flush=True)
    out = Path(args.out)
    data = out / "data"
    if not data.exists():
        save_dataset_pngs(args.images, data, seed=0)
    for batch in args.batches:
        epochs = max(2, round(args.steps / (args.images // batch)))
        one, many = min(args.ranks), max(args.ranks)
        for ranks in (one, many, many, one):
            print(json.dumps(run(data, out, ranks, batch, epochs, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
