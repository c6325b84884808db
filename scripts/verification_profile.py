#!/usr/bin/env python3
"""Profile the verification path's two device workloads on one CUDA card.

    python3 scripts/verification_profile.py [--steps 20]

1. The verifier's eager train step (``verify/train.py::train_step``) at
   the CLI's shapes (batch 32 pairs, 64 x 64, f32 with TF32 off), with
   cuDNN's heuristic algorithm choice (what the port runs) and with
   ``torch.backends.cudnn.benchmark`` on, and with the convs on contiguous
   NCHW copies (a layout variant): wall ms/step (host clock over
   ``--steps`` steps ending in a synchronize), the profiler's device busy
   ms/step and idle share, and the top kernels by device time.
2. The batched preprocessing (``data/preprocess.py::preprocess_batch``)
   on 64 canvases of 512 x 512: ms per batch (CUDA events) and its top
   kernels.

Prints the card's name and power limit, one line per measurement, and a
JSON summary as the last line. Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def top_kernels(prof, steps: int, n: int = 8):
    """(device busy ms per step, device operations per step, the top ``n``
    (name, ms per step, launches per step)), CUDA kernels and copies."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:n]


def _nchw_conv(x, w, b=None, *, stride=1, padding=0, compute_dtype=None):
    """The verifier's conv on a contiguous NCHW copy (a layout variant,
    not the port's path)."""
    import torch.nn.functional as F
    y = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), w, stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b


def profile_verifier(steps: int, benchmark: bool, nchw: bool = False):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from siggan_tpu_torch.eval.common import full_f32
    from siggan_tpu_torch.verify import models, train

    torch.backends.cudnn.benchmark = benchmark
    conv = models.conv2d_oihw
    if nchw:
        models.conv2d_oihw = _nchw_conv
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    x1, x2 = (torch.from_numpy(np.tanh(rs.randn(32, 64, 64, 1) * 2).astype(np.float32)).to(dev)
              for _ in range(2))
    lab = torch.tensor([1.0, 0.0] * 16, device=dev)
    st = train.create_state(0, 128, train.make_optimizer(steps_per_epoch=27), dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run(n):
        for _ in range(n):
            train.train_step(st, x1, x2, lab, gen=gen)
    with full_f32():
        run(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
    busy, ops, top = top_kernels(prof, steps)
    torch.backends.cudnn.benchmark = False
    models.conv2d_oihw = conv
    return {"wall_ms_per_step": wall, "busy_ms_per_step": busy,
            "idle_share": max(0.0, 1 - busy / wall), "ops_per_step": ops, "top": top}


def profile_preprocess(iters: int):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from siggan_tpu_torch.data import preprocess as pp

    rs = np.random.RandomState(0)
    c = np.full((64, 512, 512), 255.0, np.float32)
    hw = np.zeros((64, 2), np.int32)
    for i in range(64):
        h, w = rs.randint(256, 513, 2)
        hw[i] = h, w
        page = rs.randint(200, 256, (h, w)).astype(np.float32)
        for _ in range(200):
            y, x = rs.randint(0, h), rs.randint(0, w)
            page[max(0, y - 2):y + 3, max(0, x - 15):x + 15] = rs.randint(0, 90)
        c[i, :h, :w] = page
    canv, hws = torch.from_numpy(c).cuda(), torch.from_numpy(hw).cuda()
    for _ in range(2):
        pp.preprocess_batch(canv, hws)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        pp.preprocess_batch(canv, hws)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            pp.preprocess_batch(canv, hws)
        torch.cuda.synchronize()
    busy, ops, top = top_kernels(prof, iters)
    return {"ms_per_64": ms, "busy_ms_per_64": busy, "ops_per_64": ops, "top": top}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("verification_profile: needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "verifier": {}}
    for name, bench, nchw in (("port", False, False), ("cudnn.benchmark", True, False),
                              ("NCHW convs", False, True), ("port again", False, False)):
        r = profile_verifier(args.steps, bench, nchw)
        out["verifier"][name] = r
        print(f"verifier step, {name}: {r['wall_ms_per_step']:.3f} ms/step wall, busy "
              f"{r['busy_ms_per_step']:.3f}, idle {r['idle_share']:.4f}, "
              f"{r['ops_per_step']:.0f} device operations a step [{card}]", flush=True)
        for k, ms, n in r["top"]:
            print(f"    {ms:9.4f} ms x{n:5.1f}  {k[:140]}", flush=True)
    r = profile_preprocess(10)
    out["preprocess"] = r
    print(f"preprocess_batch, 64 canvases of 512: {r['ms_per_64']:.3f} ms (busy "
          f"{r['busy_ms_per_64']:.3f}, {r['ops_per_64']:.0f} device operations) [{card}]",
          flush=True)
    for k, ms, n in r["top"]:
        print(f"    {ms:9.4f} ms x{n:5.1f}  {k[:140]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
