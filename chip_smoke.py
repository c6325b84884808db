#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``siggan_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel from ``siggan_tpu_torch/csrc`` (one nvcc per source,
     started together) and print the build time and ptxas summaries, and
     the tensor-core instructions (HMMA/HGMMA) per kernel in the SASS of
     B2, B3 and B4, failing if B2's bf16 conv tile, B3's tile kernel (in
     both libraries that hold it) or B4's fused block-4 + final conv
     kernel has none;
  3. hold B3 and B4 against their plain PyTorch versions at the full-width
     64 px generator's shapes (batch 64 and 10), and time kernel, plain
     version and a library yardstick with CUDA events; B3's totals sum the
     shapes of blocks 1-3, the ones the served forward runs it at (block
     4's shape is checked and timed beside them); print B4's host call,
     its device time per kernel (profiler), and the bounds: 3xTF32 on the
     tensor cores (three times the FLOPs of the blocks and the final conv
     at the TF32 peak, plus the fc's at the f32 CUDA-core rate) and all
     FLOPs at the CUDA-core rate;
  4. serve a full-width generator (random weights from a seed) through the
     port's HTTP server on port 0, send five requests, and check that the
     generator kernel's launch counters rose, that the images decode, repeat
     for a seed and agree with the cuDNN path;
  5. hold the packed-tail pack kernels B1 and B1' against their plain
     versions at the full-width tail shapes, in bf16 and f32 (forward
     bit-equal, backward within rtol 1e-5 / atol 1e-6 and two launches
     bit-equal), and time kernel, plain version and a library yardstick
     (torch.take + cast / index_add_), each host call and device time,
     B1' replayed from a CUDA graph, and the gather from the four weights
     to four tensors (cat, take, cast, views) beside it;
  6. hold the train-mode packed-tail kernel B2 against its plain version at
     the full-width tails of the 64 px and 128 px generators (batch 64), in
     f32 and bf16, check that two launches give the same bits, and time the
     host call, its device time, the plain version and a library yardstick
     (the port's own no-grad module-path tail, cuDNN), print B2's device
     time per kernel, and the bound from tail_cost (pre-BN intermediates
     written once and read once); then hold the D
     step's generator forward with its tail in B2 against the module path
     it replaces, on two copies of one full-width generator, in f32 and
     bf16 (the packed fakes and every tail BN's batch statistics);
  7. train: write 2048 synthetic 64 px PNGs, run the port's training CLI on
     the card for 3 epochs of 32 steps at TrainConfig() defaults (bf16,
     batch 64, packed I/O) on its graphed dispatch (K steps a window, a CUDA
     graph of one step replayed K times; K and the capture time printed),
     and check finite losses, D accuracy in (0, 1),
     that G, D and G's BN statistics moved, that B1 launched twice, B1'
     once and B2 once per step, that the saved generator serves on the
     kernel path, and that resuming restores the step counter; run the
     same seeded CLI training with the D step's tail on the module path
     (its own capture) and print its last losses beside B2's; hold two
     graphed windows against 2K eager steps on copies of the trained state
     (bit-equal where two eager runs are, else within their spread, both
     printed); then profile the eager resident step in 10-step windows and
     the graphed dispatch in K-step windows for wall ms/step, device busy
     time, idle share, operations per step and top kernels, with the D
     step's generator tail on B2 and on the module path in turns (B2,
     module, module, B2; the graphed route on one capture per route), and
     report the step's model FLOPs against the bf16 peak;
  8. train v1.1 the same way: 1024 synthetic 128 px PNGs, the CLI with
     --image_size 128 --spectral_norm for 2 epochs of 16 steps (depth cut
     from v1.1's 200 epochs), the same checks and module-route run, plus
     spectral-norm vectors that moved, have unit norm and come back on
     resume, and the checkpoint served at 128 x 128 through the module path;
  9. train v2.0, the conditional recipe, the same way at full width: 8
     writer subdirectories of 256 synthetic 64 px PNGs each
     (generate_labeled_dataset(8, 256, 64, seed=21); the recipe's 8 x 1024
     cut to phase 7's size), the CLI with V20_ARGV (8 classes, concat
     labels, spectral norm with the projection head, latent 200, d_lr 1e-4,
     g_lr 2e-4, linear LR decay, DiffAugment translation,cutout) for 3
     epochs of 32 steps (depth cut from 600 epochs); the checks of phase 8
     plus the class embedding's u, the LR Adam applied at the last step
     against the linear schedule's for G and D, a resumed run trained on
     for one more epoch whose last LR is the schedule's at its count, the
     checkpoint served over HTTP with class_id 0 and 7 (images that decode,
     repeat for a seed and differ between the classes), two graphed
     windows against eager steps with the EMA shadow on and the LR
     decaying over them, and the profile;
 10. evaluate phase 7's trained model (kept with its 2048 PNGs): saved as
     a ``use_pallas`` generator checkpoint, ``cli.evaluate --n_samples 512
     --seeds 0 1`` (random-init InceptionV3 FID, KID, precision/recall,
     LPIPS-Alex, stroke stats) samples through B4 (2 x 8 launches, B3 3 per
     launch), its report finite and free of errors, the grids written; the
     Inception features, LPIPS distances and D(x) (score_with_discriminator,
     phase 7's D) of 64 images on the card against the CPU module on the
     same weights (EVAL_TOL_NOTE); FID(real half, real half) below FID(real,
     uniform noise); the stage times (B4 sampling, Inception images/s,
     LPIPS pairs/s, the host FID / KID / precision-recall math, the CLI);
     then ``cli.train --fid_interval 1 --checkpoint_interval 1`` for 2
     epochs on the graphed dispatch (a finite FID each epoch, ``best`` the
     lowest FID's epoch, its ms/step beside phase 7's) and ``cli.evaluate
     --which best`` on that run;
 11. the verification experiment (``write_scans``, ``verification_phase``):
     55 writers x 24 signatures (CEDAR's genuine count) from
     generate_labeled_dataset(55, 24, 64, seed=31), upscaled to scan size
     with aspect jitter (about one in ten past the 512 px canvas) on white
     pages with light specks, written as per-writer PNGs; ``cli.preprocess``
     on the card (processed + invalid = 1320, the invalid share, images/s;
     one 64-scan batch card against CPU, VERIFY_TOL_NOTE); ``cli.generate``
     512 images from phase 10's ``use_pallas`` checkpoint (B4 x8, B3 x24);
     ``cli.verifier_train`` baseline and augmented at the JAX defaults (20
     epochs, batch 32, 10 pairs a user; finite losses, both pickles, the
     baseline above chance; ms/step and s/model); ``cli.verifier_eval`` (20
     pairs a user, seed 123; both models, the comparison, curves.json) and
     256 test pairs' scores card against CPU; ``cli.evaluate --backbone
     verifier:<baseline pkl> --n_samples 512 --seeds 0`` on phase 7's model
     and PNGs (no errors, a finite FID, the real floor and the feature
     diversity; B4 x8, B3 x24); the stage times;
 12. print the kernels line (one JSON object; B1, B1' and B2 with their
     launches by path, B4 and B3 with their launches on the serving, the
     evaluation and the verification paths), the nvidia-smi line again, and
     as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import io
import copy
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zipfile
from pathlib import Path

F32_PEAK_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores (data sheet)
TF32_PEAK_FLOPS = 494.7e12 # H100 SXM dense TF32 tensor cores (data sheet)
BF16_PEAK_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
RTOL, ATOL = 1e-4, 1e-4
TOL_NOTE = ("allclose rtol 1e-4 atol 1e-4: 3xTF32 products (B3, B4's blocks) or f32 "
            "FMAs, summed in f32 in another order than the plain version's matmuls")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call between CUDA events, with the garbage collector
    paused as ``timeit`` does, so that a collection does not land on one
    call's time."""
    import gc
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    finally:
        if collecting:
            gc.enable()
    return start.elapsed_time(end) / iters


def device_time(fn, calls: int = 10):
    """Device time per call from a profiler trace: ({kernel: ms}, total ms,
    device operations launched), CUDA kernels and copies only. An empty
    trace gives ({}, None, 0)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    per = {e.key: e.self_device_time_total / 1e3 / calls for e in events}
    return per, (sum(per.values()) if per else None), sum(e.count for e in events) / calls


def tensor_core_sass(name: str):
    """{kernel: count of tensor-core instructions (HMMA, HGMMA)} in the
    SASS of the library csrc/<name>.cu built into (cuobjdump -sass)."""
    import shutil
    from siggan_tpu_torch.ops.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the f32 FLOP time and byte time."""
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare(name: str, got, ref) -> float:
    import torch
    err = float((got - ref).abs().max())
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: max abs diff {err:.3e} outside {TOL_NOTE}")
    return err


def calibrate(model, z) -> None:
    """Give the random model realistic eval BN statistics (each layer's batch
    statistics with a random jitter) and scale the final conv so that the
    images span [-1, 1], as a trained generator's do."""
    import torch
    from siggan_tpu_torch.ops.conv import conv2d_oihw, conv_transpose2d_iohw, linear_oi
    g = torch.Generator().manual_seed(1)

    def set_stats(bn, h):
        flat = h.reshape(-1, h.shape[-1])
        jit = lambda: (0.8 + 0.4 * torch.rand(flat.shape[1], generator=g)).to(h.device)  # noqa: E731
        bn.mean.copy_(flat.mean(0) * jit())
        bn.var.copy_(flat.var(0) * jit())

    with torch.no_grad():
        h = linear_oi(z, model.fc.weight, model.fc.bias)
        set_stats(model.fc_bn, h)
        h = torch.relu(model.fc_bn(h)).reshape(z.shape[0], 4, 4, -1)
        for blk in model.blocks:
            h = conv_transpose2d_iohw(h, blk.weight, stride=2, padding=1)
            set_stats(blk.bn, h)
            h = torch.relu(blk.bn(h))
        pre = conv2d_oihw(h, model.final.weight, model.final.bias, padding=1)
        model.final.weight.mul_(1.5 / float(pre.std()))


def tensor_core_bound(tc_flops: float, core_flops: float, nbytes: float):
    """(bound_ms, bound_by, cuda_core_bound_ms). The tensor-core FLOPs run as
    3xTF32, three passes at the TF32 peak; the rest at the f32 CUDA-core
    rate; the bound is the larger of that and the byte time. The CUDA-core
    bound puts every FLOP at the f32 rate."""
    t_ops = 3 * tc_flops / TF32_PEAK_FLOPS + core_flops / F32_PEAK_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            (tc_flops + core_flops) / F32_PEAK_FLOPS * 1e3)


def check_kernels(model, dev):
    """Phase 3: B3 and B4 against their plain versions, with timings."""
    import torch
    import torch.nn.functional as F
    from siggan_tpu_torch.core import rng
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import upsample as up

    packed = gf.pack_generator(model)
    g = rng.generator(0, rng.STREAM_FIXED)
    z64 = torch.randn(64, model.cfg.latent_dim, generator=g).to(dev)
    z10 = torch.randn(10, model.cfg.latent_dim, generator=g).to(dev)
    c0 = packed["bfc16"].shape[-1]
    g2 = torch.Generator().manual_seed(2)
    last, w4 = packed["blocks"][-1], model.blocks[-1].weight
    relu_off = {**last, "scale": (torch.rand(w4.shape[1], generator=g2) + 0.5).to(dev),
                "offset": torch.randn(w4.shape[1], generator=g2).to(dev)}

    def block_cases(z):
        """B3's inputs at the four block shapes, the generator's own block
        inputs, and block 4 again with ReLU off."""
        h = torch.relu(torch.einsum("nk,pkc->npc", z, packed["wfc16"])
                       + packed["bfc16"]).reshape(z.shape[0], 4, 4, c0)
        cases = []
        for i, (blk, pb) in enumerate(zip(model.blocks, packed["blocks"])):
            cases.append((f"block{i + 1}", h, blk.weight, pb, True))
            h = up.convt_phase_reference(h, pb["taps"], pb["scale"], pb["offset"])
        return cases + [("block4_no_relu", cases[-1][1], w4, relu_off, False)]

    # B3 at the four block shapes, batch 64 (timed) and 10. The totals sum
    # blocks 1-3: the served forward runs block 4 in its fused kernel.
    on_path = ("block1", "block2", "block3")
    b3 = {"max_abs_diff": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
          "tc_flops": 0.0, "bytes": 0.0, "shapes": []}
    for z in (z64, z10):
        cases = block_cases(z)
        for name, x, w_iohw, pb, relu in cases:
            n, hh, ww, cin = x.shape
            cout = w_iohw.shape[1]
            w9 = up.pack_w9(w_iohw.permute(2, 3, 0, 1).contiguous())
            got = up.upsample_block(x, w9, pb["scale"], pb["offset"], relu=relu)
            ref = up.upsample_block_reference(x, w9, pb["scale"], pb["offset"], relu=relu)
            if not relu and float(got.min()) >= 0:
                raise AssertionError(f"{name}: ReLU was not off")
            err = compare(f"upsample_block {name} n={n}", got, ref)
            b3["max_abs_diff"] = max(b3["max_abs_diff"], err)
            if n != 64:
                print(f"upsample_block {name} x{tuple(x.shape)}->{cout} relu={relu}: "
                      f"max_abs_diff {err:.3e}", flush=True)
                continue
            k_ms = time_ms(lambda: up.upsample_block_taps(x, pb["taps"], pb["scale"],
                                                          pb["offset"], relu, pb["taps_mma"]))
            p_ms = time_ms(lambda: up.upsample_block_reference(x, w9, pb["scale"],
                                                               pb["offset"], relu))
            x_nchw = x.permute(0, 3, 1, 2)
            l_ms = time_ms(lambda: F.conv_transpose2d(x_nchw, w_iohw, stride=2, padding=1))
            flops = 2.0 * 16 * n * cin * cout * hh * ww
            nbytes = 4.0 * (x.numel() + 2 * 16 * cin * cout + 2 * cout + got.numel())
            b_ms, b_by, core_ms = tensor_core_bound(flops, 0.0, nbytes)
            print(f"upsample_block {name} x{tuple(x.shape)}->{cout} relu={relu}: "
                  f"max_abs_diff {err:.3e}, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"conv_transpose2d {l_ms:.4f} ms (no affine epilogue), "
                  f"bound {b_ms:.4f} ms ({b_by}, 3xTF32), CUDA-core bound {core_ms:.4f} ms",
                  flush=True)
            b3["shapes"].append({"case": name, "x": list(x.shape), "cout": cout,
                                 "relu": relu, "on_main_path": name in on_path,
                                 "max_abs_diff": err, "kernel_ms": k_ms,
                                 "plain_ms": p_ms, "library_ms": l_ms,
                                 "bound_ms": b_ms, "bound_by": b_by,
                                 "cuda_core_bound_ms": core_ms})
            if name in on_path:
                for k, v in (("kernel_ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                             ("tc_flops", flops), ("bytes", nbytes)):
                    b3[k] += v
    b3["bound_ms"], b3["bound_by"], b3["cuda_core_bound_ms"] = tensor_core_bound(
        b3["tc_flops"], 0.0, b3["bytes"])
    cases = block_cases(z64)
    _, b3["device_ms"], _ = device_time(lambda: [
        up.upsample_block_taps(x, pb["taps"], pb["scale"], pb["offset"], True, pb["taps_mma"])
        for name, x, _, pb, _ in cases if name in on_path])

    # B4 at batch 64 and at an odd batch; two launches give the same bits.
    b4 = {"max_abs_diff": 0.0}
    for z in (z64, z10):
        img = gf.generator_forward(packed, z)
        ref = gf.generator_forward_reference(packed, z)
        if img.shape != (z.shape[0], 64, 64, 1):
            raise AssertionError(f"generator_forward shape {tuple(img.shape)}")
        if float(img.std()) <= 0.1:
            raise AssertionError(f"image std {float(img.std()):.3f}: images too flat")
        if not torch.equal(img, gf.generator_forward(packed, z)):
            raise AssertionError("generator_forward: two launches differ")
        b4["max_abs_diff"] = max(b4["max_abs_diff"],
                                 compare(f"generator_forward n={z.shape[0]}", img, ref))
    b4["kernel_ms"] = time_ms(lambda: gf.generator_forward(packed, z64))
    per, b4["device_ms"], _ = device_time(lambda: gf.generator_forward(packed, z64))
    b4["device_kernels"] = per
    for name, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"  generator_forward device time: {ms:.4f} ms  {name[:90]}", flush=True)
    b4["plain_ms"] = time_ms(lambda: gf.generator_forward_reference(packed, z64))
    with torch.no_grad():
        b4["library_ms"] = time_ms(lambda: model(z64, None, torch.float32))
    zdim, c = z64.shape[1], packed["wfin"].shape[2]
    core_macs = zdim * 16 * c0   # the fc, on the CUDA cores
    tc_macs = 9 * c * 64 * 64 + sum(   # the blocks and the final conv, 3xTF32
        16 * b["taps"].shape[3] * b["taps"].shape[4] * (4 * 2 ** i) ** 2
        for i, b in enumerate(packed["blocks"]))
    weights = sum(t.numel() for t in (packed["wfc16"], packed["bfc16"],
                                      packed["wfin"], packed["bfin"]))
    weights += sum(b[k].numel() for b in packed["blocks"]
                   for k in ("taps_mma", "scale", "offset"))
    b4["flops"] = 2.0 * 64 * (core_macs + tc_macs)
    b4["bytes"] = 4.0 * (z64.numel() + weights + 64 * 64 * 64)
    b4["bound_ms"], b4["bound_by"], b4["cuda_core_bound_ms"] = tensor_core_bound(
        2.0 * 64 * tc_macs, 2.0 * 64 * core_macs, b4["bytes"])
    print(f"generator_forward batch 64: max_abs_diff {b4['max_abs_diff']:.3e}, "
          f"host call {b4['kernel_ms']:.4f} ms (device {fmt_ms(b4['device_ms'])}), "
          f"plain {b4['plain_ms']:.4f} ms, cuDNN module path f32 {b4['library_ms']:.4f} ms, "
          f"bound {b4['bound_ms']:.4f} ms ({b4['bound_by']}; blocks and final conv 3xTF32 at "
          f"{TF32_PEAK_FLOPS / 1e12:.1f} TFLOP/s, fc at "
          f"{F32_PEAK_FLOPS / 1e12:.0f}; {b4['flops'] / 1e9:.3f} GFLOP, "
          f"{b4['bytes'] / 1e6:.2f} MB), CUDA-core bound {b4['cuda_core_bound_ms']:.4f} ms",
          flush=True)
    return b3, b4


def http(url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        payload, status, ctype = r.read(), r.status, r.headers["Content-Type"]
    if status != 200:
        raise AssertionError(f"{url}: HTTP {status}")
    return payload, ctype, (time.perf_counter() - t0) * 1e3


def serve_phase(model, card: str):
    """Phase 4: the port's main path, through its HTTP server."""
    import numpy as np
    import torch
    from siggan_tpu_torch.ckpt.manager import save_generator
    from siggan_tpu_torch.core.config import TrainConfig
    from siggan_tpu_torch.infer.export import decode_png
    from siggan_tpu_torch.infer.generate import GeneratorSession
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import upsample as up
    from siggan_tpu_torch.serve.api import serve
    from siggan_tpu_torch.utils.visualizer import to_uint8

    with tempfile.TemporaryDirectory() as ckpt:
        save_generator(ckpt, model, TrainConfig(model=model.cfg, use_pallas=True,
                                                compute_dtype="float32"))
        server = serve("127.0.0.1", 0, ckpt, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        try:
            session = server.core.state.session
            if session is None:
                raise AssertionError(f"model failed to load: {server.core.state.load_error}")
            if not session.uses_kernel:
                raise AssertionError("the session does not use the generator kernel")
            thread.start()
            base = f"http://127.0.0.1:{server.server_address[1]}"
            gf.LAUNCHES.reset()
            up.LAUNCHES.reset()
            health, _, h_ms = http(base + "/health")
            info, _, i_ms = http(base + "/info")
            b64, _, b_ms = http(base + "/generate", {"n": 64, "format": "base64"})
            zipped, ztype, z_ms = http(base + "/generate", {"n": 100, "format": "zip"})
            single, stype, s_ms = http(base + "/generate/single", {"seed": 7})
            again = [session.sample(64, seed=11) for _ in range(2)]
            launches = {"generator_forward": gf.LAUNCHES.count,
                        "upsample_block": up.LAUNCHES.count}
            # Where a request's time goes: host wall clock vs device busy.
            req = {"n": 64, "format": "base64", "seed": 5}
            walls = [http(base + "/generate", req)[2] for _ in range(5)]
            _, busy, _ = device_time(lambda: http(base + "/generate", req), calls=5)
        finally:
            server.shutdown()
            server.server_close()
            if thread.is_alive():
                thread.join(timeout=30)
        print(f"main path launches: {json.dumps(launches)}", flush=True)
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"{name} was not launched on the main path")

        health, info = json.loads(health), json.loads(info)
        if not (health["model_loaded"] and health["platform"] == "gpu"):
            raise AssertionError(f"/health: {health}")
        if info["image_size"] != 64 or info["latent_dim"] != 100:
            raise AssertionError(f"/info: {info}")
        imgs = [decode_png(base64.b64decode(s)) for s in json.loads(b64)["images"]]
        want = to_uint8(session.sample(64, seed=42))
        if len(imgs) != 64 or not all(np.array_equal(a, b) for a, b in zip(imgs, want)):
            raise AssertionError("/generate base64: images differ from the session's")
        with zipfile.ZipFile(io.BytesIO(zipped)) as zf:
            names = zf.namelist()
            shapes = {decode_png(zf.read(nm)).shape for nm in names}
        if ztype != "application/zip" or len(names) != 100 or shapes != {(64, 64, 1)}:
            raise AssertionError(f"/generate zip: {len(names)} files, shapes {shapes}")
        if stype != "image/png" or not np.array_equal(
                decode_png(single), to_uint8(session.sample(1, seed=7))[0]):
            raise AssertionError("/generate/single: wrong image")
        if not np.array_equal(again[0], again[1]):
            raise AssertionError("the same seed gave different images")
        check = session.sample(16, seed=3)
        cudnn = GeneratorSession(model, compute_dtype="float32", use_pallas=False,
                                 device="cuda").sample(16, seed=3)
        if not np.isfinite(check).all() or np.abs(check).max() > 1.0:
            raise AssertionError("images are not finite values in [-1, 1]")
        diff = float(np.abs(check - cudnn).max())
        if diff > 1e-3:
            raise AssertionError(f"kernel path vs cuDNN path: max abs diff {diff:.3e}")
        torch.cuda.synchronize()
    for name, ms, n in (("GET /health", h_ms, 0), ("GET /info", i_ms, 0),
                        ("POST /generate n=64 base64", b_ms, 64),
                        ("POST /generate n=100 zip", z_ms, 100),
                        ("POST /generate/single", s_ms, 1)):
        rate = f", {n / ms * 1e3:.1f} images/s" if n else ""
        print(f"{name}: {ms:.2f} ms{rate} [{card}]", flush=True)
    print(f"kernel path vs cuDNN path (16 images): max abs diff {diff:.3e}", flush=True)
    wall = sorted(walls)[len(walls) // 2]
    idle = "not measured" if busy is None else f"{1 - busy / wall:.4f}"
    print(f"POST /generate n=64 base64 x5: median {wall:.2f} ms (min {min(walls):.2f}, "
          f"max {max(walls):.2f}); device busy "
          f"{'not measured' if busy is None else f'{busy:.4f}'} ms per request; "
          f"device idle share {idle} [{card}]", flush=True)
    return launches


def check_pack_tail(dev):
    """Phase 5: B1 / B1' against their plain versions at the full-width tail
    shapes (64 px, base 256: entry 128->64, blocks 64->32 and 32->32, final
    32->1), in bf16 (the train path's dtype) and f32."""
    import torch
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    g = torch.Generator().manual_seed(5)
    shapes = [(128, 64, 4, 4), (64, 32, 4, 4), (32, 32, 4, 4), (1, 32, 3, 3)]
    ws = [(torch.randn(s, generator=g) * 0.02).to(dev) for s in shapes]
    n_in = sum(w.numel() for w in ws)
    # Library yardstick: one gather / one index_add_ by the constant index
    # map of the placement, probed from the plain pack with a 1-based ramp.
    ramp = torch.arange(1, n_in + 1, dtype=torch.float32, device=dev)
    parts, o = [], 0
    for w in ws:
        parts.append(ramp[o:o + w.numel()].reshape(w.shape))
        o += w.numel()
    probe = torch.cat([t.reshape(-1) for t in pt.pack_tail_reference(parts, torch.float32)])
    idx = torch.where(probe == 0, torch.full_like(probe, n_in + 1), probe).long() - 1
    flat = torch.cat([torch.cat([w.reshape(-1) for w in ws]),
                      torch.zeros(1, device=dev)])
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        got = pt.pack_tail_launch(ws, dt)
        ref = pt.pack_tail_reference(ws, dt)
        for i, (a, b) in enumerate(zip(got, ref)):
            if a.dtype != dt or not torch.equal(a, b):
                raise AssertionError(f"pack_tail {name} weight {i}: not bit-equal")
        if not torch.equal(torch.cat([a.reshape(-1) for a in got]),
                           torch.take(flat, idx).to(dt)):
            raise AssertionError(f"pack_tail {name}: differs from the index-map gather")
        cts = [torch.randn(a.shape, generator=g).to(dev, dt) for a in got]
        bgot = pt.pack_tail_backward_launch(ws, cts)
        bref = pt.pack_tail_backward_reference(ws, cts)
        if not all(torch.equal(a, b) for a, b in zip(bgot, pt.pack_tail_backward_launch(ws, cts))):
            raise AssertionError(f"pack_tail backward {name}: two launches differ")
        err = 0.0
        for i, (a, b) in enumerate(zip(bgot, bref)):
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"pack_tail backward {name} weight {i}: "
                                     f"max abs diff {float((a - b).abs().max()):.3e}")
            err = max(err, float((a - b).abs().max()))
        ct_flat = torch.cat([c.reshape(-1) for c in cts])
        n_out = ct_flat.numel()
        isz = ct_flat.element_size()
        _, f_dev, _ = device_time(lambda: pt.pack_tail_launch(ws, dt))
        _, b_dev, _ = device_time(lambda: pt.pack_tail_backward_launch(ws, cts))
        # Host calls of a few tens of us: 200 calls each, so that the host's
        # load at one moment does not decide the mean.
        many = dict(iters=200, warmup=20)
        f_ms = time_ms(lambda: pt.pack_tail_launch(ws, dt), **many)
        fp_ms = time_ms(lambda: pt.pack_tail_reference(ws, dt))
        take = lambda: torch.take(flat, idx).to(dt)  # noqa: E731
        scatter = lambda: torch.zeros(n_in + 1, device=dev).index_add_(  # noqa: E731
            0, idx, ct_flat.float())
        fl_ms = time_ms(take, **many)
        _, fl_dev, _ = device_time(take)
        # The same gather from the four weights to the four packed tensors:
        # the concatenation and the output views that B1's call also makes.
        zero, shapes = torch.zeros(1, device=dev), [a.shape for a in got]
        take_io = lambda: [  # noqa: E731
            t.view(sh) for t, sh in zip(torch.take(torch.cat(
                [*(w.reshape(-1) for w in ws), zero]), idx).to(dt).split_with_sizes(
                    [math.prod(sh) for sh in shapes]), shapes)]
        if not all(torch.equal(a, b) for a, b in zip(take_io(), got)):
            raise AssertionError(f"pack_tail {name}: differs from the four-tensor gather")
        fio_ms = time_ms(take_io, **many)
        b_ms = time_ms(lambda: pt.pack_tail_backward_launch(ws, cts), **many)
        # B1' as the graphed train step runs it: one captured launch, replayed.
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            pt.pack_tail_backward_launch(ws, cts)
        pt.BWD_LAUNCHES.add(-1)   # the capture recorded the launch; replays run it
        bg_ms = time_ms(graph.replay, **many)
        bp_ms = time_ms(lambda: pt.pack_tail_backward_reference(ws, cts))
        bl_ms = time_ms(scatter, **many)
        _, bl_dev, _ = device_time(scatter)
        # Bytes: each input read once, each output written once; no FLOPs in
        # B1, one add per non-zero placement in B1' (negligible).
        nbytes = 4.0 * n_in + isz * n_out
        bound_f, by_f = bound(0.0, nbytes)
        bound_b, by_b = bound(float(int((idx < n_in).sum())), nbytes)
        print(f"pack_tail {name}: {n_in} canonical -> {n_out} packed values; B1 bit-equal, "
              f"kernel {f_ms:.4f} ms (device {fmt_ms(f_dev)}), plain {fp_ms:.4f} ms, "
              f"take+cast {fl_ms:.4f} ms (device {fmt_ms(fl_dev)}; from the four "
              f"weights to four tensors {fio_ms:.4f} ms), "
              f"bound {bound_f * 1e3:.3f} us ({by_f}); B1' max_abs_diff {err:.3e}, "
              f"two launches bit-equal, kernel {b_ms:.4f} ms (device {fmt_ms(b_dev)}, "
              f"graph replay {bg_ms:.4f} ms), plain {bp_ms:.4f} ms, "
              f"index_add_ {bl_ms:.4f} ms (device {fmt_ms(bl_dev)}), "
              f"bound {bound_b * 1e3:.3f} us ({by_b})", flush=True)
        out[name] = {"fwd": {"max_abs_diff": 0.0, "kernel_ms": f_ms, "plain_ms": fp_ms,
                             "library_ms": fl_ms, "bound_ms": bound_f, "bound_by": by_f,
                             "device_ms": f_dev, "library_device_ms": fl_dev,
                             "library_same_io_ms": fio_ms},
                     "bwd": {"max_abs_diff": err, "kernel_ms": b_ms, "plain_ms": bp_ms,
                             "library_ms": bl_ms, "bound_ms": bound_b, "bound_by": by_b,
                             "device_ms": b_dev, "library_device_ms": bl_dev,
                             "graph_replay_ms": bg_ms}}
    return out


B2_TOL_NOTE = ("against the plain version and against the module path it replaces; "
               "f32: allclose rtol 1e-4 atol 1e-4 (image) and rtol 1e-4 atol 1e-5 "
               "(batch statistics, (new - 0.9 old) / 0.1 of each running update), "
               "f32 sums in another order; bf16: image atol 2e-2, batch statistics "
               "rtol 1e-2 atol 1e-3, because the kernel's prologue rounds affine + "
               "ReLU to bf16 once where the plain version (and JAX) round after each "
               "op, and a bf16 ulp flip propagates through the tail")


def b2_tols(f32: bool):
    """B2's (image, batch statistics) tolerances, as in B2_TOL_NOTE."""
    if f32:
        return dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-5)
    return dict(rtol=0.0, atol=2e-2), dict(rtol=1e-2, atol=1e-3)


def clone_states(states):
    return [{k: v.clone() for k, v in s.items()} for s in states]


def batch_stats(new, old):
    """The batch statistics each running update took in: (new - 0.9 old) /
    0.1. Compared instead of the running values, of which only a tenth is
    the batch's."""
    return [{k: (n[k] - 0.9 * o[k]) / 0.1 for k in ("mean", "var")}
            for n, o in zip(new, old)]


def compare_b2(what: str, img, ref, new, ref_new, old, f32: bool):
    """Hold B2's image and batch statistics against a reference's; returns
    (image max abs diff, batch-statistics max abs diff, the largest
    |diff| / (atol + rtol |ref|) of the statistics)."""
    import torch
    img_tol, st_tol = b2_tols(f32)
    err = float((img.float() - ref.float()).abs().max())
    if not torch.isfinite(img.float()).all() or not torch.allclose(
            img.float(), ref.float(), **img_tol):
        raise AssertionError(f"{what}: image max abs diff {err:.3e} outside {img_tol}")
    st_err = st_use = 0.0
    for i, (a, b) in enumerate(zip(batch_stats(new, old), batch_stats(ref_new, old))):
        for k in ("mean", "var"):
            d = (a[k] - b[k]).abs()
            use = float((d / (st_tol["atol"] + st_tol["rtol"] * b[k].abs())).max())
            if not torch.isfinite(a[k]).all() or use > 1.0:
                raise AssertionError(f"{what}: BN {i} batch {k} max abs diff "
                                     f"{float(d.max()):.3e} outside {st_tol}")
            st_err, st_use = max(st_err, float(d.max())), max(st_use, use)
    return err, st_err, st_use


def train_tail_case(dev, size: int, dtype, batch: int = 64, seed: int = 0):
    """B2's inputs at the full-width tail of the ``size`` px generator: B1's
    packed weights in ``dtype``, random BN affines and running statistics,
    and a ReLU'd random h0 at the tail entry."""
    import torch
    from siggan_tpu_torch.core import rng
    from siggan_tpu_torch.core.config import ModelConfig
    from siggan_tpu_torch.models.generator import init_fn
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    g = init_fn(rng.generator(seed, rng.STREAM_INIT_G), ModelConfig(image_size=size), dev)
    gen = torch.Generator().manual_seed(seed)
    tail = g.blocks[g.tail_entry():]
    with torch.no_grad():
        for blk in tail:
            c = blk.bn.mean.shape[0]
            blk.bn.offset.copy_(torch.randn(c, generator=gen) * 0.1)
            blk.bn.mean.copy_(torch.randn(c, generator=gen) * 0.1)
            blk.bn.var.copy_(torch.rand(c, generator=gen) + 0.5)
        g.final.bias.fill_(0.05)
        ws = pt.pack_tail_reference([b.weight for b in tail] + [g.final.weight], dtype)
    side = size // 2 ** len(tail)
    h0 = torch.relu(torch.randn(batch, side, side, tail[0].weight.shape[0],
                                generator=gen)).to(dev, dtype)
    canonical = [(b.weight.shape[0], b.weight.shape[1]) for b in tail]
    return (h0, ws, [(b.bn.scale.detach(), b.bn.offset.detach()) for b in tail],
            [{"mean": b.bn.mean.detach(), "var": b.bn.var.detach()} for b in tail],
            g.final.bias.detach(), canonical)


def module_tail(h0, ws, bn, states, bias, dtype):
    """The library yardstick for B2: the port's own no-grad module-path tail
    (cuDNN convs, PyTorch BN statistics and elementwise ops)."""
    import torch
    from siggan_tpu_torch.ops.conv import conv2d_oihw, conv_transpose2d_iohw
    from siggan_tpu_torch.ops.norm import batch_norm_packed
    from siggan_tpu_torch.ops.packed import conv3_mc_as_matmul_ihwo
    h = conv2d_oihw(h0, ws[0], stride=1, padding=1, compute_dtype=dtype)
    for i, w in enumerate(ws[1:-1]):
        h = torch.relu(batch_norm_packed(h, *bn[i], states[i], train=True)[0])
        h = conv_transpose2d_iohw(h, w, stride=2, padding=1, compute_dtype=dtype)
    h = torch.relu(batch_norm_packed(h, *bn[-1], states[-1], train=True)[0])
    return torch.tanh(conv3_mc_as_matmul_ihwo(h, ws[-1], bias.expand(4), dtype))


def check_train_tail(dev):
    """Phase 6: B2 against its plain version at both full-width tails."""
    import torch
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    out = {}
    for size in (64, 128):
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            h0, ws, bn, states, bias, canonical = train_tail_case(dev, size, dtype)
            # The wrapper updates the states it is given: each call takes a copy.
            new, new2, spare = (clone_states(states) for _ in range(3))
            with torch.no_grad():
                img = tt.tail_forward_train(h0, ws, bn, new, bias, dtype)
                again = tt.tail_forward_train(h0, ws, bn, new2, bias, dtype)
                ref, ref_new = tt.tail_forward_train_reference(h0, ws, bn, states, bias,
                                                               dtype)
            torch.cuda.synchronize()
            if not torch.equal(img, again) or not all(
                    torch.equal(a[k], b[k]) for a, b in zip(new, new2) for k in a):
                raise AssertionError(f"train_tail {size} px {name}: two launches differ")
            f32 = dtype == torch.float32
            err, st_err, st_use = compare_b2(f"train_tail {size} px {name}", img, ref, new,
                                             ref_new, states, f32)
            with torch.no_grad():
                k_ms = time_ms(lambda: tt.tail_forward_train(h0, ws, bn, spare, bias, dtype))
                per, d_ms, n_ops = device_time(
                    lambda: tt.tail_forward_train(h0, ws, bn, spare, bias, dtype))
                p_ms = time_ms(lambda: tt.tail_forward_train_reference(
                    h0, ws, bn, states, bias, dtype))
                lib = module_tail(h0, ws, bn, states, bias, dtype)
                l_ms = time_ms(lambda: module_tail(h0, ws, bn, states, bias, dtype))
                _, l_dev, l_ops = device_time(
                    lambda: module_tail(h0, ws, bn, states, bias, dtype))
            lib_err = float((lib.float() - ref.float()).abs().max())
            # Canonical FLOPs; bytes: the function's inputs read once, its
            # outputs written once, and each pre-BN intermediate written once
            # and read once (train-mode BN needs the batch's statistics
            # before the next layer reads it): tt.tail_cost.
            n = h0.shape[0]
            flops, nbytes = tt.tail_cost(n, h0.shape[1], canonical, h0.element_size())
            peak = F32_PEAK_FLOPS if f32 else BF16_PEAK_FLOPS
            t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
            b_ms, b_by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                                     else "bytes")
            core_ms = flops / F32_PEAK_FLOPS * 1e3
            print(f"train_tail {size} px {name} batch {n}: image max_abs_diff {err:.3e}, "
                  f"batch stats {st_err:.3e} ({st_use:.3f} of the bar); host call {k_ms:.4f} ms (device "
                  f"{fmt_ms(d_ms)}, {n_ops:.0f} kernels), plain {p_ms:.4f} ms, module-path "
                  f"tail {l_ms:.4f} ms (device {fmt_ms(l_dev)}, {l_ops:.0f} kernels; vs "
                  f"plain {lib_err:.3e}), bound {b_ms:.4f} ms ({b_by}; "
                  f"{flops / 1e9:.3f} GFLOP at {peak / 1e12:.0f} TFLOP/s, "
                  f"{nbytes / 1e6:.2f} MB), CUDA-core bound {core_ms:.4f} ms", flush=True)
            for kname, ms in sorted(per.items(), key=lambda kv: -kv[1]):
                print(f"  B2 {size} px {name} device {ms:.4f} ms  {kname[:100]}", flush=True)
            row[name] = {"device_kernels": per, "max_abs_diff": err,
                         "batch_stats_max_abs_diff": st_err,
                         "batch_stats_share_of_bar": st_use,
                         "kernel_ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
                         "library_ms": l_ms, "library_device_ms": l_dev,
                         "library_kernels": l_ops, "bound_ms": b_ms, "bound_by": b_by,
                         "cuda_core_bound_ms": core_ms, "gflop": flops / 1e9,
                         "mb": nbytes / 1e6}
        out[size] = row
    return out


def check_fused_route(dev):
    """Phase 6, second part: the D step's generator forward at full width
    (batch 64, train mode, no gradient) with its tail in B2 against the
    module path it replaces, on two copies of one seeded generator; the
    packed fakes and every tail BN's batch statistics at B2's bars."""
    import torch
    from siggan_tpu_torch.core import rng
    from siggan_tpu_torch.core.config import ModelConfig
    from siggan_tpu_torch.models.generator import init_fn
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    out = {}
    for size in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            fused = init_fn(rng.generator(0, rng.STREAM_INIT_G), ModelConfig(image_size=size),
                            dev)
            module = copy.deepcopy(fused)
            tails = [g.blocks[g.tail_entry():] for g in (fused, module)]
            old = [{"mean": b.bn.mean.clone(), "var": b.bn.var.clone()} for b in tails[0]]
            z = torch.randn(64, fused.cfg.latent_dim,
                            generator=torch.Generator().manual_seed(1)).to(dev)
            before = tt.LAUNCHES.count
            with torch.no_grad():
                a = fused(z, None, dtype, train=True, packed_output=True, fused_tail=True)
                b = module(z, None, dtype, train=True, packed_output=True)
            if tt.LAUNCHES.count != before + 1:
                raise AssertionError("the fused route did not launch B2 once")
            new = [[{"mean": x.bn.mean, "var": x.bn.var} for x in t] for t in tails]
            err, st_err, st_use = compare_b2(f"D-step G forward {size} px {name}, B2 vs "
                                             f"module path", a, b, new[0], new[1], old,
                                             dtype == torch.float32)
            print(f"D-step G forward {size} px {name} batch 64, tail on B2 vs module path: "
                  f"packed fakes max_abs_diff {err:.3e}, tail BN batch stats "
                  f"{st_err:.3e} ({st_use:.3f} of the bar)", flush=True)
            out[f"{size}px_{name}"] = {"max_abs_diff": err, "batch_stats_max_abs_diff": st_err,
                                       "batch_stats_share_of_bar": st_use}
    return out


def step_flops(cfg, batch: int) -> float:
    """Model FLOPs of one train step (n_critic=1), counted from the
    canonical layer shapes: 2 FLOPs per MAC; a trained layer's forward +
    input gradient + weight gradient is 3 forwards. G: forward in the D
    step, forward + both gradients in the G step (4 forwards of batch b).
    D: forward + both gradients over the 2b batch of the D step, forward +
    input gradient over b in the G step (3 x 2b + 2 x b forwards). A
    conditional model's fc takes the one-hot columns (concat), and D's
    projection head adds one 8192-term dot a sample (the AC-GAN head
    num_classes of them); DiffAugment is counted as no FLOPs."""
    from siggan_tpu_torch.models.generator import channel_schedule as g_sched
    from siggan_tpu_torch.models.discriminator import channel_schedule as d_sched
    c0, blocks = g_sched(cfg.model)
    size = cfg.model.image_size
    nc = cfg.model.num_classes
    fc_in = cfg.model.latent_dim + (nc if cfg.model.g_conditioning == "concat" and nc else 0)
    g_macs = fc_in * 16 * c0 + 9 * blocks[-1][1] * size * size
    side = 4
    for ci, co in blocks:
        g_macs += 16 * ci * co * side * side
        side *= 2
    heads = 1 + (1 if nc and cfg.model.d_projection else 0) + (
        nc if nc and cfg.model.aux_classifier else 0)
    d_macs, side = heads * 512 * 4 * 4, cfg.model.image_size
    for ci, co in d_sched(cfg.model):
        side //= 2
        d_macs += 16 * ci * co * side * side
    return 2.0 * (4 * batch * g_macs + (3 * 2 * batch + 2 * batch) * d_macs)


class _Tee(io.StringIO):
    """A text stream that keeps what is written and passes it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s):
        self.out.write(s)
        return super().write(s)

    def flush(self):
        self.out.flush()


def run_cli(main, argv) -> str:
    """``main(argv)`` with its standard output shown and returned; raises
    unless it exits 0."""
    import contextlib
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}: {argv}")
    return tee.getvalue()


def state_groups(state, metrics):
    """The state's tensors by part, and the metrics."""
    return {"G parameters": list(state.g.parameters()),
            "G BN statistics": list(state.g.buffers()),
            "D parameters": list(state.d.parameters()),
            "D spectral-norm u": list(state.d.buffers()),
            "G Adam": [state.g_opt["count"], state.g_opt["lr"], *state.g_opt["m"],
                       *state.g_opt["v"]],
            "D Adam": [state.d_opt["count"], state.d_opt["lr"], *state.d_opt["m"],
                       *state.d_opt["v"]],
            "G EMA": ([] if state.g_ema is None
                      else [*state.g_ema.parameters(), *state.g_ema.buffers()]),
            "metrics": list(metrics.values())}


def group_diffs(a, b):
    """{part: max abs difference} between two ``state_groups``."""
    import torch
    return {k: max([float((x.detach().float() - y.detach().float()).abs().max())
                    for x, y in zip(a[k], b[k])], default=0.0)
            for k in a}


def graphed_vs_eager(tag, cfg, n_images, images, state0, k, labels=None):
    """Phases 7-9: two windows of K graphed steps (the first holding the
    eager warm-up steps and the capture) against 2K eager resident steps, on
    copies of one state at an epoch boundary. Two eager runs are compared
    first: where they give the same bits the graphed run must too, else it
    must stay within their spread (twice its largest difference) in every
    part -- parameters, BN statistics, u's, both Adam states with their LR
    records, the EMA shadow, metrics. Returns (the agreement, the graphed
    state)."""
    import torch
    from siggan_tpu_torch.train.train_step import (make_resident_multi_step,
                                                   make_resident_train_step)

    def eager():
        fn, _ = make_resident_train_step(cfg, n_images)
        state, ms = copy.deepcopy(state0), []
        for _ in range(2 * k):
            state, m = fn(state, images, labels=labels)
            ms.append(m)
        return state_groups(state, {key: torch.stack([m[key] for m in ms]) for key in ms[0]})
    first, second = eager(), eager()
    multi, _ = make_resident_multi_step(cfg, n_images, k)
    state, ms = copy.deepcopy(state0), []
    for _ in range(2):
        state, m = multi(state, images, labels)
        ms.append(m)
    graphed = state_groups(state, {key: torch.cat([m[key] for m in ms]) for key in ms[0]})
    torch.cuda.synchronize()
    spread, diff = group_diffs(first, second), group_diffs(graphed, first)
    bit_equal = all(v == 0.0 for v in spread.values())
    for part, d in diff.items():
        if d > 2 * spread[part]:
            raise AssertionError(f"{tag}: graphed vs eager {part} differ by {d:.3e}, "
                                 f"two eager runs by {spread[part]:.3e}")
    print(f"{tag}: two windows of {k} graphed steps vs {2 * k} eager steps (capture "
          f"{multi.graphed.capture_s:.3f} s): eager vs eager max abs diff by part "
          f"{json.dumps(spread)}; graphed vs eager {json.dumps(diff)}; "
          f"{'bit-equal' if bit_equal else 'within the eager spread'}", flush=True)
    return {"k": k, "capture_s": multi.graphed.capture_s, "eager_spread": spread,
            "graphed_vs_eager": diff, "eager_bit_equal": bit_equal}, state


def profile_routes(cfg, n_images, images, state, k, labels=None):
    """Phases 7-9: profile the steps on the trained state, the D step's G
    tail on B2 and on the module path in turns (B2, module, module, B2):
    10-step windows of the eager resident step, and K-step windows of the
    graphed dispatch (one multi-step per route, each captured under its
    route, both bound to one copy of the state). Returns ({"eager B2": [(host
    ms/step, device busy ms/step, device operations per step)], ...}, the
    eager and the graphed B2 windows' device ms by kernel)."""
    import torch
    from siggan_tpu_torch.models.generator import fused_tail_supported
    from siggan_tpu_torch.train import train_step as ts
    step_fn, _ = ts.make_resident_train_step(cfg, n_images)
    graphed = {route: ts.make_resident_multi_step(cfg, n_images, k)[0]
               for route in ("B2", "module")}
    gstate = copy.deepcopy(state)

    def ten():
        nonlocal state
        for _ in range(10):
            state, m = step_fn(state, images, labels=labels)
        return m

    def window(route):
        def run():
            nonlocal gstate
            gstate, m = graphed[route](gstate, images, labels)
            return m
        return run
    routes = {f"{how} {route}": [] for how in ("eager", "graphed") for route in ("B2", "module")}
    per, gper = {}, {}
    try:
        for route in ("B2", "module", "module", "B2"):
            ts.fused_tail_supported = (fused_tail_supported if route == "B2"
                                       else (lambda m: False))
            for how, fn, n in (("eager", ten, 10), ("graphed", window(route), k)):
                fn()   # the first graphed window warms up and captures
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / n
                p, b, o = device_time(fn, calls=1)
                if route == "B2":
                    (per if how == "eager" else gper).update(p)
                routes[f"{how} {route}"].append((wall, None if b is None else b / n, o / n))
    finally:
        ts.fused_tail_supported = fused_tail_supported
    return routes, per, gper


V20_ARGV = ["--num_classes", "8", "--g_conditioning", "concat", "--spectral_norm",
            "--latent_dim", "200", "--d_lr", "1e-4", "--g_lr", "2e-4", "--lr_schedule", "linear",
            "--diffaugment", "translation,cutout"]


def linear_lr(lr: float, total: int, count: int) -> float:
    """optax's join_schedules([constant(lr), linear(lr, 0, span)], [start])
    at ``count`` in f32, written out apart from the port's Schedule."""
    import numpy as np
    start = int(total * 0.5)
    span = max(total - start, 1)
    if count < start:
        return float(np.float32(lr))
    frac = np.float32(1) - np.float32(min(count - start, span)) / np.float32(span)
    return float(np.float32(lr) * frac)


def serve_conditional(run: str, card: str):
    """Phase 9: the trained conditional checkpoint through the HTTP server,
    class_id 0 and 7: the images decode, repeat for a seed and differ
    between the classes."""
    import numpy as np
    from siggan_tpu_torch.infer.export import decode_png
    from siggan_tpu_torch.serve.api import serve
    server = serve("127.0.0.1", 0, f"{run}/checkpoints", device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    try:
        if server.core.state.session is None:
            raise AssertionError(f"model failed to load: {server.core.state.load_error}")
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        info = json.loads(http(base + "/info")[0])
        got, ms = {}, []
        for cid, tag in ((0, "a"), (0, "b"), (7, "a")):
            payload, _, t = http(base + "/generate", {"n": 16, "format": "base64",
                                                       "seed": 3, "class_id": cid})
            got[(cid, tag)] = [decode_png(base64.b64decode(x))
                               for x in json.loads(payload)["images"]]
            ms.append(t)
    finally:
        server.shutdown()
        server.server_close()
        if thread.is_alive():
            thread.join(timeout=30)
    if info["num_classes"] != 8 or info["latent_dim"] != 200:
        raise AssertionError(f"/info: {info}")
    if any(len(v) != 16 or v[0].shape != (64, 64, 1) for v in got.values()):
        raise AssertionError("the conditional checkpoint served wrong images")
    if not all(np.array_equal(a, b) for a, b in zip(got[(0, "a")], got[(0, "b")])):
        raise AssertionError("class_id 0: the same seed gave different images")
    same = sum(np.array_equal(a, b) for a, b in zip(got[(0, "a")], got[(7, "a")]))
    if same:
        raise AssertionError(f"class_id 0 and 7 gave {same} equal images of 16")
    print(f"train v2.0: served the checkpoint with class_id 0 and 7 (16 images each; "
          f"{' / '.join(f'{t:.2f}' for t in ms)} ms a request) [{card}]", flush=True)


def train_phase(card: str, size: int = 64, epochs: int = 3, n_images: int = 2048,
                v20: bool = False, keep: str | None = None):
    """Phases 7, 8 and 9: the port's training path, through its CLI, at full
    width: TrainConfig() defaults at 64 px, v1.1 (--spectral_norm) at 128,
    and the conditional v2.0 recipe (``V20_ARGV``) at 64 px on 8 writers.
    With ``keep`` the PNGs (``data``) and the run (``run``) are written
    there and left for phase 10, else into a directory removed after."""
    import contextlib
    import dataclasses
    import numpy as np
    import torch
    from siggan_tpu_torch.ckpt.manager import D_STATE, D_WEIGHTS, CheckpointManager, \
        load_generator
    from siggan_tpu_torch.cli import train as train_cli
    from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
    from siggan_tpu_torch.core.state import copy_generator, create_train_state
    from siggan_tpu_torch.data.synthetic import save_dataset_pngs, save_labeled_dataset_pngs
    from siggan_tpu_torch.infer.generate import GeneratorSession
    from siggan_tpu_torch.models.generator import fused_tail_supported
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    from siggan_tpu_torch.train import train_step as ts
    from siggan_tpu_torch.train.trainer import GANTrainer

    sn = size == 128 or v20
    tag = "train v2.0" if v20 else "train v1.1 128 px SN" if sn else "train 64 px"
    with (tempfile.TemporaryDirectory() if keep is None else contextlib.nullcontext(keep)) \
            as tmp:
        t0 = time.perf_counter()
        if v20:
            data = save_labeled_dataset_pngs(8, n_images // 8, f"{tmp}/data", size=size,
                                             seed=21)
        else:
            data = save_dataset_pngs(n_images, f"{tmp}/data", size=size, seed=0)
        print(f"{tag}: wrote {n_images} synthetic {size} px PNGs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        run = f"{tmp}/run"
        argv = ["--data_dir", str(data), "--epochs", str(epochs), "--image_size", str(size),
                "--checkpoint_interval", "1", "--run_dir", run, "--device", "cuda"]
        if v20:
            argv += V20_ARGV
        elif sn:
            argv.append("--spectral_norm")
        for counter in (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES):
            counter.reset()
        t0 = time.perf_counter()
        out = run_cli(train_cli.main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"pack_tail": pt.FWD_LAUNCHES.count,
                    "pack_tail_backward": pt.BWD_LAUNCHES.count,
                    "train_tail": tt.LAUNCHES.count}
        dispatch = re.search(r"Dispatch: (\d+) steps per call .* graph of one step, "
                             r"captured in ([0-9.]+) s", out)
        if dispatch is None:
            raise AssertionError("the CLI did not train on the graphed dispatch")
        k, capture_s = int(dispatch.group(1)), float(dispatch.group(2))
        print(f"{tag}: CLI {epochs} epochs in {wall:.1f} s, K = {k} steps per graphed "
              f"window, one step's graph captured in {capture_s:.3f} s; main path "
              f"launches: {json.dumps(launches)}", flush=True)

        cfg = TrainConfig.from_json(open(f"{run}/checkpoints/config.json").read())
        steps = epochs * (n_images // cfg.batch_size)
        want_model = ModelConfig(image_size=size, use_spectral_norm=sn)
        if v20:
            want_model = ModelConfig(latent_dim=200, num_classes=8, g_conditioning="concat",
                                     use_spectral_norm=True)
            o = cfg.optim
            if (o.d_lr, o.g_lr, o.lr_schedule, o.lr_total_steps, cfg.diffaugment) != (
                    1e-4, 2e-4, "linear", steps, "translation,cutout"):
                raise AssertionError(f"not the v2.0 recipe: {cfg.to_json()}")
        if (cfg.model != want_model or cfg.batch_size != 64
                or cfg.compute_dtype != "bfloat16" or not cfg.packed_io
                or not fused_tail_supported(cfg.model)):
            raise AssertionError(f"not the expected configuration: {cfg.to_json()}")
        want = {"pack_tail": 2 * steps, "pack_tail_backward": steps, "train_tail": steps}
        if launches != want:
            raise AssertionError(f"expected launches {want}, got {launches}")
        logs = sorted(Path(f"{run}/logs").glob("*.json"))
        metrics = json.loads(logs[-1].read_text())["metrics"]
        for m in metrics:
            vals = [m[k] for k in ("d_loss", "g_loss", "d_real_mean", "d_fake_mean")]
            if not np.all(np.isfinite(vals)):
                raise AssertionError(f"non-finite metrics: {m}")
            if not 0.0 < m["d_accuracy"] < 1.0:
                raise AssertionError(f"d_accuracy {m['d_accuracy']} outside (0, 1)")

        # The same seeded run with the D step's generator tail on the module
        # path B2 replaces: what the route alone does to the losses.
        ts.fused_tail_supported = lambda m: False
        try:   # a new trainer: its graph is captured on the module route
            run_cli(train_cli.main, [f"{tmp}/run_module" if a == run else a for a in argv])
        finally:
            ts.fused_tail_supported = fused_tail_supported
        logs = sorted(Path(f"{tmp}/run_module/logs").glob("*.json"))
        mod = json.loads(logs[-1].read_text())["metrics"][-1]
        print(f"{tag}: last epoch d_loss / g_loss / d_accuracy with the D-step tail on B2 "
              + " / ".join(f"{metrics[-1][k]:.4f}" for k in ("d_loss", "g_loss", "d_accuracy"))
              + ", on the module path "
              + " / ".join(f"{mod[k]:.4f}" for k in ("d_loss", "g_loss", "d_accuracy")),
              flush=True)

        # Parameters, BN statistics and spectral-norm vectors moved from the
        # seeded init.
        init = create_train_state(cfg, "cuda")
        mgr = CheckpointManager(f"{run}/checkpoints", cfg)
        state, extras = mgr.restore("latest", "cuda")
        if state.step != steps or extras["epoch"] != epochs - 1:
            raise AssertionError(f"restored step {state.step}, epoch {extras['epoch']}")
        for name, a, b in (("G", init.g, state.g), ("D", init.d, state.d)):
            for (pn, p0), p1 in zip(a.named_parameters(), b.parameters()):
                if torch.equal(p0, p1):
                    raise AssertionError(f"{name} parameter {pn} did not move")
        for b0, b1 in zip(init.g.buffers(), state.g.buffers()):
            if torch.equal(b0, b1):
                raise AssertionError("a G BatchNorm running statistic did not move")
        us = [blk.u for blk in state.d.blocks]
        u_keys = [f"{D_STATE}blocks/{i}/u" for i in range(len(us))]
        u_init = [b.u for b in init.d.blocks]
        if v20:   # the projection head's u (8192,)
            us, u_init = us + [state.d.class_embed_u], u_init + [init.d.class_embed_u]
            u_keys.append(f"{D_STATE}class_embed/u")
        if sn:
            for key, u0, u1 in zip(u_keys, u_init, us):
                norm = float(torch.linalg.vector_norm(u1))
                if torch.equal(u0, u1) or abs(norm - 1.0) > 1e-4:
                    raise AssertionError(f"D {key}: moved {not torch.equal(u0, u1)}, "
                                         f"norm {norm}")
            with np.load(Path(mgr.resolve("latest")) / D_WEIGHTS) as f:
                saved = [f[key] for key in u_keys]
            if not all(np.array_equal(u.cpu().numpy(), v) for u, v in zip(us, saved)):
                raise AssertionError("the restored u's differ from the saved ones")
        if v20:
            # The LR Adam applied at the last step: the linear schedule's at
            # count steps - 1 (D's span = G's, n_critic = 1).
            applied = {}
            for net, opt, lr in (("G", state.g_opt, 2e-4), ("D", state.d_opt, 1e-4)):
                want_lr = linear_lr(lr, steps, steps - 1)
                applied[net] = float(opt["lr"])
                if int(opt["count"]) != steps or abs(applied[net] - want_lr) > 1e-6 * want_lr:
                    raise AssertionError(f"{net}: count {int(opt['count'])}, last LR "
                                         f"{applied[net]!r}, schedule {want_lr!r}")
            print(f"{tag}: the last step applied LR {applied['G']:.6e} (G) and "
                  f"{applied['D']:.6e} (D), the linear schedule's at count {steps - 1}",
                  flush=True)

        from siggan_tpu_torch.data.dataset import SignatureDataset
        ds = SignatureDataset(data, size)
        images = torch.from_numpy(ds.images).cuda()
        labels = torch.from_numpy(ds.writer_labels()[0]).long().cuda() if v20 else None
        if v20:
            serve_conditional(run, card)
        else:
            # The saved generator serves: on the B4 kernel path at 64 px, on
            # the module path at 128 px (B4 is a 64 px kernel).
            model, _ = load_generator(f"{run}/checkpoints", "cuda")
            gf.LAUNCHES.reset()
            session = GeneratorSession(model, compute_dtype="float32", use_pallas=True,
                                       device="cuda")
            imgs = session.sample(64, seed=1)
            if imgs.shape != (64, size, size, 1) or not np.isfinite(imgs).all() \
                    or np.abs(imgs).max() > 1 or session.uses_kernel != (size == 64) \
                    or (gf.LAUNCHES.count > 0) != (size == 64):
                raise AssertionError(f"the trained generator does not serve {size} px "
                                     f"images on the expected path")

        # Resume restores the step counter (and, with SN, the u's).
        trainer = GANTrainer(cfg, np.zeros((64, size, size, 1), np.float32), device="cuda",
                             labels=np.zeros(64, np.int32) if v20 else None)
        if not trainer.resume("latest") or trainer.state.step != steps \
                or trainer.start_epoch != epochs:
            raise AssertionError("resume did not restore the step counter")
        if sn and not all(torch.equal(a, b) for a, b in zip(
                [blk.u for blk in trainer.state.d.blocks] + (
                    [trainer.state.d.class_embed_u] if v20 else []), us)):
            raise AssertionError("resume did not restore the spectral-norm vectors")
        if v20:
            # The schedule goes on from the restored count: one more epoch on
            # a span of epochs + 1 (graphed), its last LR the schedule's.
            more = cfg.replace(epochs=epochs + 1, checkpoint_dir=f"{tmp}/more/c",
                               sample_dir=f"{tmp}/more/s", log_dir=f"{tmp}/more/l",
                               optim=dataclasses.replace(cfg.optim, lr_total_steps=steps
                                                         + steps // epochs))
            trainer = GANTrainer(more, ds.images, device="cuda", labels=ds.writer_labels()[0])
            trainer.state, _ = CheckpointManager(f"{run}/checkpoints", more).restore(
                "latest", "cuda")
            trainer.start_epoch = epochs
            trainer.train()
            total = more.optim.lr_total_steps
            got_lr, want_lr = float(trainer.state.g_opt["lr"]), linear_lr(2e-4, total, total - 1)
            if trainer.state.step != total or abs(got_lr - want_lr) > 1e-6 * want_lr:
                raise AssertionError(f"resumed: step {trainer.state.step}, last LR {got_lr!r}, "
                                     f"schedule {want_lr!r}")
            print(f"{tag}: resumed at step {steps} and trained to {total} on the graphed "
                  f"dispatch; last LR {got_lr:.6e}, the schedule's at count {total - 1}",
                  flush=True)

        # Graphed windows against eager steps on copies of the trained state;
        # for v2.0 with the EMA shadow on and the LR decaying over the windows.
        ge_cfg, ge_state = cfg, state
        if v20:
            ge_cfg = cfg.replace(ema_decay=0.999, optim=dataclasses.replace(
                cfg.optim, lr_total_steps=2 * steps))
            ge_state = copy.deepcopy(state)
            ge_state.g_ema = copy_generator(ge_state.g)
        agreement, after = graphed_vs_eager(tag, ge_cfg, n_images, images, ge_state, k, labels)
        if v20:
            last = steps + 2 * k - 1
            lrs = {"G": (float(after.g_opt["lr"]), linear_lr(2e-4, 2 * steps, last)),
                   "D": (float(after.d_opt["lr"]), linear_lr(1e-4, 2 * steps, last))}
            for net, (got_lr, want_lr) in lrs.items():
                if abs(got_lr - want_lr) > 1e-6 * want_lr or not got_lr < (
                        2e-4 if net == "G" else 1e-4):
                    raise AssertionError(f"{net}: LR after the graphed windows {got_lr!r}, "
                                         f"schedule {want_lr!r}")
            agreement["lr_after_windows"] = lrs
            print(f"{tag}: after 2 graphed windows from step {steps} the LRs are the "
                  f"schedule's at count {last}: {json.dumps(lrs)} (captured at step "
                  f"{steps + 2})", flush=True)

        routes, per, gper = profile_routes(cfg, n_images, images, state, k, labels)

        def mean_of(rows):
            wall = sum(r[0] for r in rows) / len(rows)
            busy = None if any(r[1] is None for r in rows) else sum(r[1] for r in rows) / len(rows)
            return wall, busy, sum(r[2] for r in rows) / len(rows)
        wall10, busy, n_ops = mean_of(routes["eager B2"])
        g_wall, g_busy, g_ops = mean_of(routes["graphed B2"])

    last = metrics[1:][-2:] or metrics   # epoch 0 holds the first-use warm-up
    ms = sum(m["ms_per_step"] for m in last) / len(last)
    ips = sum(m["images_per_sec"] for m in last) / len(last)
    flops = step_flops(cfg, cfg.batch_size)
    print(f"{tag}: last {len(last)} epochs {ms:.3f} ms/step, {ips:.1f} images/s "
          f"(host clock per epoch, CLI) [{card}]", flush=True)
    for m in metrics:
        print(f"  epoch {m['epoch']}: d_loss {m['d_loss']:.4f} g_loss {m['g_loss']:.4f} "
              f"d_accuracy {m['d_accuracy']:.4f} ms/step {m['ms_per_step']:.3f}", flush=True)
    for how, (w, b, o), n in (("eager, 10 profiled steps", (wall10, busy, n_ops), 10),
                              (f"graphed, {k}-step windows", (g_wall, g_busy, g_ops), k)):
        idle = "not measured" if b is None else f"{1 - b / w:.4f}"
        print(f"{tag}: {how}: wall {w:.3f} ms/step, device busy {fmt_ms(b)}/step, "
              f"idle share {idle}, {o:.0f} device operations per step [{card}]", flush=True)
    for route, rows in routes.items():
        print(f"{tag}: {route.split()[0]}, D-step tail on {route.split()[1]}: " + "; ".join(
            f"wall {w:.3f} ms/step, device busy {fmt_ms(b)}/step, {o:.0f} device "
            f"operations per step" for w, b, o in rows) + f" [{card}]", flush=True)
    for name, t in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  top kernel (eager) {t / 10:.4f} ms/step  {name[:100]}", flush=True)
    for name, t in sorted(gper.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  top kernel (graphed) {t / k:.4f} ms/step  {name[:100]}", flush=True)
    for name, t in gper.items():
        if "pack_tail_bwd" in name:
            print(f"  B1' inside the graphed step: device {t / k:.4f} ms/step [{card}]",
                  flush=True)
    print(f"{tag}: model FLOPs per step {flops / 1e9:.2f} GFLOP; train_step_mfu "
          f"{flops / (ms * 1e-3) / BF16_PEAK_FLOPS:.5f} of the dense bf16 peak "
          f"(989 TFLOP/s) at {ms:.3f} ms/step [{card}]", flush=True)
    print(f"{tag}: graphed vs eager: {json.dumps(agreement)}", flush=True)
    return launches


EVAL_TOL_NOTE = ("card against CPU on the same weights, TF32 off inside the eval code: "
                 "Inception features allclose rtol 1e-4 atol 1e-5 (the f32 bar), LPIPS "
                 "distances and D(x) probabilities rtol 1e-4 atol 1e-6; f32 sums in "
                 "another order (cuDNN's algorithms against the CPU's)")


def close(what: str, got, want, rtol: float, atol: float) -> float:
    import numpy as np
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    if not np.all(np.isfinite(got)) or not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max abs diff {err:.3e} outside rtol {rtol} atol {atol}")
    return err


def conv_flops(model, fn) -> float:
    """The FLOPs of the convolutions ``fn()`` runs in ``model`` (2 per MAC,
    from each conv's output shape), counted with forward hooks."""
    import torch
    total = [0.0]

    def hook(mod, _, out):
        kh, kw = mod.kernel_size
        total[0] += 2.0 * out.numel() * mod.in_channels // mod.groups * kh * kw
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def eval_phase(card: str, work: str):
    """Phase 10: the evaluation path on phase 7's trained model and PNGs
    (``work``): ``cli.evaluate`` through B4, the eval networks on the card
    against the CPU, a FID sanity check, the stage times, and
    ``cli.train --fid_interval 1``. Returns B4's and B3's launches in the
    evaluation CLI's run."""
    import numpy as np
    import torch
    from siggan_tpu_torch.ckpt.manager import CheckpointManager, load_generator, save_generator
    from siggan_tpu_torch.cli import evaluate as eval_cli
    from siggan_tpu_torch.cli import train as train_cli
    from siggan_tpu_torch.core.config import TrainConfig
    from siggan_tpu_torch.data.dataset import SignatureDataset
    from siggan_tpu_torch.eval import fid as fid_mod
    from siggan_tpu_torch.eval import lpips as lpips_mod
    from siggan_tpu_torch.eval.common import batched_apply, full_f32
    from siggan_tpu_torch.infer.generate import load_session
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import upsample as up

    data, run = f"{work}/data", f"{work}/run"
    model, cfg7 = load_generator(f"{run}/checkpoints", "cuda")
    ckpt = save_generator(f"{work}/eval_ckpt", model, TrainConfig(
        model=model.cfg, use_pallas=True, compute_dtype="float32"))

    # 1. cli.evaluate on phase 7's model, 512 samples x 2 seeds, through B4.
    gf.LAUNCHES.reset()
    up.LAUNCHES.reset()
    t0 = time.perf_counter()
    run_cli(eval_cli.main, ["--checkpoint", str(ckpt), "--data_dir", data, "--n_samples",
                            "512", "--seeds", "0", "1", "--output_dir", f"{work}/eval"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"generator_forward": gf.LAUNCHES.count, "upsample_block": up.LAUNCHES.count}
    batches = 2 * math.ceil(512 / 64)
    if launches != {"generator_forward": batches, "upsample_block": 3 * batches}:
        raise AssertionError(f"evaluation path launches {launches}, expected B4 x{batches}")
    report = json.loads(Path(f"{work}/eval/evaluation_report.json").read_text())
    m = report["metrics"]
    if m["errors"]:
        raise AssertionError(f"cli.evaluate recorded errors: {m['errors']}")
    if not (np.isfinite(m["fid"]) and m["fid"] > 0 and np.isfinite(m["kid_mean"])
            and 0 <= m["precision"] <= 1 and 0 <= m["recall"] <= 1
            and np.isfinite(m["lpips_diversity"]) and m["lpips_diversity"] > 0
            and "stroke_density" in m and "foreground_ratio" in m
            and m["fid_backbone"] == "random-init" and report["n_real"] == 2048):
        raise AssertionError(f"cli.evaluate report: {json.dumps(m)[:2000]}")
    for f in ("fake_grid.png", "real_grid.png", "sample_grid_1.png", "sample_grid_3.png"):
        if not Path(f"{work}/eval/{f}").exists():
            raise AssertionError(f"cli.evaluate wrote no {f}")
    ms_ = m["multi_seed"]
    print(f"eval: cli.evaluate (512 samples x seeds 0 1, 2048 real) in {cli_s:.1f} s: FID "
          f"{m['fid']:.4f} (seeds {ms_['fid']['mean']:.4f} +- {ms_['fid']['std']:.4f}), KID "
          f"{m['kid_mean']:.4g}, precision/recall {m['precision']:.4f} / {m['recall']:.4f}, "
          f"LPIPS diversity {m['lpips_diversity']:.4f}, stroke density fake "
          f"{m['stroke_density']['fake']['mean']:.4f} real "
          f"{m['stroke_density']['real']['mean']:.4f}; launches {json.dumps(launches)} "
          f"[{card}]", flush=True)

    # 2. The eval networks on the card against the CPU module, same weights.
    real = SignatureDataset(data, 64).images
    session = load_session(str(ckpt), device="cuda")
    x = real[:64]
    cpu_scorer = fid_mod.FIDScorer(batch_size=64, device="cpu")
    scorer = fid_mod.FIDScorer(batch_size=256, device="cuda")
    feat_err = close("Inception features card vs CPU", scorer.features(x),
                     cpu_scorer.features(x), 1e-4, 1e-5)
    rgb = np.repeat(x, 3, axis=-1)
    dists = {}
    for where in ("cpu", "cuda"):
        lp = lpips_mod.init_lpips(0).to(where)
        dists[where] = batched_apply(lambda a, b: lpips_mod.distance(lp, a, b), rgb[:32],
                                     rgb[32:], batch_size=32, device=torch.device(where))
    lpips_err = close("LPIPS distances card vs CPU", dists["cuda"], dists["cpu"], 1e-4, 1e-6)
    d_card = CheckpointManager(f"{run}/checkpoints", cfg7).restore("latest", "cuda")[0].d
    d_cpu = copy.deepcopy(d_card).cpu()
    fakes = session.sample(64, seed=5)
    both = np.concatenate([fakes, x])
    p_card = session.score_with_discriminator(both, d_card)
    d_err = close("D(x) card vs CPU", p_card, session.score_with_discriminator(both, d_cpu),
                  1e-4, 1e-6)
    print(f"eval: card vs CPU on 64 images ({EVAL_TOL_NOTE}): Inception features max abs "
          f"diff {feat_err:.3e}, LPIPS {lpips_err:.3e} (32 pairs), D(x) {d_err:.3e} (mean "
          f"D(fake) {p_card[:64].mean():.4f}, D(real) {p_card[64:].mean():.4f})", flush=True)

    # 3. FID sanity and the stage times.
    t0 = time.perf_counter()
    fr = scorer.features(real)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    noise = np.random.RandomState(0).uniform(-1, 1, (1024, 64, 64, 1)).astype(np.float32)
    fid_rr = fid_mod.frechet_distance(*scorer._condition(fr[:1024], fr[1024:]))
    fid_rn = fid_mod.frechet_distance(*scorer._condition(fr[:1024], scorer.features(noise)))
    if not fid_rr < fid_rn:
        raise AssertionError(f"FID(real half, real half) {fid_rr} >= FID(real, noise) {fid_rn}")
    print(f"eval: FID(real 1024, real 1024) {fid_rr:.4f} < FID(real 1024, uniform noise "
          f"1024) {fid_rn:.4f}", flush=True)
    sample_ms = time_ms(lambda: session.sample(64, seed=0), iters=10)
    batch = torch.from_numpy(real[:256]).cuda()
    lp = lpips_mod.init_lpips(0).cuda()
    pa = torch.from_numpy(np.repeat(real[:256], 3, axis=-1)).cuda()
    with torch.inference_mode():
        inc_flops = conv_flops(scorer.model, lambda: scorer._extract(batch))
        lp_flops = conv_flops(lp, lambda: lpips_mod.distance(lp, pa, pa.flip(0)))
        with full_f32():
            inc_ms = time_ms(lambda: scorer._extract(batch), iters=5, warmup=2)
            lp_ms = time_ms(lambda: lpips_mod.distance(lp, pa, pa.flip(0)), iters=10)
        # A yardstick the port does not use: the same forward with TF32 allowed.
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            inc_tf32_ms = time_ms(lambda: scorer._extract(batch), iters=5, warmup=2)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    ff = fr[:512] + 0.1   # the CLI's shapes: 2048 real and 512 fake features
    host = {}
    for name, fn in (("FID", lambda: fid_mod.frechet_distance(fr, ff)),
                     ("KID", lambda: fid_mod.kernel_distance(fr, ff)),
                     ("precision/recall", lambda: fid_mod.precision_recall(fr[:512], ff))):
        t0 = time.perf_counter()
        fn()
        host[name] = (time.perf_counter() - t0) * 1e3
    n_inc, n_lp = len(batch), len(pa)
    stages = {"sample_ms_per_64": sample_ms, "inception_images_per_s": n_inc / inc_ms * 1e3,
              "inception_gflop_per_image": inc_flops / n_inc / 1e9,
              "inception_tflops": inc_flops / inc_ms / 1e9,
              "inception_tf32_images_per_s": n_inc / inc_tf32_ms * 1e3,
              "inception_2048_features_s": feat_s, "lpips_pairs_per_s": n_lp / lp_ms * 1e3,
              "lpips_tflops": lp_flops / lp_ms / 1e9, "host_ms": host, "cli_s": cli_s}

    # 4. In-training FID on the graphed dispatch, then cli.evaluate --which best.
    run2, run0 = f"{work}/run_fid", f"{work}/run_nofid"
    t0 = time.perf_counter()
    out = run_cli(train_cli.main, ["--data_dir", data, "--epochs", "2", "--fid_interval", "1",
                                   "--checkpoint_interval", "1", "--run_dir", run2,
                                   "--device", "cuda"])
    train_s = time.perf_counter() - t0
    # The same run without FID, for its ms/step beside the FID run's.
    run_cli(train_cli.main, ["--data_dir", data, "--epochs", "2", "--checkpoint_interval", "1",
                             "--run_dir", run0, "--device", "cuda"])
    no_fid = json.loads(sorted(Path(f"{run0}/logs").glob("*.json"))[-1].read_text())["metrics"]
    if re.search(r"Dispatch: \d+ steps per call .* graph of one step", out) is None:
        raise AssertionError("the FID run did not train on the graphed dispatch")
    fid_lines = re.findall(r"FID epoch (\d+): ([0-9.]+) in ([0-9.]+) s", out)
    metrics = json.loads(sorted(Path(f"{run2}/logs").glob("*.json"))[-1].read_text())["metrics"]
    fids = [mm.get("fid", float("nan")) for mm in metrics]
    idx = json.loads(Path(f"{run2}/checkpoints/index.json").read_text())
    if len(fids) != 2 or not np.all(np.isfinite(fids)) or len(fid_lines) != 2 \
            or idx.get("best_fid") != min(fids) or idx.get("best") != int(np.argmin(fids)):
        raise AssertionError(f"in-training FID: logged {fids}, index {idx}")
    run_cli(eval_cli.main, ["--checkpoint", f"{run2}/checkpoints", "--which", "best",
                            "--data_dir", data, "--n_samples", "64", "--seeds", "0",
                            "--output_dir", f"{work}/eval_best"])
    best = json.loads(Path(f"{work}/eval_best/evaluation_report.json").read_text())
    if best["metrics"]["errors"] or best["which"] != "best":
        raise AssertionError(f"cli.evaluate --which best: {best['metrics']['errors']}")
    p7 = json.loads(sorted(Path(f"{run}/logs").glob("*.json"))[-1].read_text())["metrics"]
    p7_ms = sum(mm["ms_per_step"] for mm in p7[1:]) / len(p7[1:])
    fid_s = [float(t) for _, _, t in fid_lines]
    print(f"eval: cli.train --fid_interval 1, 2 epochs in {train_s:.1f} s: FIDs "
          f"{' / '.join(f'{f:.4f}' for f in fids)}, best epoch {idx['best']}; last epoch "
          f"{metrics[-1]['ms_per_step']:.3f} ms/step beside the same run's without FID "
          f"{no_fid[-1]['ms_per_step']:.3f} and phase 7's {p7_ms:.3f} (epochs 1-2); "
          f"cli.evaluate --which best ran [{card}]", flush=True)
    stages["in_training_fid_s"] = fid_s
    stages["fid_run_ms_per_step"] = metrics[-1]["ms_per_step"]
    stages["no_fid_run_ms_per_step"] = no_fid[-1]["ms_per_step"]
    for line in (f"sampling through B4: {sample_ms:.4f} ms per 64 images (session.sample, "
                 f"host to host)",
                 f"Inception features at 299: {stages['inception_images_per_s']:.1f} "
                 f"images/s (batch 256, f32, TF32 off; "
                 f"{stages['inception_gflop_per_image']:.3f} GFLOP of convs an image, "
                 f"{stages['inception_tflops']:.2f} TFLOP/s of the "
                 f"{F32_PEAK_FLOPS / 1e12:.0f} f32 peak; with TF32 allowed, which the "
                 f"port does not, {stages['inception_tf32_images_per_s']:.1f}); 2048 images "
                 f"with resize and copies {feat_s:.3f} s",
                 f"LPIPS-Alex at 64 px: {stages['lpips_pairs_per_s']:.1f} pairs/s (256 pairs, "
                 f"{stages['lpips_tflops']:.2f} TFLOP/s of convs)",
                 "host math on 2048 real x 512 fake features: " + ", ".join(
                     f"{k} {v:.1f} ms" for k, v in host.items()),
                 f"cli.evaluate, n=512 x 2 seeds: {cli_s:.1f} s",
                 f"in-training FID (512 fakes; the first epoch builds the scorer and the "
                 f"real features): {' / '.join(f'{t:.2f}' for t in fid_s)} s per epoch"):
        print(f"eval stage: {line} [{card}]", flush=True)
    return launches, stages


VERIFY_TOL_NOTE = ("card against CPU: preprocessing (CLAHE) allclose atol 1e-5 with equal valid "
                   "flags (the float64 integral image is exact on both; the rest elementwise "
                   "or exact counts); verifier scores rtol 1e-4 atol 1e-5 (the f32 bar, TF32 "
                   "off in the verifier code)")


def write_scans(raw: Path, n_writers: int = 55, per_writer: int = 24, seed: int = 31) -> int:
    """CEDAR-shaped raw scans: ``generate_labeled_dataset(55, 24, 64)``
    upscaled to scan size with aspect jitter (about one in ten past the
    512 px canvas), the ink darkened by a scan contrast of 1.3-2.0, on a
    white page with small margins and light paper specks, written as PNG in
    per-writer directories (``wNN/wNN_KK.png``). Returns the number
    written."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from siggan_tpu_torch.data.synthetic import generate_labeled_dataset
    from siggan_tpu_torch.infer.export import encode_png

    images, labels = generate_labeled_dataset(n_writers, per_writer, 64, seed=seed)
    rs = np.random.RandomState(seed)
    counts = [0] * n_writers
    for img, lab in zip(images, labels):
        big = rs.rand() < 0.1
        base = rs.uniform(8.2, 10.0) if big else rs.uniform(3.0, 6.5)
        aspect = rs.uniform(0.8, 1.25)
        w, h = int(64 * base * aspect), int(64 * base / aspect)
        ink = (1.0 - img[..., 0]) * 127.5 * rs.uniform(1.3, 2.0)
        t = torch.from_numpy(np.clip(255.0 - ink, 0.0, 255.0))[None, None]
        sig = F.interpolate(t, size=(h, w), mode="bilinear", align_corners=False)[0, 0].numpy()
        mx, my = (int(rs.uniform(0.01, 0.04) * d) + 2 for d in (w, h))
        page = np.full((h + 2 * my, w + 2 * mx), 255.0)
        page[my:my + h, mx:mx + w] = sig
        k = rs.randint(5, 20)
        page[rs.randint(0, page.shape[0], k), rs.randint(0, page.shape[1], k)] = rs.uniform(
            160, 230, k)
        d = raw / f"w{lab:02d}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"w{lab:02d}_{counts[lab]:02d}.png").write_bytes(
            encode_png(np.clip(np.round(page), 0, 255).astype(np.uint8)))
        counts[lab] += 1
    return sum(counts)


def verification_phase(card: str, work: str):
    """Phase 11: the verification experiment on the card: raw scans ->
    ``cli.preprocess``; phase 7's model (``use_pallas``, phase 10's
    checkpoint) -> ``cli.generate`` 512 images through B4; baseline and
    augmented verifiers by ``cli.verifier_train``; ``cli.verifier_eval``;
    ``cli.evaluate --backbone verifier:<baseline pkl>``. Returns B4's and
    B3's launches on the path and the stage times."""
    import numpy as np
    import torch
    from siggan_tpu_torch.cli import evaluate as eval_cli
    from siggan_tpu_torch.cli import generate as gen_cli
    from siggan_tpu_torch.cli import preprocess as pre_cli
    from siggan_tpu_torch.cli import verifier_eval as veval_cli
    from siggan_tpu_torch.cli import verifier_train as vtrain_cli
    from siggan_tpu_torch.data import preprocess as pp
    from siggan_tpu_torch.data.dataset import list_images
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import upsample as up
    from siggan_tpu_torch.verify import train as vtrain
    from siggan_tpu_torch.verify.pairs import PairDataset

    w = Path(work)
    raw, clean, synth = w / "scans", w / "clean", w / "synthetic"
    vmodels, veval, vfid = w / "verifiers", w / "verifier_eval", w / "verifier_fid"
    gf.LAUNCHES.reset()
    up.LAUNCHES.reset()

    # 1. Raw scans, CEDAR's size: 55 writers x 24 genuine signatures.
    t0 = time.perf_counter()
    n_scans = write_scans(raw)
    scans_s = time.perf_counter() - t0

    # 2. cli.preprocess on the card; one 64-scan batch card vs CPU.
    t0 = time.perf_counter()
    run_cli(pre_cli.main, ["--input_dir", str(raw), "--output_dir", str(clean)])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    rep = json.loads((clean / "preprocess_report.json").read_text())
    n_ok, n_bad = len(rep["processed"]), len(rep["invalid"])
    if n_ok + n_bad != n_scans or n_scans != 1320 or n_ok < n_scans // 2:
        raise AssertionError(f"cli.preprocess: {n_ok} processed + {n_bad} invalid of {n_scans}")
    paths = list_images(raw)[:64]
    canv, hws = zip(*(pre_cli.load_canvas(p_, 512) for p_ in paths))
    canv, hws = torch.from_numpy(np.stack(canv)), torch.from_numpy(np.asarray(hws, np.int32))
    cpu_img, cpu_ok = pp.preprocess_batch(canv, hws)
    img, ok = pp.preprocess_batch(canv.cuda(), hws.cuda())
    if not torch.equal(ok.cpu(), cpu_ok):
        raise AssertionError("preprocessing valid flags differ between the card and the CPU")
    pre_err = close("preprocessing card vs CPU", img.cpu().numpy(), cpu_img.numpy(), 0, 1e-5)
    canv_d, hws_d = canv.cuda(), hws.cuda()
    gpu_batch_ms = time_ms(lambda: pp.preprocess_batch(canv_d, hws_d), iters=5, warmup=1)
    print(f"verify: cli.preprocess on {n_scans} scans (55 writers x 24) in {pre_s:.2f} s "
          f"({n_scans / pre_s:.1f} images/s, host decode and letterbox included; writing the "
          f"scans took {scans_s:.2f} s): {n_ok} written, {n_bad} invalid "
          f"({n_bad / n_scans:.4f}); one 64-scan batch at 512 px on the card "
          f"{gpu_batch_ms:.3f} ms, card vs CPU max abs diff {pre_err:.3e} [{card}]", flush=True)

    # 3. The synthetic set: 512 images through B4 (and B3) from phase 7's model.
    ckpt = w / "eval_ckpt"
    b4, b3 = gf.LAUNCHES.count, up.LAUNCHES.count
    t0 = time.perf_counter()
    run_cli(gen_cli.main, ["--checkpoint", str(ckpt), "--n_samples", "512", "--output_dir",
                           str(synth)])
    gen_s = time.perf_counter() - t0
    gen_launches = (gf.LAUNCHES.count - b4, up.LAUNCHES.count - b3)
    if gen_launches != (8, 24) or len(list(synth.glob("*.png"))) != 512:
        raise AssertionError(f"cli.generate: launches (B4, B3) {gen_launches}, expected (8, 24)")

    # 4. Baseline and augmented verifiers, the JAX CLI's defaults.
    t0 = time.perf_counter()
    run_cli(vtrain_cli.main, ["--data_dir", str(clean), "--synthetic_dir", str(synth),
                              "--output_dir", str(vmodels)])
    vtrain_s = time.perf_counter() - t0
    hist = json.loads((vmodels / "training_history.json").read_text())
    timing = {}
    for name in ("baseline", "augmented"):
        r = hist[name]
        losses = [e["loss"] for e in r["history"]["train"]]
        if not (np.all(np.isfinite(losses)) and len(losses) == 20
                and (vmodels / f"verifier_{name}.pkl").exists()):
            raise AssertionError(f"verifier {name}: losses {losses}")
        secs = r["history"]["epoch_seconds"]
        per_epoch = r["steps"] // len(secs)
        timing[name] = {"s_per_model": r["seconds"], "steps": r["steps"],
                        "ms_per_step": 1e3 * float(np.mean(secs[1:])) / per_epoch,
                        "first_epoch_ms_per_step": 1e3 * secs[0] / per_epoch,
                        "best_val_accuracy": r["best_val_accuracy"],
                        "last_train_loss": losses[-1]}
    if not hist["baseline"]["best_val_accuracy"] > 0.5:
        raise AssertionError(f"baseline verifier at chance: {hist['baseline']}")

    # 5. cli.verifier_eval on both; 256 test pairs' scores card vs CPU.
    t0 = time.perf_counter()
    run_cli(veval_cli.main, ["--data_dir", str(clean), "--baseline_model",
                             str(vmodels / "verifier_baseline.pkl"), "--augmented_model",
                             str(vmodels / "verifier_augmented.pkl"), "--output_dir",
                             str(veval)])
    veval_s = time.perf_counter() - t0
    report = json.loads((veval / "evaluation_report.json").read_text())
    if set(report["models"]) != {"baseline", "augmented"} or "comparison" not in report \
            or not (veval / "curves.json").exists():
        raise AssertionError(f"cli.verifier_eval report: {list(report)}")
    ds = PairDataset(clean, pairs_per_user=20, seed=123)
    snap = vtrain.load_verifier(vmodels / "verifier_baseline.pkl")
    sc = {where: vtrain.predict_scores(vtrain.model_from_snapshot(snap, where),
                                       ds.img1[:256], ds.img2[:256], 128)
          for where in ("cpu", "cuda")}
    score_err = close("verifier scores card vs CPU", sc["cuda"], sc["cpu"], 1e-4, 1e-5)

    # 6. The verifier: FID backbone on phase 7's model and PNGs.
    b4, b3 = gf.LAUNCHES.count, up.LAUNCHES.count
    t0 = time.perf_counter()
    run_cli(eval_cli.main, ["--checkpoint", str(ckpt), "--data_dir", str(w / "data"),
                            "--n_samples", "512", "--seeds", "0", "--backbone",
                            f"verifier:{vmodels / 'verifier_baseline.pkl'}",
                            "--output_dir", str(vfid)])
    vfid_s = time.perf_counter() - t0
    fid_launches = (gf.LAUNCHES.count - b4, up.LAUNCHES.count - b3)
    m = json.loads((vfid / "evaluation_report.json").read_text())["metrics"]
    if m["errors"] or not np.isfinite(m["fid"]) or "fid_real_floor" not in m \
            or "feature_diversity" not in m or fid_launches != (8, 24):
        raise AssertionError(f"verifier FID: launches {fid_launches}, {json.dumps(m)[:1500]}")
    launches = {"generator_forward": gf.LAUNCHES.count, "upsample_block": up.LAUNCHES.count}
    if launches != {"generator_forward": 16, "upsample_block": 48}:
        raise AssertionError(f"verification path launches {launches}")

    comp = report["comparison"]
    print(f"verify: EER baseline {comp['eer']['values']['baseline']:.4f} augmented "
          f"{comp['eer']['values']['augmented']:.4f}, ROC-AUC "
          f"{comp['roc_auc']['values']['baseline']:.4f} / "
          f"{comp['roc_auc']['values']['augmented']:.4f}, accuracy "
          f"{comp['accuracy']['values']['baseline']:.4f} / "
          f"{comp['accuracy']['values']['augmented']:.4f}; best val accuracy "
          f"{timing['baseline']['best_val_accuracy']:.4f} / "
          f"{timing['augmented']['best_val_accuracy']:.4f}; scores of 256 pairs card vs CPU "
          f"max abs diff {score_err:.3e} ({VERIFY_TOL_NOTE}); verifier FID {m['fid']:.4f}, "
          f"real floor {m['fid_real_floor']:.4f}, feature diversity fake "
          f"{m['feature_diversity']['fake']:.4f} real {m['feature_diversity']['real']:.4f}; "
          f"launches {json.dumps(launches)} [{card}]", flush=True)
    stages = {"preprocess_s": pre_s, "preprocess_images_per_s": n_scans / pre_s,
              "preprocess_invalid_share": n_bad / n_scans, "preprocess_batch64_ms": gpu_batch_ms,
              "generate_512_s": gen_s, "verifier_train_cli_s": vtrain_s,
              "verifier": timing, "verifier_eval_s": veval_s, "verifier_fid_s": vfid_s,
              "write_scans_s": scans_s}
    for line in (f"cli.preprocess, 1320 scans at canvas 512: {pre_s:.2f} s "
                 f"({stages['preprocess_images_per_s']:.1f} images/s); the device pipeline "
                 f"alone {gpu_batch_ms:.3f} ms per 64",
                 f"cli.generate 512 images through B4: {gen_s:.2f} s",
                 "cli.verifier_train (20 epochs, batch 32, 10 pairs a user): " + "; ".join(
                     f"{k} {v['ms_per_step']:.3f} ms/step (epochs 2-20; epoch 1 "
                     f"{v['first_epoch_ms_per_step']:.3f}), {v['steps']} steps, "
                     f"{v['s_per_model']:.2f} s/model" for k, v in timing.items())
                 + f"; the CLI {vtrain_s:.2f} s",
                 f"cli.verifier_eval (2 models, 20 pairs a user): {veval_s:.2f} s",
                 f"cli.evaluate --backbone verifier: (512 samples, 1 seed): {vfid_s:.2f} s"):
        print(f"verify stage: {line} [{card}]", flush=True)
    return launches, stages


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 1
    from siggan_tpu_torch.core import rng
    from siggan_tpu_torch.core.config import ModelConfig
    from siggan_tpu_torch.models.generator import init_fn
    from siggan_tpu_torch.ops.kernels import build

    card = nvidia_smi_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    sass = {lib: tensor_core_sass(lib) for lib in ("train_tail", "upsample", "generator_fwd")}
    for lib, counts in sass.items():
        for fn, count in sorted(counts.items()):
            print(f"  {lib} SASS: {count} tensor-core instructions in {fn}", flush=True)

    def tc_kernels(lib, names):
        """The tensor-core instruction counts of ``lib``'s kernels whose name
        holds one of ``names``; fails if one of those names has none."""
        found = {fn: c for fn, c in sass[lib].items() if any(k in fn for k in names)}
        for k in names:
            counts = [c for fn, c in found.items() if k in fn]
            if not counts or min(counts) == 0:
                raise AssertionError(f"{lib}: {k} has no tensor-core instructions: {found}")
        return found
    tiles = tc_kernels("train_tail", ["convt_mma_kernel"])
    b3_sass = tc_kernels("upsample", ["convt_tile_kernel"])
    b4_sass = tc_kernels("generator_fwd", ["convt_tile_kernel", "gen_tail_kernel"])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = ModelConfig()  # full-width 64 px unconditional generator
    model = init_fn(rng.generator(0, rng.STREAM_INIT_G), cfg, dev).eval()
    calibrate(model, torch.randn(256, cfg.latent_dim,
                                 generator=torch.Generator().manual_seed(3)).to(dev))

    with torch.no_grad():
        b3, b4 = check_kernels(model, dev)
    launches = serve_phase(model, card)
    b1 = check_pack_tail(dev)
    b2 = check_train_tail(dev)
    b2_route = check_fused_route(dev)
    with tempfile.TemporaryDirectory() as work:
        paths = {"train 64 px": train_phase(card, keep=work),
                 "train v1.1 128 px": train_phase(card, 128, epochs=2, n_images=1024),
                 "train v2.0": train_phase(card, v20=True)}
        eval_launches, stages = eval_phase(card, work)
        verify_launches, verify_stages = verification_phase(card, work)
    launches.update(paths["train 64 px"])
    launches["train_tail"] = paths["train v1.1 128 px"]["train_tail"]

    def entry(name, route, source, replaces, d):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": d["max_abs_diff"],
                "ms": d["kernel_ms"], "plain_ms": d["plain_ms"],
                "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                "library_ms": d["library_ms"],
                "max_abs_diff": d["max_abs_diff"], "tol": TOL_NOTE,
                "kernel_ms": d["kernel_ms"], "device_ms": d.get("device_ms")}

    b4_line = entry("generator_forward", "cuda", "siggan_tpu_torch/csrc/generator_fwd.cu",
                    "siggan_tpu/ops/pallas/generator_fwd.py:142", b4)
    b4_line.update(library="port module forward, cuDNN f32, TF32 off (batch 64); bound: "
                           "the FLOPs of the blocks and the final conv as 3xTF32 at the TF32 "
                           "dense peak plus the fc's at the f32 CUDA-core peak "
                           "(cuda_core_bound_ms: all FLOPs at the f32 CUDA-core peak)",
                   tensor_core_sass=b4_sass, cuda_core_bound_ms=b4["cuda_core_bound_ms"],
                   device_kernels=b4["device_kernels"],
                   launches_by_path={"serving": launches["generator_forward"],
                                     "evaluation": eval_launches["generator_forward"],
                                     "verification": verify_launches["generator_forward"]},
                   eval_stages=stages, verification_stages=verify_stages)
    b3_line = entry("upsample_block", "cuda", "siggan_tpu_torch/csrc/convt_phase.cuh",
                    "siggan_tpu/ops/pallas/upsample.py:89", b3)
    b3_line.update(library="F.conv_transpose2d (no affine epilogue); times and bounds are "
                           "sums over the shapes of blocks 1-3 at batch 64, the ones the "
                           "served forward launches (block 4's shape, off the main path, is "
                           "in shapes); bound: 3xTF32 at the TF32 dense peak "
                           "(cuda_core_bound_ms: f32 CUDA-core peak)",
                   shapes=b3["shapes"], tensor_core_sass=b3_sass,
                   cuda_core_bound_ms=b3["cuda_core_bound_ms"],
                   launches_by_path={"serving": launches["upsample_block"],
                                     "evaluation": eval_launches["upsample_block"],
                                     "verification": verify_launches["upsample_block"]})
    b1_tol = "torch.equal (a copy and a cast)"
    b1_line = entry("pack_tail", "cuda", "siggan_tpu_torch/csrc/pack_tail.cu",
                    "siggan_tpu/ops/packed.py:636", b1["bfloat16"]["fwd"])
    b1_line.update(tol=b1_tol, f32=b1["float32"]["fwd"],
                   library="torch.take of the zero-extended flat weights by the "
                           "constant index map, + cast to bf16; bf16 output")
    b1b_line = entry("pack_tail_backward", "cuda", "siggan_tpu_torch/csrc/pack_tail.cu",
                     "siggan_tpu/ops/packed.py:719", b1["bfloat16"]["bwd"])
    b1b_line.update(tol="allclose rtol 1e-5 atol 1e-6: f32 sums of up to 4 "
                        "placements, taken in another order by the plain version",
                    f32=b1["float32"]["bwd"],
                    library="index_add_ of the flat cotangent (cast to f32); bf16 input")
    for line in (b1_line, b1b_line):
        line["launches_by_path"] = {k: v[line["name"]] for k, v in paths.items()}
    b2_line = entry("train_tail", "cuda", "siggan_tpu_torch/csrc/train_tail.cu",
                    "siggan_tpu/ops/pallas/train_tail.py:154", b2[128]["bfloat16"])
    b2_line.update(tol=B2_TOL_NOTE, launches_by_path={k: v["train_tail"]
                                                      for k, v in paths.items()},
                   f32=b2[128]["float32"], px64=b2[64], vs_module_path=b2_route,
                   tensor_core_sass=tiles,
                   library="the port's no-grad module-path tail (cuDNN convs, "
                           "PyTorch BN and elementwise ops), bf16; 128 px, batch 64; "
                           "bound: the larger of the FLOPs at the bf16 dense peak and "
                           "the bytes (inputs, outputs, each pre-BN intermediate "
                           "written and read once) at the HBM rate "
                           "(cuda_core_bound_ms: the FLOPs at the f32 non-tensor peak)")
    print(json.dumps({"kernels": [b4_line, b3_line, b1_line, b1b_line, b2_line]}),
          flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
