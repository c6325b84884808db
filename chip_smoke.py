#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``siggan_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel from ``siggan_tpu_torch/csrc`` (one nvcc per source,
     started together) and print the build time and ptxas summaries;
  3. hold each kernel against its plain PyTorch version at the full-width
     64 px generator's shapes (batch 64, and batch 10 for the generator),
     and time kernel, plain version and a library yardstick with CUDA events;
  4. serve a full-width generator (random weights from a seed) through the
     port's HTTP server on port 0, send five requests, and check that the
     generator kernel's launch counters rose, that the images decode, repeat
     for a seed and agree with the cuDNN path;
  5. hold the packed-tail pack kernels B1 and B1' against their plain
     versions at the full-width tail shapes, in bf16 and f32 (forward
     bit-equal, backward within rtol 1e-5 / atol 1e-6), and time kernel,
     plain version and a library yardstick (torch.take / index_add_);
  6. train: write 2048 synthetic 64 px PNGs, run the port's training CLI on
     the card for 3 epochs of 32 steps at TrainConfig() defaults (bf16,
     batch 64, packed I/O), and check finite losses, D accuracy in (0, 1),
     that G, D and G's BN statistics moved, that B1 launched twice and B1'
     once per step, that the saved generator serves on the kernel path,
     and that resuming restores the step counter; then profile 10 steps for
     the device busy time, idle share and top kernels, and report the
     step's model FLOPs against the bf16 peak;
  7. print the kernels line (one JSON object), the nvidia-smi line again,
     and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zipfile
from pathlib import Path

F32_PEAK_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores (data sheet)
BF16_PEAK_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
RTOL, ATOL = 1e-4, 1e-4
TOL_NOTE = ("allclose rtol 1e-4 atol 1e-4: f32 FMA sums taken in another "
            "order than the plain version's matmuls")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
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


def check_kernels(model, dev):
    """Phase 3: every kernel against its plain version, with timings."""
    import torch
    import torch.nn.functional as F
    from siggan_tpu_torch.core import rng
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import upsample as up

    packed = gf.pack_generator(model)
    g = rng.generator(0, rng.STREAM_FIXED)
    z64 = torch.randn(64, model.cfg.latent_dim, generator=g).to(dev)
    z10 = torch.randn(10, model.cfg.latent_dim, generator=g).to(dev)

    # B3 at the four block shapes, on the generator's own block inputs.
    with torch.no_grad():
        c0 = packed["bfc16"].shape[-1]
        h = torch.relu(torch.einsum("nk,pkc->npc", z64, packed["wfc16"])
                       + packed["bfc16"]).reshape(64, 4, 4, c0)
    b3 = {"max_abs_diff": 0.0, "kernel_ms": 0.0, "plain_ms": 0.0,
          "library_ms": 0.0, "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0,
          "shapes": []}
    cases = []
    for i, (blk, pb) in enumerate(zip(model.blocks, packed["blocks"])):
        cases.append((f"block{i + 1}", h, blk.weight, pb, True))
        h = up.convt_phase_reference(h, pb["taps"], pb["scale"], pb["offset"])
    x4, w4 = cases[-1][1], model.blocks[-1].weight
    g2 = torch.Generator().manual_seed(2)
    relu_off = {"taps": packed["blocks"][-1]["taps"],
                "scale": (torch.rand(w4.shape[1], generator=g2) + 0.5).to(dev),
                "offset": torch.randn(w4.shape[1], generator=g2).to(dev)}
    cases.append(("block4_no_relu", x4, w4, relu_off, False))
    for name, x, w_iohw, pb, relu in cases:
        n, hh, ww, cin = x.shape
        cout = w_iohw.shape[1]
        w9 = up.pack_w9(w_iohw.permute(2, 3, 0, 1).contiguous())
        got = up.upsample_block(x, w9, pb["scale"], pb["offset"], relu=relu)
        ref = up.upsample_block_reference(x, w9, pb["scale"], pb["offset"], relu=relu)
        if not relu and float(got.min()) >= 0:
            raise AssertionError(f"{name}: ReLU was not off")
        err = compare(f"upsample_block {name}", got, ref)
        k_ms = time_ms(lambda: up.upsample_block_taps(x, pb["taps"], pb["scale"],
                                                      pb["offset"], relu))
        p_ms = time_ms(lambda: up.upsample_block_reference(x, w9, pb["scale"],
                                                           pb["offset"], relu))
        x_nchw = x.permute(0, 3, 1, 2)
        l_ms = time_ms(lambda: F.conv_transpose2d(x_nchw, w_iohw, stride=2, padding=1))
        flops = 2.0 * 16 * n * cin * cout * hh * ww
        nbytes = 4.0 * (x.numel() + 16 * cin * cout + 2 * cout + got.numel())
        b_ms, b_by = bound(flops, nbytes)
        print(f"upsample_block {name} x{tuple(x.shape)}->{cout} relu={relu}: "
              f"max_abs_diff {err:.3e}, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"conv_transpose2d {l_ms:.4f} ms (no affine epilogue), "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        b3["shapes"].append({"case": name, "x": list(x.shape), "cout": cout,
                             "relu": relu, "max_abs_diff": err, "kernel_ms": k_ms,
                             "plain_ms": p_ms, "library_ms": l_ms,
                             "bound_ms": b_ms, "bound_by": b_by})
        b3["max_abs_diff"] = max(b3["max_abs_diff"], err)
        if relu:  # the four blocks of one batch-64 forward
            for k, v in (("kernel_ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                         ("flops", flops), ("bytes", nbytes)):
                b3[k] += v
    b3["bound_ms"], b3["bound_by"] = bound(b3["flops"], b3["bytes"])

    # B4 at batch 64 and at an odd batch.
    b4 = {"max_abs_diff": 0.0}
    for z in (z64, z10):
        img = gf.generator_forward(packed, z)
        ref = gf.generator_forward_reference(packed, z)
        if img.shape != (z.shape[0], 64, 64, 1):
            raise AssertionError(f"generator_forward shape {tuple(img.shape)}")
        if float(img.std()) <= 0.1:
            raise AssertionError(f"image std {float(img.std()):.3f}: images too flat")
        b4["max_abs_diff"] = max(b4["max_abs_diff"],
                                 compare(f"generator_forward n={z.shape[0]}", img, ref))
    b4["kernel_ms"] = time_ms(lambda: gf.generator_forward(packed, z64))
    per, b4["device_ms"], _ = device_time(lambda: gf.generator_forward(packed, z64))
    for name, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"  generator_forward device time: {ms:.4f} ms  {name[:90]}", flush=True)
    _, b3["device_ms"], _ = device_time(lambda: [
        up.upsample_block_taps(x, pb["taps"], pb["scale"], pb["offset"], True)
        for _, x, _, pb, relu in cases if relu])
    b4["plain_ms"] = time_ms(lambda: gf.generator_forward_reference(packed, z64))
    with torch.no_grad():
        b4["library_ms"] = time_ms(lambda: model(z64, None, torch.float32))
    zdim, c = z64.shape[1], packed["wfin"].shape[2]
    macs = zdim * 16 * c0 + 9 * c * 64 * 64 + sum(
        16 * b["taps"].shape[3] * b["taps"].shape[4] * (4 * 2 ** i) ** 2
        for i, b in enumerate(packed["blocks"]))
    weights = sum(t.numel() for t in (packed["wfc16"], packed["bfc16"],
                                      packed["wfin"], packed["bfin"]))
    weights += sum(b[k].numel() for b in packed["blocks"]
                   for k in ("taps", "scale", "offset"))
    b4["flops"], b4["bytes"] = 2.0 * 64 * macs, 4.0 * (z64.numel() + weights + 64 * 64 * 64)
    b4["bound_ms"], b4["bound_by"] = bound(b4["flops"], b4["bytes"])
    print(f"generator_forward batch 64: max_abs_diff {b4['max_abs_diff']:.3e}, "
          f"kernel {b4['kernel_ms']:.4f} ms, plain {b4['plain_ms']:.4f} ms, "
          f"cuDNN module path f32 {b4['library_ms']:.4f} ms, "
          f"bound {b4['bound_ms']:.4f} ms ({b4['bound_by']}, "
          f"{b4['flops'] / 1e9:.3f} GFLOP, {b4['bytes'] / 1e6:.2f} MB)", flush=True)
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
        f_ms = time_ms(lambda: pt.pack_tail_launch(ws, dt))
        fp_ms = time_ms(lambda: pt.pack_tail_reference(ws, dt))
        fl_ms = time_ms(lambda: torch.take(flat, idx).to(dt))
        b_ms = time_ms(lambda: pt.pack_tail_backward_launch(ws, cts))
        bp_ms = time_ms(lambda: pt.pack_tail_backward_reference(ws, cts))
        bl_ms = time_ms(lambda: torch.zeros(n_in + 1, device=dev).index_add_(
            0, idx, ct_flat.float()))
        # Bytes: each input read once, each output written once; no FLOPs in
        # B1, one add per non-zero placement in B1' (negligible).
        nbytes = 4.0 * n_in + isz * n_out
        bound_f, by_f = bound(0.0, nbytes)
        bound_b, by_b = bound(float(int((idx < n_in).sum())), nbytes)
        print(f"pack_tail {name}: {n_in} canonical -> {n_out} packed values; B1 bit-equal, "
              f"kernel {f_ms:.4f} ms (device {fmt_ms(f_dev)}), plain {fp_ms:.4f} ms, "
              f"take+cast {fl_ms:.4f} ms, "
              f"bound {bound_f * 1e3:.3f} us ({by_f}); B1' max_abs_diff {err:.3e}, "
              f"kernel {b_ms:.4f} ms (device {fmt_ms(b_dev)}), plain {bp_ms:.4f} ms, "
              f"index_add_ {bl_ms:.4f} ms, "
              f"bound {bound_b * 1e3:.3f} us ({by_b})", flush=True)
        out[name] = {"fwd": {"max_abs_diff": 0.0, "kernel_ms": f_ms, "plain_ms": fp_ms,
                             "library_ms": fl_ms, "bound_ms": bound_f, "bound_by": by_f,
                             "device_ms": f_dev},
                     "bwd": {"max_abs_diff": err, "kernel_ms": b_ms, "plain_ms": bp_ms,
                             "library_ms": bl_ms, "bound_ms": bound_b, "bound_by": by_b,
                             "device_ms": b_dev}}
    return out


def step_flops(cfg, batch: int) -> float:
    """Model FLOPs of one default train step (n_critic=1), counted from the
    canonical layer shapes: 2 FLOPs per MAC; a trained layer's forward +
    input gradient + weight gradient is 3 forwards. G: forward in the D
    step, forward + both gradients in the G step (4 forwards of batch b).
    D: forward + both gradients over the 2b batch of the D step, forward +
    input gradient over b in the G step (3 x 2b + 2 x b forwards)."""
    from siggan_tpu_torch.models.generator import channel_schedule as g_sched
    from siggan_tpu_torch.models.discriminator import channel_schedule as d_sched
    c0, blocks = g_sched(cfg.model)
    g_macs = cfg.model.latent_dim * 16 * c0 + 9 * blocks[-1][1] * 64 * 64
    side = 4
    for ci, co in blocks:
        g_macs += 16 * ci * co * side * side
        side *= 2
    d_macs, side = 512 * 4 * 4, cfg.model.image_size
    for ci, co in d_sched(cfg.model):
        side //= 2
        d_macs += 16 * ci * co * side * side
    return 2.0 * (4 * batch * g_macs + (3 * 2 * batch + 2 * batch) * d_macs)


def train_phase(card: str):
    """Phase 6: the port's training path, through its CLI, at full width."""
    import numpy as np
    import torch
    from siggan_tpu_torch.ckpt.manager import CheckpointManager, load_generator
    from siggan_tpu_torch.cli import train as train_cli
    from siggan_tpu_torch.core.config import TrainConfig
    from siggan_tpu_torch.core.state import create_train_state
    from siggan_tpu_torch.data.synthetic import save_dataset_pngs
    from siggan_tpu_torch.infer.generate import GeneratorSession
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    from siggan_tpu_torch.train.train_step import make_resident_train_step
    from siggan_tpu_torch.train.trainer import GANTrainer

    epochs, n_images = 3, 2048
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = save_dataset_pngs(n_images, f"{tmp}/data", seed=0)
        print(f"train: wrote {n_images} synthetic PNGs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        run = f"{tmp}/run"
        argv = ["--data_dir", str(data), "--epochs", str(epochs),
                "--checkpoint_interval", "1", "--run_dir", run, "--device", "cuda"]
        pt.FWD_LAUNCHES.reset()
        pt.BWD_LAUNCHES.reset()
        t0 = time.perf_counter()
        if train_cli.main(argv) != 0:
            raise AssertionError("the training CLI failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"pack_tail": pt.FWD_LAUNCHES.count,
                    "pack_tail_backward": pt.BWD_LAUNCHES.count}
        print(f"train: CLI {epochs} epochs in {wall:.1f} s; main path launches: "
              f"{json.dumps(launches)}", flush=True)

        cfg = TrainConfig.from_json(open(f"{run}/checkpoints/config.json").read())
        if (cfg.model != TrainConfig().model or cfg.batch_size != 64
                or cfg.compute_dtype != "bfloat16" or not cfg.packed_io):
            raise AssertionError(f"not the default configuration: {cfg.to_json()}")
        steps = epochs * (n_images // cfg.batch_size)
        if launches != {"pack_tail": 2 * steps, "pack_tail_backward": steps}:
            raise AssertionError(f"expected B1 x{2 * steps} and B1' x{steps}, got {launches}")
        logs = sorted(Path(f"{run}/logs").glob("*.json"))
        metrics = json.loads(logs[-1].read_text())["metrics"]
        for m in metrics:
            vals = [m[k] for k in ("d_loss", "g_loss", "d_real_mean", "d_fake_mean")]
            if not np.all(np.isfinite(vals)):
                raise AssertionError(f"non-finite metrics: {m}")
            if not 0.0 < m["d_accuracy"] < 1.0:
                raise AssertionError(f"d_accuracy {m['d_accuracy']} outside (0, 1)")

        # Parameters and BN statistics moved from the seeded init.
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

        # The saved generator serves on the kernel path.
        model, _ = load_generator(f"{run}/checkpoints", "cuda")
        gf.LAUNCHES.reset()
        imgs = GeneratorSession(model, compute_dtype="float32", use_pallas=True,
                                device="cuda").sample(64, seed=1)
        if gf.LAUNCHES.count < 1 or not np.isfinite(imgs).all() or np.abs(imgs).max() > 1:
            raise AssertionError("the trained generator does not serve on the kernel path")

        # Resume restores the step counter.
        trainer = GANTrainer(cfg, np.zeros((64, 64, 64, 1), np.float32), device="cuda")
        if not trainer.resume("latest") or trainer.state.step != steps \
                or trainer.start_epoch != epochs:
            raise AssertionError("resume did not restore the step counter")

        # Profile 10 steps of the same resident step on the trained state.
        from siggan_tpu_torch.data.dataset import SignatureDataset
        images = torch.from_numpy(SignatureDataset(data, 64).images).cuda()
        step_fn, _ = make_resident_train_step(cfg, n_images)

        def ten():
            nonlocal state
            for _ in range(10):
                state, m = step_fn(state, images)
            return m
        ten()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ten()
        torch.cuda.synchronize()
        wall10 = (time.perf_counter() - t0) * 1e3 / 10
        per, busy, n_ops = device_time(ten, calls=1)
        busy = None if busy is None else busy / 10

    last = metrics[-2:]
    ms = sum(m["ms_per_step"] for m in last) / len(last)
    ips = sum(m["images_per_sec"] for m in last) / len(last)
    flops = step_flops(cfg, cfg.batch_size)
    print(f"train: last {len(last)} epochs {ms:.3f} ms/step, {ips:.1f} images/s "
          f"(host clock per epoch, CLI) [{card}]", flush=True)
    for m in metrics:
        print(f"  epoch {m['epoch']}: d_loss {m['d_loss']:.4f} g_loss {m['g_loss']:.4f} "
              f"d_accuracy {m['d_accuracy']:.4f} ms/step {m['ms_per_step']:.3f}", flush=True)
    idle = "not measured" if busy is None else f"{1 - busy / wall10:.4f}"
    print(f"train: 10 profiled steps: wall {wall10:.3f} ms/step, device busy "
          f"{'not measured' if busy is None else f'{busy:.4f}'} ms/step, "
          f"idle share {idle}, {n_ops / 10:.0f} device operations per step [{card}]",
          flush=True)
    for name, t in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  top kernel {t / 10:.4f} ms/step  {name[:100]}", flush=True)
    print(f"train: model FLOPs per step {flops / 1e9:.2f} GFLOP; train_step_mfu "
          f"{flops / (ms * 1e-3) / BF16_PEAK_FLOPS:.5f} of the dense bf16 peak "
          f"(989 TFLOP/s) at {ms:.3f} ms/step [{card}]", flush=True)
    return launches


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
    launches.update(train_phase(card))

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
    b4_line["library"] = "port module forward, cuDNN f32, TF32 off (batch 64)"
    b3_line = entry("upsample_block", "cuda", "siggan_tpu_torch/csrc/convt_phase.cuh",
                    "siggan_tpu/ops/pallas/upsample.py:89", b3)
    b3_line["library"] = ("F.conv_transpose2d (no affine epilogue); times are sums "
                          "over the four block shapes at batch 64")
    b3_line["shapes"] = b3["shapes"]
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
    print(json.dumps({"kernels": [b4_line, b3_line, b1_line, b1b_line]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
