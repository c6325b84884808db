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
  5. print the kernels line (one JSON object), the nvidia-smi line again,
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

F32_PEAK_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores (data sheet)
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
    """Device time per call from a profiler trace: ({kernel: ms}, total ms),
    CUDA kernels and copies only. An empty trace gives ({}, None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.self_device_time_total / 1e3 / calls
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    return per, (sum(per.values()) if per else None)


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
    per, b4["device_ms"] = device_time(lambda: gf.generator_forward(packed, z64))
    for name, ms in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"  generator_forward device time: {ms:.4f} ms  {name[:90]}", flush=True)
    _, b3["device_ms"] = device_time(lambda: [
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
            _, busy = device_time(lambda: http(base + "/generate", req), calls=5)
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

    b3, b4 = check_kernels(model, dev)
    launches = serve_phase(model, card)

    def entry(name, route, source, replaces, d):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": d["max_abs_diff"],
                "ms": d["kernel_ms"], "plain_ms": d["plain_ms"],
                "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                "library_ms": d["library_ms"],
                "max_abs_diff": d["max_abs_diff"], "tol": TOL_NOTE,
                "kernel_ms": d["kernel_ms"], "device_ms": d["device_ms"]}

    b4_line = entry("generator_forward", "cuda", "siggan_tpu_torch/csrc/generator_fwd.cu",
                    "siggan_tpu/ops/pallas/generator_fwd.py:142", b4)
    b4_line["library"] = "port module forward, cuDNN f32, TF32 off (batch 64)"
    b3_line = entry("upsample_block", "cuda", "siggan_tpu_torch/csrc/convt_phase.cuh",
                    "siggan_tpu/ops/pallas/upsample.py:89", b3)
    b3_line["library"] = ("F.conv_transpose2d (no affine epilogue); times are sums "
                          "over the four block shapes at batch 64")
    b3_line["shapes"] = b3["shapes"]
    print(json.dumps({"kernels": [b4_line, b3_line]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
