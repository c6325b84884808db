#!/usr/bin/env python3
"""Time the serving kernels B3 and B4, and the served request, of several
versions of the port on one CUDA card, in turns, so that their numbers
compare.

    python3 scripts/serve_kernels_compare.py [--tree DIR ...] [VARIANT ...]

A ``--tree`` is another checkout of the repo, such as a ``git archive`` of
the parent commit unpacked under ``build/``. A VARIANT is a copy of this
checkout under ``build/variants/<name>/`` with one part of the kernels
changed or removed by the text replacements of ``VARIANTS``; the script
exits if a replacement no longer matches its source. All versions are
built at once (one ``nvcc`` per library), then each runs in a fresh
process, in the order this checkout, the others, and back (A, B, B, A).

A run makes the full-width 64 px generator from seed 0, calibrated as
``chip_smoke.py`` does, and at batch 64 prints one JSON line: B3's host call
(CUDA events, 20 calls after 3 warm-ups) and device time (profiler, 20
calls) per block shape, B4's host call and device time per kernel, the
largest error of each against its plain version (the variants that remove
arithmetic are wrong by design), and the wall clock of ``POST /generate``
n=64 base64 through the version's own HTTP server (9 requests after one
warm-up). The card's name and power limit come first; ptxas's register and
spill lines of each version are printed as it is built.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MMA_ASM = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
LO_PASSES = '''      for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mt][nj], al, bh[nj][0], bh[nj][1]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mt][nj], ah, bl[nj][0], bl[nj][1]);
'''
A_LOADS = '''      const float4 r0 = *reinterpret_cast<const float4*>(sa + (pix[mt][0] + off) * kPF + 4 * t);
      const float4 r1 = *reinterpret_cast<const float4*>(sa + (pix[mt][1] + off) * kPF + 4 * t);'''
A_FAKE = '''      const float4 r0 = make_float4(__int_as_float(pix[mt][0] + off), 1.f, 2.f, 3.f);
      const float4 r1 = make_float4(__int_as_float(pix[mt][1] + off), 1.f, 2.f, 3.f);'''
FINAL_MMA = '''          mma_tf32(tacc[nt], al, bh0, bh1);
          mma_tf32(tacc[nt], ah, __float_as_uint(b.z), __float_as_uint(b.w));
          mma_tf32(tacc[nt], ah, bh0, bh1);'''
B3 = "convt_phase.cuh"     # B3's tile kernel and the chunk loop B4's fused kernel shares
B4 = "generator_fwd.cu"    # B4's fc and fused block-4 + final conv kernels
# name -> [(file under siggan_tpu_torch/csrc, old, new)]
VARIANTS = {
    # every MMA a cheap ALU op on the same operands: the loads stay
    "no_mma": [(B3, MMA_ASM, "  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);")],
    # single-pass TF32 in the chunk loop (hi hi only): a third of its MMAs
    "one_pass": [(B3, LO_PASSES, LO_PASSES.replace("nj < 4", "nj < 0"))],
    # the A fragments made from registers instead of shared memory
    "no_a_loads": [(B3, A_LOADS, A_FAKE)],
    # the halo's global loads skipped (zeros staged)
    "no_halo_loads": [(B3, "    if (src[k] < 0 || ch >= Cin) continue;", "    if (true) continue;")],
    # the weights' cp.async skipped (the staged weights are stale)
    "no_weight_copies": [(B3, "  for (int rep = 0; rep < 16 * kPieces / kTileThreads; ++rep) {",
                          "  for (int rep = 0; rep < 0; ++rep) {")],
    # B3's epilogue skipped: no cluster sum, no affine, no global stores
    "no_epilogue": [(B3, "      if (m >= used || n >= a.N || i >= a.H || j >= a.W) continue;",
                     "      if (true) continue;")],
    "taps_unrolled": [(B3, "#pragma unroll 1  // unrolled", "#pragma unroll  // unrolled")],
    "one_block_per_sm": [(B3, "__launch_bounds__(kTileThreads, 2) convt_tile_kernel",
                          "__launch_bounds__(kTileThreads, 1) convt_tile_kernel")],
    "clusters_8_of_256": [(B3, "constexpr int kMaxSplit = 4;", "constexpr int kMaxSplit = 8;"),
                          (B3, "constexpr int kTargetBlocks = 128;",
                           "constexpr int kTargetBlocks = 256;")],
    "no_clusters": [(B3, "constexpr int kMaxSplit = 4;", "constexpr int kMaxSplit = 1;")],
    # the fused kernel's final-conv MMAs one ALU op each on the same operands
    # (block 4's accumulators stay live; the T tile and the 3x3 sums stay)
    "no_final_conv_mma": [(B4, FINAL_MMA, "          tacc[nt][0] += __uint_as_float("
                                          "al[0] ^ ah[1] ^ ah[2] ^ al[3] ^ bh0 ^ bh1);")],
    # the fused kernel owning 4 image rows a block instead of 8
    "rows_4": [(B4, "constexpr int kTailRows = 8;", "constexpr int kTailRows = 4;")],
}

BUILD = """
import sys
sys.path.insert(0, sys.argv[1])
from siggan_tpu_torch.ops.kernels import build
for name, log in build.build_all(["upsample", "generator_fwd"]).items():
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(name, line.strip())
"""

WORKER = r"""
import json, sys, tempfile, threading
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from siggan_tpu_torch.ckpt.manager import save_generator
from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.models.generator import init_fn
from siggan_tpu_torch.ops.kernels import generator_fwd as gf, upsample as up
from siggan_tpu_torch.serve.api import serve

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
cfg = ModelConfig()
model = init_fn(rng.generator(0, rng.STREAM_INIT_G), cfg, dev).eval()
cs.calibrate(model, torch.randn(256, cfg.latent_dim,
                                generator=torch.Generator().manual_seed(3)).to(dev))
out = {"version": sys.argv[2], "b3_host_ms": [], "b3_device_ms": [], "b3_max_abs_err": []}
with torch.no_grad():
    packed = gf.pack_generator(model)
    z = torch.randn(64, cfg.latent_dim, generator=rng.generator(0, rng.STREAM_FIXED)).to(dev)
    h = torch.relu(torch.einsum("nk,pkc->npc", z, packed["wfc16"]) + packed["bfc16"])
    h = h.reshape(64, 4, 4, -1)
    for pb in packed["blocks"]:
        # a checkout from before the packed TF32 split has no taps_mma
        extra = (pb["taps_mma"],) if "taps_mma" in pb else ()
        call = lambda x=h, pb=pb, extra=extra: up.upsample_block_taps(
            x, pb["taps"], pb["scale"], pb["offset"], True, *extra)
        ref = up.convt_phase_reference(h, pb["taps"], pb["scale"], pb["offset"])
        out["b3_max_abs_err"].append(float((call() - ref).abs().max()))
        out["b3_host_ms"].append(cs.time_ms(call))
        out["b3_device_ms"].append(cs.device_time(call, 20)[1])
        h = ref
    per, out["b4_device_ms"], _ = cs.device_time(lambda: gf.generator_forward(packed, z), 20)
    out["b4_device_kernels"] = {k.split("(")[0]: v for k, v in per.items()}
    out["b4_host_ms"] = cs.time_ms(lambda: gf.generator_forward(packed, z))
    out["b4_max_abs_err"] = float((gf.generator_forward(packed, z)
                                   - gf.generator_forward_reference(packed, z)).abs().max())
with tempfile.TemporaryDirectory() as ckpt:
    save_generator(ckpt, model, TrainConfig(model=cfg, use_pallas=True,
                                            compute_dtype="float32"))
    server = serve("127.0.0.1", 0, ckpt, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/generate"
        req = {"n": 64, "format": "base64", "seed": 5}
        cs.http(url, req)
        out["request_ms"] = sorted(cs.http(url, req)[2] for _ in range(9))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
out["request_median_ms"] = out["request_ms"][4]
print(json.dumps(out))
"""


def make_copy(name: str) -> Path:
    d = ROOT / "build" / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "siggan_tpu_torch", d / "siggan_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d)
    for file, old, new in VARIANTS[name]:
        path = d / "siggan_tpu_torch" / "csrc" / file
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {file} no longer holds {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], help="another checkout to time")
    ap.add_argument("variants", nargs="*", help=f"variants of this checkout: {sorted(VARIANTS)}")
    args = ap.parse_args()
    unknown = [n for n in args.variants if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dirs = {"this": ROOT, **{f"tree:{t}": Path(t).resolve() for t in args.tree},
            **{n: make_copy(n) for n in args.variants}}
    builds = {n: subprocess.Popen([sys.executable, "-c", BUILD, str(d)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for n, d in dirs.items()}
    failed = 0
    for n, proc in builds.items():
        log, _ = proc.communicate()
        print(json.dumps({"version": n, "build_rc": proc.returncode,
                          "ptxas": log.strip().splitlines()}), flush=True)
        failed = failed or proc.returncode
    if failed:
        return failed
    names = list(dirs)
    for n in names + names[::-1]:
        run = subprocess.run([sys.executable, "-c", WORKER, str(dirs[n]), n],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
