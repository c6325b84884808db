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
 12. the host decoders (``decode_phase``): build ``data/native/decode.cpp``
     and ``webp.cpp`` with g++ and decode every fixture of ``tests/data/torch_port/`` (JPEG
     at 4:4:4, 4:2:2 and 4:2:0 at scan size, grey, restart intervals,
     optimised tables; BMP 1/8/24/32-bit; TIFF raw, PackBits, LZW with
     predictor 2, 1-bit WhiteIsZero, RGB; CCITT Group 4, 2-D T.4 with EOL
     fill bits, Modified Huffman and a Group 4 page at 1200 x 500; PNG
     palette, 16-bit, Adam7; progressive JPEG grey, 4:2:0 with optimised
     tables and restarts, and a 1200 x 500 page whose golden is
     scan_420.jpg's; Deflate with predictor 2; JPEG-in-TIFF YCbCr 4:2:0 and
     grey; a restart marker missing, a bad Huffman code, quantizers of 64;
     CMYK and YCCK JPEG, CMYK TIFF; a cut progressive script that libjpeg
     smooths; old-style JPEG-in-TIFF grey and 4:2:0 in both layouts;
     float32 with predictor 3, int16, uint32, 12-bit and int32 TIFF;
     lossless and arithmetic-coded JPEG) bit-equal to its golden array
     (PIL's grey, saved where the
     fixtures were written: this host has no PIL), a Deflate page written
     here with zlib from scan_420.jpg's grey bit-equal to it, a restart-
     damaged and a CMYK JPEG page tiled here from fixtures' restart
     intervals (``tile_jpeg``) and a CMYK TIFF page of scan_420.jpg's grey
     bit-equal to the greys they were built from, the cut progressive page
     bit-equal to PIL's grey by its digest, 1200 x 500 pages of the
     newest kinds built here (``a6_pages``: scan_420.jpg as old-style
     JPEG-in-TIFF, its grey as float32 with predictor 3, arithmetic and
     lossless pages from restart intervals) bit-equal to PIL's grey by
     their digests, and a 12-bit JPEG (which PIL refuses) a zero image in a
     ``SignatureDataset``; time the threaded batch decode per format at 1
     and 8 threads (images/s, the pages apart); rewrite phase 11's 1320
     scans as a mixed tree in CEDAR's shape (PNG, BMP and uncompressed TIFF
     written here with numpy, JPEG copied from the fixtures), run
     ``cli.preprocess`` on it (wall time, images/s, the share of it that
     host decoding and letterboxing take) and build a ``SignatureDataset``
     on it (its decode time); the tree's PNG scans in turns GIF and PGM
     files under their .png names, and planar YCbCr old-style
     JPEG-in-TIFF, GIF and PGM pages (``a6_gif_pnm_pages``) held to PIL's
     grey by digest and timed; a file of each format PIL opens and the
     port does not read (``c21_files`` but ``C21_READ``), named .png beside
     a scan, stops its ``SignatureDataset`` naming the format and ROADMAP
     A.6, and the files of ``C21_READ`` (DIB, ICO, CUR, TGA, PCX, DCX, SGI,
     SUN, MSP, QOI, IM, PSD, XBM, XPM, BLP, DDS, SPIDER) read as the greys
     they were built from; Pillow's three
     WebP pages (``tests/data/torch_port_webp/``: lossy, lossless, lossy
     with ALPH) held to PIL's grey by digest and timed; phase 11's scans as
     lossless WebP files under .jpg and .png names (``webp_tree_step``):
     ``cli.preprocess`` writes and refuses what it did from their PNGs, and
     a ``SignatureDataset`` holds the PNGs' arrays; the 1200 x 500 pages of
     A.6.33-A.6.42 built here (``a6_raster_pages``: DIB, RLE TGA, PCX, DCX,
     ICO of a bitmap and of a PNG icon, CUR, RLE SGI and SUN, MSP version
     2, QOI) held to PIL's grey by digest and timed (the PNG icon through
     ``decode_images``); the pages of A.6.43-A.6.48 (``a6_text_pages``: IM,
     XBM, XPM, XV thumbnail, PSD raw and PackBits, planar YCbCr old-style
     JPEG-in-TIFF in tiles) and of A.6.49-A.6.55 (``a6_texture_pages``: DDS
     uncompressed, BC1, BC4 and BC7, FTEX, BLP2 DXT1 and palette, BLP1,
     SPIDER) the same; phase 11's scans in the formats of A.6.33-A.6.55 in
     turns under .png and .bmp names
     (``raster_tree_step``): ``cli.preprocess`` writes and refuses as many
     as on the CPU, and a ``SignatureDataset`` holds the greys written;
 13. shared fakes and the ablation grid (``shared_fakes_phase``,
     ``ablation_phase``): ``cli.train --share_fakes`` at full width on
     phase 7's 2048 PNGs for 2 epochs of 32 steps (B1 x1, B1' x1, B2 x0
     per step; finite losses; two graphed windows against eager steps, as
     in phase 7); then graphed windows of the default step and of the
     shared-fake step on copies of the trained state in turns (default,
     shared, shared, default: wall ms/step, device busy ms/step, idle
     share, device operations per step) and the eager shared-fake step;
     then ``cli.ablate`` over the full 12-run grid at full width in bf16,
     1 epoch of 32 steps a run (cut from 20 epochs), FID at 256 samples
     against 512 reals: each run's short name, losses, FID, ms/step and
     wall time, the tables, plots.json and 12 sample grids, and no kernel
     launch (the ablation step's G is unpacked); then (13c,
     ``fused_phase``) the fused generator forwards,
     ``TrainConfig(fuse_g_forwards=True)`` at full width through GANTrainer
     on phase 7's PNGs for 2 epochs of 32 steps on the graphed dispatch:
     finite losses, B1 x1, B1' x1, B2 x0 a step, the checkpoint served on
     B4, two graphed windows against eager steps (as in phase 7), 4 eager
     fused steps against 4 sequential ones on the same draws in f32 and
     bf16 (FUSE_NOTE's bars), n_critic 2 (3 groups a forward, still B1 x1
     and B1' x1 a step), and graphed windows of the default and the fused
     step in turns (default, fused, fused, default);
 14. a run of the JAX package and the control panel (``imported_run_phase``,
     ``panel_phase``): the committed run ``tests/data/torch_port/jax_run``
     (trained by the JAX package, converted by ``scripts/import_jax_run.py``)
     served through B4 against the JAX package's images of the same latents
     (rtol 1e-3, atol 1e-4), then resumed by ``cli.train --resume`` for one
     epoch of the run's 48 steps on phase 7's PNGs at batch 32 (epoch, step
     counter, fixed noise, finite
     losses, moved weights, B1 x2, B1' x1, B2 x1 a step); then the panel
     (``serve/app.py`` on port 0, on the card) over phase 7's run and the
     imported one, driven over HTTP: checkpoints, generate n=64 (B4 x1; the
     card's busy time), with the quality filter at keep_fraction 0.5 (B4 x2,
     D's scores), the imported run, interpolate, a generation job polled to
     its end, gallery, contact sheet, runs-compare chart, export zip, save
     with binarize and transparency, about, and a training subprocess at
     TrainConfig() defaults for 1 epoch polled through train_status to its
     end; the ms of each request. Phase 12 also decodes a PIL-saved PNG
     scan page (bit-equal to PIL's committed grey) and 1320 copies of it at
     1 and 8 threads, and runs ``cli.preprocess`` on them;
 15. the rest of the trainer, the host resize and the charts
     (``streaming_phase``): (a) one epoch at TrainConfig() defaults through
     GANTrainer on 262,208 images (phase 7's 2048 decoded images tiled 128
     times plus the first 64: 4097 MB f32, over resident_max_mb, so the
     set streams from host memory through data/loader.py::BatchLoader into
     a CUDA graph of one step): ms/step, images/s, peak allocated memory
     (under 1024 MB), launches (B1 8194, B1' 4097, B2 4097), finite losses,
     moved parameters, the checkpoint; (b) phase 7's 2048 images resident
     and streamed (resident_data=False) in turns, 2 epochs of 32 steps
     each (ms/step of epoch 1), the streamed graphed step's wall, busy time,
     idle share and operations (profiler, 16-step windows), 32 graphed
     streamed steps against eager ones (cuDNN deterministic), and v1.1
     streamed for 1 epoch of 16 steps on 1024 128 px images with its
     launches; (c) ``cli.train --profile_dir`` in a fresh process on phase
     7's PNGs, 2 epochs of 32: the trace of epoch 1 holds B2's kernels;
     (d) the C++ resize bit-equal to the numpy one on phase 12's 1320
     PIL-saved pages (6 sizes of the page, decode_images' arrays,
     cli.preprocess's PNGs), and both routes' decode_images images/s at 1
     and 8 threads and cli.preprocess s; (e) the verifier's four and the
     ablation's five charts, phase 7's progress montage and loss plot
     decode at their sizes, and its sample grids as a GIF decode (LZW,
     here) to the grids' grey, 30 cs a frame, loop 0;
 16. data parallelism on the one card (``dp_phase``): (a) the graphed
     resident trainer at TrainConfig() defaults, 2 epochs of 32 steps,
     without a mesh and under a one-rank NCCL process group (its all-reduces
     captured in the graph), cuDNN deterministic: bit-equal states, ms/step
     and busy ms/step of each (K-step windows in turns), collectives per
     step, B1/B1'/B2 launches; B2's layer route (per BN layer conv and
     totals, an all-reduce of the totals, the finalize) bit-equal to its
     single host call at both full-width tails and at batches 64, 32 and
     16, both timed; (b) two gloo ranks spawned on the card, eager steps
     of the 64 px default, its fused generator forwards and v1.1 at global
     batch 64 (32 rows each) in
     f32 (rtol 1e-4 atol 1e-5) and bf16 (a looser bar, printed) against one
     process's steps at batch 64, both sides under cuDNN's deterministic
     algorithms (``dp_two_ranks``: a repeat of one process's steps gives
     their bits, the spread is 3 permuted batches'), the ranks' states
     bitwise equal, B2's
     layer route over both ranks against its plain version with the same
     hook and against the single call on the whole batch;
 17. print the kernels line (one JSON object; B1, B1' and B2 with their
     launches by path, the streamed and the fused ones included, B4 and B3 with their
     launches on the serving, the evaluation, the verification, the
     imported-run and the panel paths), the nvidia-smi line again, and as
     the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import hashlib
import io
import copy
import json
import math
import os
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


def device_time(fn, calls: int = 10, cpu: bool = False):
    """Device time per call from a profiler trace: ({kernel: ms}, total ms,
    device operations launched), CUDA kernels and copies only. An empty
    trace gives ({}, None, 0). ``cpu`` traces the host too: late in this
    script a CUDA-only trace came back empty on the card (phase 14)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
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
    per, b4["device_ms"], b4["device_ops"] = device_time(
        lambda: gf.generator_forward(packed, z64))
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


FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "torch_port"
# Pillow's WebP pages (tests/test_torch_port_decode.py::write_webp_pages), beside
# the fixtures: they would take those past their 1 MB.
WEBP_PAGES = FIXTURES.parent / "torch_port_webp"
WEBP_PAGES_NAMES = ("webp_lossy_page.webp", "webp_lossless_page.webp", "webp_alpha_page.webp")


def bmp_grey(u8) -> bytes:
    """An 8-bit BMP of uint8 (H, W) grey with the identity palette."""
    import numpy as np
    h, w = u8.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = u8[::-1]
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
    pal[:, 3] = 0
    info = (40).to_bytes(4, "little") + w.to_bytes(4, "little") + h.to_bytes(4, "little") \
        + (1).to_bytes(2, "little") + (8).to_bytes(2, "little") + bytes(4) \
        + (rows.size).to_bytes(4, "little") + bytes(8) + (256).to_bytes(4, "little") + bytes(4)
    off = 14 + len(info) + pal.size
    return (b"BM" + (off + rows.size).to_bytes(4, "little") + bytes(4)
            + off.to_bytes(4, "little") + info + pal.tobytes() + rows.tobytes())


def tiff_grey(u8, rows_per_strip: int = 0, deflate: bool = False) -> bytes:
    """A little-endian TIFF of uint8 (H, W) grey in strips of
    ``rows_per_strip`` rows (0: one strip), uncompressed, or with
    ``deflate`` Deflate-compressed (compression 8, zlib level 6) with
    predictor 2, as libtiff writes a scan page."""
    return tiff_layout(u8[..., None], 8, 1, compression=8 if deflate else 1,
                       predictor=2 if deflate else 1, rows_per_strip=rows_per_strip)


def tiff_cmyk(u8, rows_per_strip: int = 0) -> bytes:
    """A little-endian CMYK TIFF (photometric 5, 4 samples of 8 bits) of
    uint8 (H, W) grey as ink: C = M = Y = 0 and K = 255 - grey, in Deflate
    strips (zlib level 6) of ``rows_per_strip`` rows (0: one strip). PIL's
    CMYK -> L gives back the grey exactly, so the file needs no golden
    array of its own (tests/test_torch_port_cmyk.py holds PIL to that)."""
    import numpy as np
    cmyk = np.zeros(u8.shape + (4,), np.uint8)
    cmyk[..., 3] = 255 - u8
    return tiff_layout(cmyk, 8, 5, compression=8, rows_per_strip=rows_per_strip)


def tile_jpeg(data: bytes, width: int, height: int, pick, renumber=None) -> bytes:
    """A JPEG of ``width`` x ``height`` built from the restart intervals of
    ``data``, a 4:4:4 JPEG (Huffman or arithmetic-coded, sequential) whose
    restart interval is one row of MCUs (8 pixel rows), no re-encoding:
    each MCU row of the new image is
    ``width // w`` of those intervals side by side, ``pick(i, j)`` naming
    the source row for row i, place j (each interval resets the DC
    predictions, and no sample of one MCU depends on another's, so the
    image is the source's rows tiled). ``renumber(k)`` may change the
    number of the k-th restart marker written (damage that libjpeg's
    resynchronisation takes back, such as a number 4 ahead). An
    arithmetic-coded interval starts its statistics afresh, as a Huffman
    one its DC predictions."""
    sof = next(i for i in range(len(data) - 1)
               if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC9))
    h, w = int.from_bytes(data[sof + 5:sof + 7], "big"), int.from_bytes(data[sof + 7:sof + 9], "big")
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    body = data[start:data.rindex(b"\xff\xd9")]
    cuts = [i for i in range(len(body) - 1) if body[i] == 0xFF and 0xD0 <= body[i + 1] <= 0xD7]
    rows = [body[a:b] for a, b in zip([0] + [c + 2 for c in cuts], cuts + [len(body)])]
    if len(rows) != h // 8 or width % w:
        raise ValueError("tile_jpeg wants one restart interval an MCU row and a width of whole rows")
    out, k = bytearray(), 0
    for i in range(-(-height // 8)):
        for j in range(width // w):
            if out:
                out += bytes([0xFF, 0xD0 + ((renumber(k) if renumber else k) & 7)])
                k += 1
            out += rows[pick(i, j)]
    head = bytearray(data[:start])
    head[sof + 5:sof + 9] = height.to_bytes(2, "big") + width.to_bytes(2, "big")
    return bytes(head + out) + b"\xff\xd9"


def page_pick(i: int, j: int) -> int:
    """``tile_jpeg``'s source row for row i, place j, of the 10 MCU rows of
    an 80-row fixture (``restart_444.jpg``, ``cmyk.jpg``)."""
    return (i + 3 * j) % 10


def renumber_ahead(k: int) -> int:
    """Every 16th restart marker numbered 4 ahead of its place: libjpeg's
    resynchronisation consumes it and decodes on, so the pixels stay."""
    return k + 4 if k % 16 == 5 else k


def tile_golden(golden, width: int, height: int, pick):
    """The grey of ``tile_jpeg(data, width, height, pick)`` from the source's."""
    import numpy as np
    w = golden.shape[1]
    out = np.empty((-(-height // 8) * 8, width), np.uint8)
    for i in range(out.shape[0] // 8):
        for j in range(width // w):
            r = pick(i, j)
            out[8 * i:8 * i + 8, w * j:w * j + w] = golden[8 * r:8 * r + 8]
    return out[:height]


# struct codes of the TIFF field types (ASCII and UNDEFINED as bytes).
TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 10: "i",
              11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}


def tiff_pack(w: int, h: int, blobs, entries, be: bool = False, big: bool = False) -> bytes:
    """A one-page TIFF: ``blobs`` after the header (each at an even offset),
    then the IFD of ``entries``, (tag, type, values): a type of
    ``TIFF_TYPES`` (RATIONAL and SRATIONAL a (numerator, denominator) a
    value, ASCII and UNDEFINED bytes), or (type written, type packed) to
    give an entry a type its values are not packed in; values may be a
    function of the blobs' offsets. ImageWidth and ImageLength are ``w`` and
    ``h`` unless ``entries`` give them. ``big``: BigTIFF (version 43, 8-byte
    offsets and counts, 20-byte entries)."""
    import struct
    o = ">" if be else "<"
    head = struct.pack(o + "2sHHHQ", b"MM" if be else b"II", 43, 8, 0, 0) if big else \
        struct.pack(o + "2sHI", b"MM" if be else b"II", 42, 0)
    data, offsets = bytearray(head), []
    for b in blobs:
        data += b"\0" * (len(data) & 1)
        offsets.append(len(data))
        data += b
    data += b"\0" * (len(data) & 1)
    given = {e[0] for e in entries}
    entries = sorted([e for e in [(256, 4, [w]), (257, 4, [h])] if e[0] not in given] + [
        (tag, typ, vals(offsets) if callable(vals) else vals) for tag, typ, vals in entries],
        key=lambda e: e[0])
    ifd_at = len(data)
    struct.pack_into(o + ("Q" if big else "I"), data, 8 if big else 4, ifd_at)
    slot = 8 if big else 4
    base = ifd_at + (8 + 20 * len(entries) + 8 if big else 2 + 12 * len(entries) + 4)
    tail = bytearray()
    ifd = bytearray(struct.pack(o + ("Q" if big else "H"), len(entries)))
    for tag, typ, vals in entries:
        code, pack = typ if isinstance(typ, tuple) else (typ, typ)
        if isinstance(vals, (bytes, bytearray)):
            raw, count = bytes(vals), len(vals)
        elif pack in (5, 10):
            raw, count = b"".join(struct.pack(o + 2 * TIFF_TYPES[pack], *v) for v in vals), len(vals)
        else:
            f = TIFF_TYPES[pack]
            raw = struct.pack(o + f * len(vals), *[v if f in "fd" else int(v) for v in vals])
            count = len(vals)
        ifd += struct.pack(o + ("HHQ" if big else "HHI"), tag, code, count)
        if len(raw) <= slot:
            ifd += raw.ljust(slot, b"\0")
        else:
            ifd += struct.pack(o + ("Q" if big else "I"), base + len(tail))
            tail += raw + b"\0" * (len(raw) & 1)
    return bytes(data + ifd + struct.pack(o + ("Q" if big else "I"), 0) + tail)


# T.4's run-length codes (ITU-T T.4 tables 2 and 3): terminating codes of
# runs 0-63, then make-up codes of 64, 128, ..., 1728, for white and black;
# the make-up codes of 1792, 1856, ..., 2560 both colours share.
CCITT_WHITE = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110",
    "1111", "10011", "10100", "00111", "01000", "001000", "000011",
    "110100", "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011", "0100100",
    "0011000", "00000010", "00000011", "00011010", "00011011", "00010010", "00010011",
    "00010100", "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100", "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100", "011001101", "011010010",
    "011010011", "011010100", "011010101", "011010110", "011010111", "011011000", "011011001",
    "011011010", "011011011", "010011000", "010011001", "010011010", "011000", "010011011",)
CCITT_BLACK = (
    "0000110111", "010", "11", "10", "011", "0011", "0010",
    "00011", "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000", "00001100111", "00001101000",
    "00001101100", "00000110111", "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110", "000011010111", "000001101100", "000001101101",
    "000011011010", "000011011011", "000001010100", "000001010101", "000001010110", "000001010111", "000001100100",
    "000001100101", "000001010010", "000001010011", "000000100100", "000000110111", "000000111000", "000000100111",
    "000000101000", "000001011000", "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111", "0000001111", "000011001000", "000011001001", "000001011011", "000000110011", "000000110100",
    "000000110101", "0000001101100", "0000001101101", "0000001001010", "0000001001011", "0000001001100", "0000001001101",
    "0000001110010", "0000001110011", "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011", "0000001100100", "0000001100101",)
CCITT_EXTENDED = (
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011", "000000010100", "000000010101",
    "000000010110", "000000010111", "000000011100", "000000011101", "000000011110", "000000011111",)


def ccitt_words(run: int, black: bool) -> list:
    """The T.4 code words of one run, each a string of bits."""
    codes, out = CCITT_BLACK if black else CCITT_WHITE, []
    while run >= 2560:
        out, run = out + [CCITT_EXTENDED[12]], run - 2560
    if run >= 1792:
        k = (run - 1792) // 64
        out, run = out + [CCITT_EXTENDED[k]], run - 1792 - 64 * k
    elif run >= 64:
        out, run = out + [codes[63 + run // 64]], run % 64
    return out + [codes[run]]


def ccitt_run(run: int, black: bool) -> str:
    """The T.4 code words of one run, as a string of bits."""
    return "".join(ccitt_words(run, black))


G4_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
               -3: "0000010"}


def g4_rows(black) -> list:
    """The T.6 (Group 4) code of each row of a bilevel (H, W) array, True
    for black, as a string of bits: coded against the row above (the first
    against a white line) in pass, vertical or horizontal mode (T.4 4.2)."""
    import numpy as np
    h, w = black.shape
    rows = []

    def changes(row):
        return list(np.flatnonzero(np.diff(np.concatenate([[False], row]).astype(np.int8)))) + [w, w]
    ref = changes(np.zeros(w, bool))
    for y in range(h):
        cur, bits = changes(black[y]), []
        a0, colour = -1, False
        while a0 < w:
            a1 = next(c for c in cur if c > a0)
            a2 = next(c for c in cur if c > a1) if a1 < w else w
            # b1: the next change on the reference line to the colour opposite
            # a0's (changes alternate, the first to black), b2 the one after.
            k = next((i for i, c in enumerate(ref) if c > a0 and (i % 2 == 0) != colour), None)
            b1, b2 = (ref[k], ref[k + 1] if k + 1 < len(ref) else w) if k is not None else (w, w)
            if b2 < a1:
                bits.append("0001")
                a0 = b2
            elif abs(a1 - b1) <= 3:
                bits.append(G4_VERTICAL[a1 - b1])
                a0, colour = a1, not colour
            else:
                bits.append("001" + ccitt_run(a1 - max(a0, 0), colour) + ccitt_run(a2 - a1, not colour))
                a0 = a2
        rows.append("".join(bits))
        ref = cur
    return rows


def fax_bytes(bits: str) -> bytes:
    """A string of bits, MSB first, padded with 0 bits to a whole byte."""
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def g4_encode(black) -> bytes:
    """T.6 (Group 4) data of a bilevel (H, W) array, True for black
    (``g4_rows``), then EOFB."""
    return fax_bytes("".join(g4_rows(black)) + "000000000001" * 2)


def tiff_g4(black, *, tile=None, photometric: int = 0, tags=()) -> bytes:
    """A little-endian Group 4 TIFF of a bilevel (H, W) array (True for
    black, 1 bits of WhiteIsZero): one strip, or tiles of ``tile`` = (tw,
    th), each coded on its own and padded white past the image's edges;
    ``tags`` more (tag, type, values)."""
    import numpy as np
    h, w = black.shape
    if tile is None:
        blobs, layout = [g4_encode(black)], [(273, 4, lambda o: o), (278, 4, [h])]
    else:
        tw, th = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw), bool)
        pad[:h, :w] = black
        blobs = [g4_encode(pad[y:y + th, x:x + tw]) for y in range(0, pad.shape[0], th)
                 for x in range(0, pad.shape[1], tw)]
        layout = [(322, 4, [tw]), (323, 4, [th]), (324, 4, lambda o: o)]
    count = 325 if tile else 279
    return tiff_pack(w, h, blobs, [(258, 3, [1]), (259, 3, [4]), (262, 3, [photometric]),
                                   (277, 3, [1]), (count, 4, [len(b) for b in blobs])]
                     + layout + list(tags))


def ojpeg_tiles(stream: bytes, w: int, h: int, tile, spp: int, photometric: int = 6) -> bytes:
    """An old-style JPEG-in-TIFF (compression 6) in tiles of ``tile`` = (tw,
    th), JPEGInterchangeFormat giving ``stream``: a JPEG tw wide whose rows
    are the tiles' rows one tile after another (as libtiff reads the tiles,
    across then down), a restart interval ending at each tile's end; each
    tile points at its intervals in the stream."""
    sos = stream.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(stream[sos + 2:sos + 4], "big")
    body = stream[start:stream.rindex(b"\xff\xd9")]
    cuts = [i for i in range(len(body) - 1) if body[i] == 0xFF and 0xD0 <= body[i + 1] <= 0xD7]
    ends = cuts + [len(body)]
    tw, th = tile
    n = -(-w // tw) * -(-h // th)
    per = len(ends) // n   # restart intervals a tile
    if per * n != len(ends):
        raise ValueError("ojpeg_tiles wants the stream's restart intervals to end at its tiles' ends")
    firsts = [0] + [c + 2 for c in cuts]
    offs = [start + firsts[per * i] for i in range(n)]
    counts = [ends[per * i + per - 1] - firsts[per * i] for i in range(n)]
    return tiff_pack(w, h, [stream], [
        (258, 3, [8] * spp), (259, 3, [6]), (262, 3, [photometric]), (277, 3, [spp]),
        (322, 4, [tw]), (323, 4, [th]), (324, 4, lambda o: [o[0] + a for a in offs]),
        (325, 4, counts), (513, 4, lambda o: [o[0]]), (514, 4, [len(stream)])])


def lzw_encode(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW of ``data`` as libtiff's encoder writes it: codes MSB first
    from 9 bits, a clear code first and whenever the table fills, wider once
    the next entry needs it, EOI last. ``old_style``: the LZW of libtiff
    before 5.0, which libtiff still reads (LZWDecodeCompat): codes LSB
    first, each width change one code later (the decoder's table, one entry
    behind the encoder's, passing 2^width - 1), a clear code once the table
    reaches 4096 entries."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nacc
        if old_style:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
            return
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
    width, nxt, table, code = 9, 258, {}, None
    dec_free = None  # old style: the decoder's next free entry, None before its first code

    def emitted():  # old style: the decoder's table and width after it reads a code
        nonlocal dec_free, width
        if dec_free is None:
            dec_free = 258
        else:
            dec_free += 1
            if dec_free > (1 << width) - 1 and width < 12:
                width += 1
    put(256, width)
    for c in data:
        if code is None:
            code = c
            continue
        key = (code << 8) | c
        hit = table.get(key)
        if hit is not None:
            code = hit
            continue
        put(code, width)
        table[key] = nxt
        nxt += 1
        code = c
        if old_style:
            emitted()
            if nxt == 4096:
                put(256, width)
                width, nxt, table, dec_free = 9, 258, {}, None
        elif nxt == 4094:  # the table is full: a clear code
            put(256, width)
            width, nxt, table = 9, 258, {}
        elif nxt >= 1 << width:
            width += 1
    if code is not None:
        put(code, width)
        nxt += 1
        if old_style:
            emitted()
        elif nxt == 4094:
            put(256, width)
            width = 9
        elif nxt >= 1 << width:
            width += 1
    put(257, width)
    if nacc:
        out.append(acc & 0xFF if old_style else (acc << (8 - nacc)) & 0xFF)
    return bytes(out)


REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def tiff_codec(raw: bytes, compression: int) -> bytes:
    """A strip's or tile's bytes coded as TIFF ``compression`` 1 (as they
    are), 5 (LZW; -5 old-style LZW, tagged 5), 8 (Deflate), 32773 (PackBits), 34925 (LZMA: one .xz
    stream of Delta and LZMA2 with no check, as libtiff writes it) or 50000
    (ZSTD: one frame, from the ``zstandard`` package, which the card's
    machine does not have)."""
    import lzma
    import zlib
    if compression in (5, -5):
        return lzw_encode(raw, old_style=compression < 0)
    if compression == 8:
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits_encode(raw)
    if compression == 34925:
        return lzma.compress(raw, lzma.FORMAT_XZ, check=lzma.CHECK_NONE,
                             filters=[{"id": lzma.FILTER_DELTA, "dist": 1},
                                      {"id": lzma.FILTER_LZMA2, "preset": 6}])
    if compression == 50000:
        import zstandard
        return zstandard.ZstdCompressor(level=9, write_content_size=False).compress(raw)
    return raw


def tiff_layout(samples, bits: int, photometric: int, *, compression: int = 1, planar: int = 1,
                rows_per_strip: int = 0, tile=None, predictor: int = 1, fill: int = 1,
                be: bool = False, big: bool = False, tags=()) -> bytes:
    """A one-page TIFF of (H, W, spp) unsigned ``samples`` of ``bits`` bits
    (8 or 16; 1, 2 or 4 packed MSB first a row), chunky or ``planar`` 2
    (each sample a plane of its own chunks, plane-major), in strips of
    ``rows_per_strip`` rows (0: one strip) or (width, height) ``tile``s,
    ``predictor`` 2 (each sample less its left neighbour's, within its
    plane), then ``compression`` (``tiff_codec``), and with ``fill`` 2 every
    stored byte bit-reversed (FillOrder 2). ``tags`` are more (tag, type,
    values) entries; ``big``: BigTIFF with LONG8 offsets and counts."""
    import numpy as np
    a = np.asarray(samples)
    h, w, spp = a.shape
    planes = [a[..., i:i + 1] for i in range(spp)] if planar == 2 else [a]
    if tile:
        tw, th = tile
        grid = [(y, x, th, tw) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        grid = [(y, 0, rps, w) for y in range(0, h, rps)]
    blobs = []
    for p in planes:
        for y, x, ch, cw in grid:
            c = np.zeros((ch if tile else min(ch, h - y), cw, p.shape[2]), np.int64)
            part = p[y:y + ch, x:x + cw]
            c[:part.shape[0], :part.shape[1]] = part
            if predictor == 2:
                c[:, 1:] -= c[:, :-1].copy()
                c &= (1 << bits) - 1
            if bits == 16:
                raw = c.astype((">" if be else "<") + "u2").tobytes()
            elif bits == 8:
                raw = c.astype(np.uint8).tobytes()
            else:
                v = c.reshape(c.shape[0], -1).astype(np.uint8)
                bitrows = (v[..., None] >> np.arange(bits - 1, -1, -1)) & 1
                raw = np.packbits(bitrows.reshape(v.shape[0], -1), axis=1).tobytes()
            raw = tiff_codec(raw, compression)
            blobs.append(raw.translate(REVERSED_BITS) if fill == 2 else raw)
    n = len(blobs)
    long_ = 16 if big else 4
    layout = ([(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, long_, lambda o: o[:n]),
               (325, long_, [len(b) for b in blobs])] if tile else
              [(273, long_, lambda o: o[:n]), (278, 4, [rows_per_strip or h]),
               (279, long_, [len(b) for b in blobs])])
    base = [(258, 3, [bits] * spp), (259, 3, [abs(compression)]), (262, 3, [photometric]),
            (277, 3, [spp]), (284, 3, [planar])] + layout
    if predictor != 1:
        base.append((317, 3, [predictor]))
    if fill != 1:
        base.append((266, 3, [fill]))
    given = {t[0] for t in tags}
    return tiff_pack(w, h, blobs, [e for e in base if e[0] not in given] + list(tags), be, big)


def tiff_ycbcr(y, cb, cr, sub=(2, 2), *, compression: int = 8, rows_per_strip: int = 0,
               tile=None, planar: int = 1, be: bool = False, tags=()) -> bytes:
    """A YCbCr TIFF (photometric 6, 8 bits) of uint8 luma ``y`` (H, W) and
    chroma ``cb``, ``cr`` of one sample a ``sub`` = (h, v) block, (ceil(H /
    v), ceil(W / h)): chunky, each strip or tile rows of blocks, a block its
    h x v luma samples (rows of them, the image's edge repeated past it)
    then Cb and Cr; or ``planar`` 2, three planes of the image's size, the
    chroma repeated over each block. Strips of ``rows_per_strip`` rows (a
    multiple of v; 0: one strip) or (width, height) ``tile``s, coded by
    ``tiff_codec``; the YCbCrSubsampling tag unless ``tags`` give one."""
    import numpy as np
    y, cb, cr = (np.asarray(a, np.uint8) for a in (y, cb, cr))
    hh, vv = sub
    H, W = y.shape
    if planar == 2:
        full = [y, np.repeat(np.repeat(cb, vv, 0), hh, 1)[:H, :W],
                np.repeat(np.repeat(cr, vv, 0), hh, 1)[:H, :W]]
        return tiff_layout(np.dstack(full), 8, 6, compression=compression, planar=2,
                           rows_per_strip=rows_per_strip, tile=tile, be=be,
                           tags=[(530, 3, [hh, vv])] + [t for t in tags if t[0] != 530]
                           if all(t[0] != 530 for t in tags) else list(tags))
    bh, bw = cb.shape
    ypad = np.pad(y, ((0, bh * vv - H), (0, bw * hh - W)), mode="edge")
    units = np.concatenate([ypad.reshape(bh, vv, bw, hh).transpose(0, 2, 1, 3).reshape(bh, bw, -1),
                            cb[..., None], cr[..., None]], axis=2)
    if tile:
        tw, th = tile
        grid = [(r, c, th // vv, tw // hh) for r in range(0, bh, th // vv)
                for c in range(0, bw, tw // hh)]
    else:
        rb = (rows_per_strip or bh * vv) // vv
        grid = [(r, 0, rb, bw) for r in range(0, bh, rb)]
    blobs = []
    for r, c, nr, nc in grid:
        part = units[r:r + nr, c:c + nc]
        if tile:
            full = np.zeros((nr, nc, units.shape[2]), np.uint8)
            full[:part.shape[0], :part.shape[1]] = part
            part = full
        blobs.append(tiff_codec(part.tobytes(), compression))
    n = len(blobs)
    layout = ([(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, lambda o: o[:n]),
               (325, 4, [len(b) for b in blobs])] if tile else
              [(273, 4, lambda o: o[:n]), (278, 4, [rows_per_strip or H]),
               (279, 4, [len(b) for b in blobs])])
    base = [(258, 3, [8] * 3), (259, 3, [abs(compression)]), (262, 3, [6]), (277, 3, [3]),
            (284, 3, [1]), (530, 3, [hh, vv])] + layout
    given = {t[0] for t in tags}
    return tiff_pack(W, H, blobs, [e for e in base if e[0] not in given] + list(tags), be)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as a repeat, the rest as
    literal runs of up to 128 bytes."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def ojpeg_wrap(stream: bytes, w: int, h: int, spp: int, photometric: int = 6) -> bytes:
    """An old-style JPEG-in-TIFF (compression 6) of a whole JPEG stream of
    ``spp`` components: JPEGInterchangeFormat and its length give the
    stream, one strip points at the same bytes (as the old writers laid
    such files out)."""
    return tiff_pack(w, h, [stream], [
        (258, 3, [8] * spp), (259, 3, [6]), (262, 3, [photometric]), (277, 3, [spp]),
        (273, 4, lambda o: [o[0]]), (278, 4, [h]), (279, 4, [len(stream)]),
        (513, 4, lambda o: [o[0]]), (514, 4, [len(stream)])])


def tiff_numbers(values, dtype: str, fmt: int, *, rows_per_strip: int = 0,
                 compression: int = 1, predictor: int = 1) -> bytes:
    """A grey TIFF of (H, W) ``values`` as numpy ``dtype`` ('<f4', '>i2',
    '<u4', ... , or '12' for 12-bit samples packed MSB first), SampleFormat
    ``fmt`` (1 unsigned, 2 signed, 3 float), in strips of ``rows_per_strip``
    rows (0: one strip), coded in ``compression`` (``tiff_codec``) after
    ``predictor`` 2 (each sample less its left neighbour, modulo its size)
    or 3 (libtiff's floating-point predictor: the row's samples as byte
    planes, most significant first, each byte less the one before it)."""
    import numpy as np
    h, w = values.shape
    be = dtype.startswith(">")
    rps = rows_per_strip or h
    blobs = []
    for y in range(0, h, rps):
        rows = values[y:y + rps]
        if dtype == "12":
            v = rows.astype(np.uint16)
            bits = ((v[..., None] >> np.arange(11, -1, -1)) & 1).astype(np.uint8)
            raw = np.packbits(bits.reshape(len(rows), -1), axis=1).tobytes()
        else:
            a = rows.astype(dtype)
            size = a.dtype.itemsize
            if predictor == 2:
                u = a.view(a.dtype.byteorder + f"u{size}").astype(np.uint64)
                u[:, 1:] -= u[:, :-1].copy()
                a = (u & np.uint64((1 << 8 * size) - 1)).astype(a.dtype.byteorder + f"u{size}")
            if predictor == 3:
                planes = a.astype(">" + a.dtype.str[1:]).view(np.uint8).reshape(len(rows), w, size)
                b = planes.transpose(0, 2, 1).reshape(len(rows), -1).astype(np.int16)
                b[:, 1:] -= b[:, :-1].copy()
                raw = (b & 0xFF).astype(np.uint8).tobytes()
            else:
                raw = a.tobytes()
        blobs.append(tiff_codec(raw, compression))
    n = len(blobs)
    return tiff_pack(w, h, blobs, [
        (258, 3, [12 if dtype == "12" else np.dtype(dtype).itemsize * 8]),
        (259, 3, [compression]), (262, 3, [1]), (277, 3, [1]),
        (273, 4, lambda o: o[:n]), (278, 4, [rps]), (279, 4, [len(b) for b in blobs]),
        (317, 3, [predictor]), (339, 3, [fmt])], be)


def lossless_rows(data: bytes, height: int, pick) -> bytes:
    """A taller lossless JPEG (SOF3, one component, a restart interval of
    one row) from the rows of ``data``, one such file, no re-encoding: row
    i of the new image is source row ``pick(i)`` (each interval starts its
    row afresh, so the image is the source's rows in that order)."""
    sof = data.index(b"\xff\xc3")
    h = int.from_bytes(data[sof + 5:sof + 7], "big")
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    body = data[start:data.rindex(b"\xff\xd9")]
    cuts = [i for i in range(len(body) - 1) if body[i] == 0xFF and 0xD0 <= body[i + 1] <= 0xD7]
    rows = [body[a:b] for a, b in zip([0] + [c + 2 for c in cuts], cuts + [len(body)])]
    if len(rows) != h:
        raise ValueError("lossless_rows wants one restart interval a row")
    out = bytearray(rows[pick(0)])
    for i in range(1, height):
        out += bytes([0xFF, 0xD0 + (i - 1) % 8]) + rows[pick(i)]
    head = bytearray(data[:start])
    head[sof + 5:sof + 7] = height.to_bytes(2, "big")
    return bytes(head + out) + b"\xff\xd9"


def stripe_pick(i: int) -> int:
    """``lossless_rows``' source row for row i of a page from the 8 rows of
    ``lossless_stripe.jpg``."""
    return (5 * i + i // 8) % 8


def a6_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of old-style JPEG-in-TIFF, float TIFF,
    arithmetic-coded and lossless JPEG, built without PIL from the
    fixtures: scan_420.jpg wrapped as old-style
    JPEG-in-TIFF, its grey as float32 in Deflate strips with predictor 3,
    arith_444.jpg's restart intervals tiled (arithmetic-coded, sequential),
    and lossless_stripe.jpg's rows (lossless, predictor 1, a restart a row)
    stacked. Each is held to a digest of PIL's grey of the same bytes
    (a6_pages.sha256, written with the fixtures), or to PIL's refusal: the
    arithmetic page's scan runs past PIL's first 64 KB read block, where
    libjpeg's arithmetic decoder cannot suspend, so a 1200 x 160 band of it
    (inside the block) is the arithmetic page that reads."""
    import numpy as np
    return {"ojpeg_page.tif": ojpeg_wrap((FIXTURES / "scan_420.jpg").read_bytes(), 1200, 500, 3),
            "float32_page.tif": tiff_numbers(golden["scan_420.jpg"].astype(np.float32), "<f4", 3,
                                             rows_per_strip=50, compression=8, predictor=3),
            "arith_page.jpg": tile_jpeg((FIXTURES / "arith_444.jpg").read_bytes(), 1200, 500,
                                        page_pick),
            "arith_band.jpg": tile_jpeg((FIXTURES / "arith_444.jpg").read_bytes(), 1200, 160,
                                        page_pick),
            "lossless_page.jpg": lossless_rows((FIXTURES / "lossless_stripe.jpg").read_bytes(),
                                               500, stripe_pick)}


def tiff_strips(data: bytes) -> dict:
    """{tag: values} of the SHORT and LONG entries of a little-endian
    classic TIFF's first IFD, and its strips' bytes under "strips"."""
    import struct
    ifd = struct.unpack_from("<I", data, 4)[0]
    out = {}
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        tag, typ, count = struct.unpack_from("<HHI", data, ifd + 2 + 12 * i)
        if typ in (3, 4):
            size = 2 if typ == 3 else 4
            at = ifd + 10 + 12 * i if size * count <= 4 else struct.unpack_from(
                "<I", data, ifd + 10 + 12 * i)[0]
            out[tag] = list(struct.unpack_from(f"<{count}{'H' if typ == 3 else 'I'}", data, at))
    out["strips"] = [data[o:o + n] for o, n in zip(out[273], out[279])]
    return out


def fill_order_2(data: bytes) -> bytes:
    """A bilevel TIFF of strips (a little-endian classic one, PIL's CCITT
    pages) with each strip's bits reversed and FillOrder 2: the same image."""
    t = tiff_strips(data)
    blobs = [b.translate(REVERSED_BITS) for b in t["strips"]]
    keep = [(tag, 4, t[tag]) for tag in (262, 278, 292, 293) if tag in t]
    return tiff_pack(t[256][0], t[257][0], blobs, [
        (258, 3, [1]), (259, 3, t[259]), (266, 3, [2]), (277, 3, [1]),
        (273, 4, lambda o: o), (279, 4, [len(b) for b in blobs])] + keep)


def a6_layout_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of the TIFF layouts of A.6.7-A.6.12,
    built without PIL from scan_420.jpg's grey (integer arithmetic alone)
    and the Group 4 page: BigTIFF in LZW strips, planar RGB (the grey
    tinted) in Deflate with predictor 2, YCbCr 2 x 2 in Deflate (luma the
    grey, chroma from each block's mean), ccitt_g4_page.tif with FillOrder
    2, and a palette with an alpha sample (PA) in Deflate. Each is held to
    a digest of PIL's grey of the same bytes (a6_pages.sha256)."""
    import numpy as np
    grey = golden["scan_420.jpg"].astype(np.int64)
    rgb = np.dstack([grey, grey * 31 // 32, np.minimum(grey + 6, 255)])
    block = grey.reshape(250, 2, 600, 2).sum(axis=(1, 3)) // 4
    ramp = np.arange(256)
    palette = list(ramp * 257) + list(ramp * 250 // 255 * 257) + list(np.minimum(ramp + 9, 255) * 257)
    return {
        "bigtiff_page.tif": tiff_layout(grey[..., None], 8, 1, compression=5, big=True,
                                        rows_per_strip=50),
        "planar_page.tif": tiff_layout(rgb, 8, 2, compression=8, planar=2, predictor=2,
                                       rows_per_strip=50),
        "ycbcr_page.tif": tiff_ycbcr(grey, 128 + (block - 128) // 8, 128 - (block - 128) // 16,
                                     (2, 2), compression=8, rows_per_strip=50),
        "fill2_g4_page.tif": fill_order_2((FIXTURES / "ccitt_g4_page.tif").read_bytes()),
        "pa_page.tif": tiff_layout(np.dstack([grey, 255 - grey // 2]), 8, 3, compression=8,
                                   rows_per_strip=50, tags=[(338, 3, [2]), (320, 3, palette)]),
    }


def damaged_g4_page() -> bytes:
    """ccitt_g4_page.tif with two bytes of its second strip (rows 436-499)
    inverted: libtiff's fax decoder meets an extension code in row 3 and a
    bad code in row 9 of that strip, cuts each row there in the colour it
    had reached and reads on (C.14); the rows it does not reach keep the
    first strip's, so PIL's grey of it is the same every run."""
    data = bytearray((FIXTURES / "ccitt_g4_page.tif").read_bytes())
    second = tiff_strips(bytes(data))[273][1]
    for at in (30, 70):
        data[second + at] ^= 0xFF
    return bytes(data)


def a6_codec_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of A.6.13 and C.14, built without PIL:
    scan_420.jpg's grey as LZMA TIFF as libtiff writes it (one .xz stream of
    Delta and LZMA2, no check, a 50-row strip; the stdlib's ``lzma``), and
    the damaged Group 4 page. Each is held to a digest of PIL's grey of the
    same bytes (a6_pages.sha256). The ZSTD page is a fixture,
    zstd_g4_page.tif (the card's machine has no Zstandard encoder)."""
    import numpy as np
    grey = golden["scan_420.jpg"].astype(np.int64)
    return {"lzma_page.tif": tiff_layout(grey[..., None], 8, 1, compression=34925,
                                         rows_per_strip=50),
            "damaged_g4_page.tif": damaged_g4_page()}


PAPER_INK = [245 * 257, 20 * 257, 240 * 257, 30 * 257, 230 * 257, 110 * 257]  # a 1-bit ColorMap


def sof11(data: bytes) -> bytes:
    """A lossless JPEG with its SOF3 marker made SOF11 (lossless,
    arithmetic-coded): libjpeg has no decoder for it, so PIL refuses it."""
    at = data.index(b"\xff\xc3")
    return data[:at + 1] + b"\xcb" + data[at + 2:]


def a6_ccitt_lzw_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of A.6.15-A.6.19 and C.16, built without
    PIL: the Group 4 page's ink in 256 x 256 tiles, with a 1-bit palette
    (paper and blue ink) and with T6Options' uncompressed-mode bit;
    scan_420.jpg's grey in old-style LZW strips of 50 rows; old-style
    JPEG-in-TIFF in 400 x 80 tiles (restart_444.jpg's intervals tiled into
    one 400 px wide stream, a tile after another); lossless_stripe.jpg as
    SOF11, which PIL refuses. Each is held to a digest of PIL's grey of the
    same bytes (a6_pages.sha256), or to the refusal."""
    import numpy as np
    black = golden["ccitt_g4_page.tif"] == 0
    grey = golden["scan_420.jpg"].astype(np.int64)
    ojpeg = tile_jpeg((FIXTURES / "restart_444.jpg").read_bytes(), 400, 21 * 80, page_pick)
    return {"g4_tiles_page.tif": tiff_g4(black, tile=(256, 256)),
            "g4_palette_page.tif": tiff_g4(black, tile=(256, 256), photometric=3,
                                           tags=[(320, 3, PAPER_INK)]),
            "g4_uncompressed_page.tif": tiff_g4(black, tags=[(293, 4, [2])]),
            "old_lzw_page.tif": tiff_layout(grey[..., None], 8, 1, compression=-5,
                                            rows_per_strip=50),
            "ojpeg_tiles_page.tif": ojpeg_tiles(ojpeg, 1200, 500, (400, 80), 3),
            "sof11_stripe.jpg": sof11((FIXTURES / "lossless_stripe.jpg").read_bytes())}


def mh_words(row) -> list:
    """A bilevel row's Modified Huffman code words (True black), white
    first: [(word, black), ...]."""
    out, x, colour = [], 0, False
    while x < len(row):
        e = x
        while e < len(row) and bool(row[e]) == colour:
            e += 1
        out += [(word, colour) for word in ccitt_words(e - x, colour)]
        x, colour = e, not colour
    return out


def rlew_strip(black, odd: bool = False, libtiff: bool = True) -> bytes:
    """CCITT RLE-W (compression 32771) of a bilevel (H, W) array, True
    black: each row's Modified Huffman codes, then zero bits up to where
    libtiff's reader takes up the next row. Its reader fetches a byte at a
    time until it holds 12 bits for a white code, 13 for a black one; at a
    row's end it drops the bits it holds past a multiple of 16 and, holding
    none, moves its pointer to an even address (``odd``: the strip starts
    at an odd offset in the file). ``libtiff`` False pads each row to a
    16-bit word from the strip's start instead, as the format says."""
    bits, fetched, held = [], 0, 0
    for row in black:
        for word, colour in mh_words(row):
            while libtiff and held < (13 if colour else 12):
                fetched, held = fetched + 1, held + 8
            bits.append(word)
            held -= len(word)
        n = sum(map(len, bits))
        if not libtiff:
            bits.append("0" * (-n % 16))
            continue
        held -= held & 15
        if held == 0 and (fetched + odd) & 1:
            fetched += 1
        bits.append("0" * (8 * fetched - held - n))
    return fax_bytes("".join(bits))


def thunder_codes(nibbles, rs=None) -> bytes:
    """ThunderScan (compression 32809) code bytes of rows of 4-bit values:
    at each pixel, of the codes that fit, a run of the last value (up to 63
    pixels), three 2-bit deltas, two 3-bit deltas (deltas modulo 16), or
    the raw value: the first that fits in that order, or with ``rs`` a
    random one, the deltas then with one slot the skip code now and then."""
    out = bytearray()
    two, three = {0: 0, 1: 1, 15: 3}, {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
    for row in nibbles:
        row = [int(v) for v in row]
        last, x, w = 0, 0, len(row)
        while x < w:
            run = 0
            while x + run < w and row[x + run] == last and run < 63:
                run += 1
            d, prev = [], last
            for v in row[x:x + 3]:
                d.append((v - prev) % 16)
                prev = v
            fits = []
            if run:
                fits.append(("run", run if rs is None else int(rs.randint(1, run + 1))))
            if len(d) == 3 and all(v in two for v in d):
                fits.append(("two", 3))
            if len(d) >= 2 and all(v in three for v in d[:2]):
                fits.append(("three", 2))
            if rs is not None and d[0] in two:
                fits.append(("two", 1))
            if rs is not None and d[0] in three:
                fits.append(("three", 1))
            fits.append(("raw", 1))
            kind, n = fits[0] if rs is None else fits[rs.randint(len(fits))]
            if kind == "run":
                out.append(n)
            elif kind == "two":
                slots = [two[v] for v in d[:n]] + [2] * (3 - n)
                out.append(0x40 | slots[0] << 4 | slots[1] << 2 | slots[2])
            elif kind == "three":
                slots = [three[v] for v in d[:n]] + [4] * (2 - n)
                out.append(0x80 | slots[0] << 3 | slots[1])
            else:
                out.append(0xC0 | row[x])
            last, x = row[x + n - 1], x + n
    return bytes(out)


def _dct_matrix():
    import numpy as np
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


# Fixed-length Huffman tables that hold every symbol a 12-bit frame codes:
# DC categories 0 .. 15 in 5 bits, and every AC run/size (sizes 1 .. 14),
# EOB and ZRL in 8 bits (no code all ones).
SOF1_DC = list(range(16))
SOF1_AC = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 15)]
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
          27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
          44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def jpeg_sof1(planes, quant, *, precision: int = 12, restart: int = 0, pq16: bool = False) -> bytes:
    """An extended sequential Huffman JPEG (SOF1) of ``planes`` (one 2-D
    array, or a list of them, one a component, all 1 x 1): samples
    level-shifted by half their range, a float DCT rounded and divided by
    the 64 quantizers ``quant`` (natural order; 16-bit with ``pq16``),
    coded with SOF1_DC / SOF1_AC, a restart every ``restart`` MCUs; up to
    4 components in one scan, more in a scan each. At 12 bits
    libjpeg-turbo's 12-bit decoder reads it (through libtiff, for PIL: PIL
    refuses the JPEG file on its own)."""
    import struct
    import numpy as np
    planes = [np.asarray(p, np.int64) for p in (planes if isinstance(planes, list) else [planes])]
    h, w = planes[0].shape
    m = _dct_matrix()
    quant = np.asarray(quant, np.int64).reshape(8, 8)
    pads = [np.pad(p, ((0, -h % 8), (0, -w % 8)), mode="edge").astype(np.float64)
            - (1 << (precision - 1)) for p in planes]
    dc_bits, ac_bits = [0] * 4 + [16] + [0] * 11, [0] * 7 + [len(SOF1_AC)] + [0] * 8
    dc_codes = {v: (i, 5) for i, v in enumerate(SOF1_DC)}
    ac_codes = {v: (i, 8) for i, v in enumerate(SOF1_AC)}

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body
    n = len(planes)
    table = b"".join(int(quant.flat[i]).to_bytes(2 if pq16 else 1, "big") for i in ZIGZAG)
    head = b"\xff\xd8" + seg(0xDB, bytes([0x10 if pq16 else 0]) + table)
    head += seg(0xC4, bytes([0x00] + dc_bits) + bytes(SOF1_DC))
    head += seg(0xC4, bytes([0x10] + ac_bits) + bytes(SOF1_AC))
    head += seg(0xC1, struct.pack(">BHHB", precision, h, w, n) +
                b"".join(bytes([i + 1, 0x11, 0]) for i in range(n)))
    if restart:
        head += seg(0xDD, struct.pack(">H", restart))
    body = b""
    for comps in ([list(range(n))] if n <= 4 else [[ci] for ci in range(n)]):
        out, acc, nacc, preds, count = bytearray(), 0, 0, [0] * n, 0

        def put(v, k):
            nonlocal acc, nacc
            acc, nacc = (acc << k) | (v & ((1 << k) - 1)), nacc + k
            while nacc >= 8:
                byte = (acc >> (nacc - 8)) & 0xFF
                out.extend([byte, 0] if byte == 0xFF else [byte])
                nacc -= 8
            acc &= (1 << nacc) - 1

        def value(code, v):
            put(*code)
            s = abs(v).bit_length()
            if s:
                put(v if v >= 0 else v + (1 << s) - 1, s)

        def flush():
            if nacc:
                put((1 << (8 - nacc)) - 1, 8 - nacc)
        coefs = [np.rint(np.einsum("ij,ajbk,lk->abil", m, pads[ci].reshape(
            pads[ci].shape[0] // 8, 8, pads[ci].shape[1] // 8, 8), m) / quant).astype(np.int64)
            .reshape(-1, 64)[:, ZIGZAG] for ci in range(n)]
        for b in range(coefs[0].shape[0]):
            if restart and count and count % restart == 0:
                flush()
                out.extend([0xFF, 0xD0 + (count // restart - 1) % 8])
                preds = [0] * n
            count += 1
            for ci in comps:
                zz = coefs[ci][b].tolist()
                value(dc_codes[abs(zz[0] - preds[ci]).bit_length()], zz[0] - preds[ci])
                preds[ci], run = zz[0], 0
                for k in range(1, 64):
                    if zz[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        put(*ac_codes[0xF0])
                        run -= 16
                    value(ac_codes[(run << 4) | abs(zz[k]).bit_length()], zz[k])
                    run = 0
                if run:
                    put(*ac_codes[0x00])
        flush()
        sos = bytes([len(comps)]) + b"".join(bytes([ci + 1, 0x00]) for ci in comps) + bytes([0, 63, 0])
        body += seg(0xDA, sos) + bytes(out)
    return head + body + b"\xff\xd9"


def jpeg_in_tiff(streams, w: int, h: int, bits: int, photometric: int, spp: int, *,
                 planar: int = 1, rows_per_strip: int = 0, tags=()) -> bytes:
    """A JPEG-in-TIFF (compression 7) of ``streams``, one a strip (planar
    2: each plane's strips, plane after plane)."""
    n = len(streams)
    return tiff_pack(w, h, streams, [
        (258, 3, [bits] * spp), (259, 3, [7]), (262, 3, [photometric]), (277, 3, [spp]),
        (284, 3, [planar]), (273, 4, lambda o: o[:n]), (278, 4, [rows_per_strip or h]),
        (279, 4, [len(s) for s in streams])] + list(tags))


def xz_with_filter(stream: bytes, filter_id: int) -> bytes:
    """A single-block .xz stream with its first filter's ID made
    ``filter_id`` (one byte) and its block header's CRC32 made good."""
    import struct
    import zlib
    size = (stream[12] + 1) * 4
    head = bytearray(stream[12:12 + size])
    head[2] = filter_id
    struct.pack_into("<I", head, size - 4, zlib.crc32(bytes(head[:size - 4])))
    return stream[:12] + bytes(head) + stream[12 + size:]


def lzma_bcj(raw: bytes, filter_id: int) -> bytes:
    """``raw`` through Python's x86 BCJ encoder and LZMA2, the filter then
    named ``filter_id`` (0x0A ARM64, 0x0B RISC-V: liblzma's decoders, which
    Python's ``lzma`` does not write): what the file's reader gives is that
    filter's decoding of the x86-coded bytes."""
    import lzma
    xz = lzma.compress(raw, lzma.FORMAT_XZ, check=lzma.CHECK_NONE,
                       filters=[{"id": lzma.FILTER_X86}, {"id": lzma.FILTER_LZMA2, "preset": 6}])
    return xz_with_filter(xz, filter_id)


Q90 = [3, 2, 2, 3, 5, 8, 10, 12, 2, 2, 3, 4, 5, 12, 12, 11, 3, 3, 3, 5, 8, 11, 14, 11, 3, 3, 4, 6,
       10, 17, 16, 12, 4, 4, 7, 11, 14, 22, 21, 15, 5, 7, 11, 13, 16, 21, 23, 18, 10, 13, 16, 17,
       21, 24, 24, 20, 14, 18, 19, 20, 22, 20, 21, 20]  # IJG's luminance table at quality 90


def a6_kind_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of A.6.20-A.6.25, built without PIL
    from scan_420.jpg's grey and the Group 4 page's ink: JPEG-in-TIFF of
    photometric 0 (the grey inverted, SOF1 at IJG quality 90), 12-bit
    JPEG-in-TIFF (the grey halved, the ink from 3000 up: most of the page
    under 256, the ink clipped), planar RGB JPEG-in-TIFF (the grey tinted,
    a stream a plane a 50-row strip), CCITT RLE-W and ThunderScan (the grey
    >> 4) in 50-row strips, and the grey as LZMA TIFF with the ARM64 BCJ
    filter. Each is held to a digest of PIL's grey of the same bytes
    (a6_pages.sha256)."""
    import numpy as np
    grey = golden["scan_420.jpg"].astype(np.int64)
    ink = golden["ccitt_g4_page.tif"] == 0
    h, w = grey.shape
    rows = range(0, h, 50)
    rgb = [grey, grey * 31 // 32, np.minimum(grey + 6, 255)]
    twelve = grey // 2 + (grey < 60) * 3000

    def strips(blobs, bits, compression, photometric, rows_per_strip=50):
        return tiff_pack(w, h, blobs, [
            (258, 3, [bits]), (259, 3, [compression]), (262, 3, [photometric]), (277, 3, [1]),
            (273, 4, lambda o: o), (278, 4, [rows_per_strip]), (279, 4, [len(b) for b in blobs])])
    return {
        "jpeg_white_is_zero_page.tif": jpeg_in_tiff(
            [jpeg_sof1(255 - grey[y:y + 50], Q90, precision=8) for y in rows], w, h, 8, 0, 1,
            rows_per_strip=50),
        "jpeg_12bit_page.tif": jpeg_in_tiff(
            [jpeg_sof1(twelve[y:y + 50], np.full(64, 4)) for y in rows], w, h, 12, 1, 1,
            rows_per_strip=50),
        "planar_jpeg_page.tif": jpeg_in_tiff(
            [jpeg_sof1(p[y:y + 50], Q90, precision=8) for p in rgb for y in rows], w, h, 8, 2, 3,
            planar=2, rows_per_strip=50),
        "rlew_page.tif": strips([rlew_strip(ink[y:y + 50]) for y in rows], 1, 32771, 0),
        "thunderscan_page.tif": strips([thunder_codes(grey[y:y + 50] >> 4) for y in rows], 4, 32809, 1),
        "lzma_arm64_page.tif": strips([lzma_bcj(grey.astype(np.uint8).tobytes(), 0x0A)], 8, 34925, 1, h),
    }


def gif_lzw(pixels: bytes, bits: int = 8, *, eoi: bool = True, clear_when_full: bool = True) -> bytes:
    """GIF LZW codes of ``pixels`` (indices below 1 << ``bits``), packed
    least significant bit first, as Pillow's GifDecode.c reads them: a clear
    code first; a code widened once the decoder's next free code reaches its
    mask; when the 4096-entry table is full a clear code and a new table,
    or, without ``clear_when_full``, 12-bit codes on from the full table (the
    deferred clear); the end code last unless ``eoi`` is false."""
    clear, end = 1 << bits, (1 << bits) + 1
    out, acc, nacc = bytearray(), 0, 0
    size, dnext, first = bits + 1, clear + 2, True

    def emit(code):
        nonlocal acc, nacc, size, dnext, first
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
        if code == clear:
            size, dnext, first = bits + 1, clear + 2, True
        elif first:
            first = False
        elif dnext < 4096:  # the decoder adds an entry for each later code
            if dnext == (1 << size) - 1 and size < 12:
                size += 1
            dnext += 1
    emit(clear)
    table, nxt, prefix = {}, clear + 2, None
    for ch in pixels:
        if prefix is None:
            prefix = ch
            continue
        if (prefix, ch) in table:
            prefix = table[prefix, ch]
            continue
        emit(prefix)
        if nxt < 4096:
            table[prefix, ch] = nxt
            nxt += 1
        elif clear_when_full:
            emit(clear)
            table, nxt = {}, clear + 2
        prefix = ch
    if prefix is not None:
        emit(prefix)
    if eoi:
        emit(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_blocks(data: bytes) -> bytes:
    """Data sub-blocks of at most 255 bytes and the terminator."""
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def gif_table(rgb) -> tuple:
    """(flag bits, bytes) of a colour table of (n, 3) ``rgb``, padded with
    black to the next power of two of 2 to 256 entries."""
    import numpy as np
    rgb = np.asarray(rgb, np.uint8).reshape(-1, 3)
    k = max(1, (len(rgb) - 1).bit_length())
    return k - 1, rgb.tobytes() + bytes(3 * ((1 << k) - len(rgb)))


def gif_file(frame, *, screen=None, at=(0, 0), global_table=None, local_table=None,
             interlace: bool = False, transparency=None, bits: int = 8, eoi: bool = True,
             clear_when_full: bool = True, extensions=(), codes=None) -> bytes:
    """A GIF89a of one frame, (h, w) indices ``frame`` at ``at`` = (x, y) on
    a logical screen ``screen`` = (w, h) (the frame's size by default):
    ``global_table`` / ``local_table`` (n, 3) colours or None, the rows in
    interlaced order with ``interlace``, a graphic control extension with
    ``transparency``, ``extensions`` (bytes) before the frame, the LZW of
    ``gif_lzw`` (or the raw ``codes``) with LZW code size ``bits``."""
    import struct
    import numpy as np
    frame = np.asarray(frame, np.uint8)
    h, w = frame.shape
    sw, sh = screen or (w, h)
    flags, table = 0, b""
    if global_table is not None:
        k, table = gif_table(global_table)
        flags = 0x80 | k
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + table + b"".join(extensions)
    if transparency is not None:
        out += b"\x21\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\x00"
    lflags, ltable = 0x40 if interlace else 0, b""
    if local_table is not None:
        k, ltable = gif_table(local_table)
        lflags |= 0x80 | k
    rows = (list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
            + list(range(1, h, 2))) if interlace else list(range(h))
    if codes is None:
        codes = gif_lzw(frame[rows].tobytes(), bits, eoi=eoi, clear_when_full=clear_when_full)
    return (out + b"\x2c" + struct.pack("<HHHHB", at[0], at[1], w, h, lflags) + ltable
            + bytes([bits]) + gif_blocks(codes) + b"\x3b")


def pnm_file(kind: str, samples, maxval: int = 255) -> bytes:
    """A Netpbm file of ``kind`` (P1-P6, or Pillow's P0CMYK / PyP / PyRGBA /
    PyCMYK) of (h, w[, bands]) ``samples``: plain (P1-P3) as decimal
    tokens, 17 a line; raw at one byte a sample up to maxval 255, else two,
    big-endian; P4 eight pixels a byte, a set bit black."""
    import numpy as np
    s = np.asarray(samples)
    h, w = s.shape[:2]
    head = f"{kind}\n{w} {h}\n" + ("" if kind in ("P1", "P4") else f"{maxval}\n")
    if kind in ("P1", "P2", "P3"):
        toks = [str(int(v)) for v in s.reshape(-1)]
        return (head + "\n".join(" ".join(toks[i:i + 17]) for i in range(0, len(toks), 17))
                + "\n").encode()
    if kind == "P4":
        return head.encode() + np.packbits(s.astype(np.uint8) & 1, axis=1).tobytes()
    return head.encode() + s.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk: its tag, its size and its payload, padded to even."""
    return tag + len(payload).to_bytes(4, "little") + payload + b"\0" * (len(payload) & 1)


def riff_webp(chunks) -> bytes:
    """A WebP file of already-built chunks (``webp_chunk``)."""
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def vp8x_chunk(w: int, h: int, flags: int) -> bytes:
    """The extended header: flags (0x10 alpha, 0x02 animation, 0x20 ICC,
    0x08 EXIF, 0x04 XMP) and the canvas size."""
    return webp_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


class BitFields:
    """The fields of a VP8L stream, read least significant bit first;
    ``code`` writes a prefix code's bits as the reader takes them (its
    first bit, the code's most significant, first)."""

    def __init__(self):
        self.parts = []

    def put(self, value: int, nbits: int):
        if nbits:
            self.parts.append(([value], [nbits]))

    def put_many(self, values, nbits):
        self.parts.append((values, nbits))

    def code(self, code: int, length: int):
        self.put(int(f"{code:0{length}b}"[::-1], 2) if length else 0, length)

    def tobytes(self) -> bytes:
        """The fields packed: each (at most 24 bits) shifted into the
        32-bit word it starts in, its spill into the next; the fields never
        overlap, so a word's sum is exact in float64 and equals their OR."""
        import numpy as np
        vals = np.concatenate([np.asarray(v, np.int64).ravel() for v, _ in self.parts])
        bits = np.concatenate([np.asarray(n, np.int64).ravel() for _, n in self.parts])
        pos = np.concatenate([[0], np.cumsum(bits)[:-1]])
        total = int(bits.sum())
        words = total // 32 + 2
        shifted = vals.astype(np.uint64) << (pos & 31).astype(np.uint64)
        at = pos >> 5
        packed = (np.bincount(at, (shifted & 0xFFFFFFFF).astype(np.float64), words)
                  + np.bincount(at + 1, (shifted >> 32).astype(np.float64), words))
        return packed.astype("<u4").tobytes()[:(total + 7) // 8]


def huffman_lengths(counts, max_len: int = 15):
    """Code lengths of a Huffman code of ``counts`` no longer than
    ``max_len`` (counts halved until it fits); a lone symbol gets length 1."""
    import heapq
    import numpy as np
    counts = np.asarray(counts, np.int64)
    used = np.nonzero(counts)[0]
    lengths = np.zeros(len(counts), np.int64)
    if len(used) == 1:
        lengths[used[0]] = 1
        return lengths
    c = counts.copy()
    while True:
        heap = [(int(c[s]), int(s), (int(s),)) for s in used]
        heapq.heapify(heap)
        depth = dict.fromkeys(used.tolist(), 0)
        while len(heap) > 1:
            a, b = heapq.heappop(heap), heapq.heappop(heap)
            for s in a[2] + b[2]:
                depth[s] += 1
            heapq.heappush(heap, (a[0] + b[0], min(a[1], b[1]), a[2] + b[2]))
        if max(depth.values()) <= max_len:
            for s, d in depth.items():
                lengths[s] = d
            return lengths
        c = np.where(c > 0, (c + 1) // 2, 0)


def canonical_codes(lengths):
    """Each symbol's code of a canonical prefix code of ``lengths``, as
    libwebp assigns them (by length, then symbol); a lone symbol reads no
    bits, so its length becomes 0."""
    import numpy as np
    lengths = np.asarray(lengths, np.int64)
    codes, out_len = np.zeros(len(lengths), np.int64), lengths.copy()
    if np.count_nonzero(lengths) == 1:
        out_len[:] = 0
        return codes, out_len
    code = 0
    for length in range(1, 16):
        for s in np.nonzero(lengths == length)[0]:
            codes[s] = code
            code += 1
        code <<= 1
    return codes, out_len


VP8L_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def vp8l_prefix_code(bw: BitFields, lengths, *, simple=None, max_symbol=False):
    """Write the prefix code of ``lengths`` (one entry per symbol of the
    alphabet): the simple form where it can be (one or two symbols under
    256) unless ``simple`` is False, else code lengths through a code-length
    code (runs of zeros as 17/18, repeats as 16), with ``max_symbol`` the
    count of code-length symbols read stated and the trailing zeros left
    out. Returns (codes, lengths) to write the alphabet's symbols with."""
    import numpy as np
    lengths = np.asarray(lengths, np.int64)
    used = np.nonzero(lengths)[0]
    if simple is None:
        simple = len(used) <= 2 and (len(used) == 0 or used.max() < 256)
    if simple:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        first = int(used[0])
        bw.put(int(first >= 2), 1)
        bw.put(first, 8 if first >= 2 else 1)
        if len(used) == 2:
            bw.put(int(used[1]), 8)
        lengths = np.where(lengths > 0, 1, 0)
        return canonical_codes(lengths)
    toks = []  # (symbol, extra value, extra bits)
    end = max(int(used.max()) + 1, 2) if max_symbol else len(lengths)  # max_symbol >= 2
    i, prev = 0, 8
    while i < end:
        v = int(lengths[i])
        run = 1
        while i + run < end and lengths[i + run] == v:
            run += 1
        if v == 0 and run >= 3:
            take = min(run, 138)
            toks.append((18, take - 11, 7) if take >= 11 else (17, take - 3, 3))
        elif v and v == prev and run >= 3:
            take = min(run, 6)
            toks.append((16, take - 3, 2))
        else:
            take = 1
            toks.append((v, 0, 0))
            prev = v if v else prev
        i += take
    cl = huffman_lengths(np.bincount([t[0] for t in toks], minlength=19), 7)
    num = max(4, max(k for k in range(19) if cl[VP8L_CODE_LENGTH_ORDER[k]]) + 1)
    bw.put(0, 1)
    bw.put(num - 4, 4)
    for k in range(num):
        bw.put(int(cl[VP8L_CODE_LENGTH_ORDER[k]]), 3)
    if max_symbol:
        value = len(toks) - 2
        k = next(k for k in range(8) if value < 1 << (2 + 2 * k))
        bw.put(1, 1)
        bw.put(k, 3)
        bw.put(value, 2 + 2 * k)
    else:
        bw.put(0, 1)
    ccodes, clens = canonical_codes(cl)
    for sym, extra, nbits in toks:
        bw.code(int(ccodes[sym]), int(clens[sym]))
        bw.put(extra, nbits)
    return canonical_codes(lengths)


def vp8l_header(bw: BitFields, w: int, h: int, alpha: bool = False):
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(int(alpha), 1)
    bw.put(0, 3)


def vp8l_grey_file(grey) -> bytes:
    """A lossless WebP file of an (h, w) grey image, without PIL: a
    subtract-green transform (red and blue become 0), then each pixel a
    green literal of a Huffman code of the image's histogram; red, blue,
    alpha (255) and distance one-symbol codes that read no bits."""
    import numpy as np
    g = np.asarray(grey, np.int64)
    h, w = g.shape
    bw = BitFields()
    vp8l_header(bw, w, h)
    bw.put(1, 1)
    bw.put(2, 2)  # subtract green
    bw.put(0, 1)  # no more transforms
    bw.put(0, 1)  # no colour cache
    bw.put(0, 1)  # no meta Huffman image
    lengths = np.zeros(280, np.int64)
    lengths[:256] = huffman_lengths(np.bincount(g.ravel(), minlength=256))
    codes, lens = vp8l_prefix_code(bw, lengths)
    for size, sym in ((256, 0), (256, 0), (256, 255), (40, 0)):  # red, blue, alpha, distance
        vp8l_prefix_code(bw, np.eye(size, dtype=np.int64)[sym])
    rev = np.array([int(f"{int(c):0{int(n)}b}"[::-1], 2) if n else 0 for c, n in zip(codes, lens)])
    bw.put_many(rev[g.ravel()], lens[g.ravel()])
    return riff_webp([webp_chunk(b"VP8L", bw.tobytes())])


def ojpeg_planes_tiff(planes, quant) -> bytes:
    """Old-style JPEG-in-TIFF (compression 6) of YCbCr in planes: each of
    the three (h, w) ``planes`` a baseline stream (``jpeg_sof1`` at 8 bits),
    its scan one strip, the tables in JPEGQTables / JPEGDCTables /
    JPEGACTables (one of each, shared), YCbCrSubsampling 1 x 1; the strips
    of planes 1 and 2 open with their SOS (one component, named 1 and 2,
    the frame libtiff builds from the tables naming 0, 1 and 2), as
    libtiff finds a plane's scan by searching on from the last."""
    import struct
    h, w = planes[0].shape
    streams = [jpeg_sof1(p, quant, precision=8) for p in planes]
    s = streams[0]
    dqt = s.index(b"\xff\xdb")
    q = s[dqt + 5:dqt + 69]
    dht = [i for i in range(len(s) - 1) if s[i] == 0xFF and s[i + 1] == 0xC4]
    tables = [s[i + 5:i + 2 + struct.unpack(">H", s[i + 2:i + 4])[0]] for i in dht]
    strips = []
    for k, st in enumerate(streams):
        at = st.index(b"\xff\xda")
        data = st[at + 2 + struct.unpack(">H", st[at + 2:at + 4])[0]:st.rindex(b"\xff\xd9")]
        strips.append((b"\xff\xda\x00\x08\x01" + bytes([k, 0x00, 0, 63, 0]) if k else b"") + data)
    return tiff_pack(w, h, strips + [q] + tables, [
        (258, 3, [8] * 3), (259, 3, [6]), (262, 3, [6]), (277, 3, [3]), (284, 3, [2]),
        (512, 3, [1]), (273, 4, lambda o: o[:3]), (278, 4, [h]),
        (279, 4, [len(b) for b in strips]), (519, 4, lambda o: [o[3]] * 3),
        (520, 4, lambda o: [o[4]] * 3), (521, 4, lambda o: [o[5]] * 3), (530, 3, [1, 1])])


def ojpeg_planes_tiles(planes, quant, tw: int, th: int) -> bytes:
    """Old-style JPEG-in-TIFF of YCbCr in planes and tw x th tiles, the
    tables layout of ``ojpeg_planes_tiff``: each plane a baseline stream
    (``jpeg_sof1`` at 8 bits) tw wide whose rows are the plane's tiles one
    after another, a restart interval a tile; each interval a tile, the
    first tile of planes 1 and 2 opening with its SOS. libtiff's frame is
    one column of tiles high, so PIL reads tiles past the first column as
    no lines (they keep the buffer, A.6.48)."""
    import struct
    import numpy as np
    h, w = planes[0].shape
    down, across = -(-h // th), -(-w // tw)
    tiles, q, tables = [], None, None
    for k, p in enumerate(planes):
        full = np.pad(np.asarray(p, np.int64), ((0, down * th - h), (0, across * tw - w)), mode="edge")
        stacked = np.concatenate([full[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                                  for ty in range(down) for tx in range(across)], 0)
        st = jpeg_sof1(stacked, quant, precision=8, restart=(tw // 8) * (th // 8))
        if q is None:
            dqt = st.index(b"\xff\xdb")
            q = st[dqt + 5:dqt + 69]
            dht = [i for i in range(len(st) - 1) if st[i] == 0xFF and st[i + 1] == 0xC4]
            tables = [st[i + 5:i + 2 + struct.unpack(">H", st[i + 2:i + 4])[0]] for i in dht]
        at = st.index(b"\xff\xda")
        data = st[at + 2 + struct.unpack(">H", st[at + 2:at + 4])[0]:st.rindex(b"\xff\xd9")]
        cuts = [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
        parts = [data[a:b] for a, b in zip([0] + [c + 2 for c in cuts], cuts + [len(data)])]
        if k:
            parts[0] = b"\xff\xda\x00\x08\x01" + bytes([k, 0x00, 0, 63, 0]) + parts[0]
        tiles += parts
    n = len(tiles)
    return tiff_pack(w, h, tiles + [q] + tables, [
        (258, 3, [8] * 3), (259, 3, [6]), (262, 3, [6]), (277, 3, [3]), (284, 3, [2]),
        (322, 4, [tw]), (323, 4, [th]), (324, 4, lambda o: o[:n]), (325, 4, [len(b) for b in tiles]),
        (512, 3, [1]), (519, 4, lambda o: [o[n]] * 3), (520, 4, lambda o: [o[n + 1]] * 3),
        (521, 4, lambda o: [o[n + 2]] * 3), (530, 3, [1, 1])])


def a6_gif_pnm_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of C.20, A.6.28 and A.6.29, built without
    PIL from scan_420.jpg's grey: planar YCbCr old-style JPEG-in-TIFF (the
    grey as Y, two chroma planes of it), GIF (the grey's indices under the
    identity ramp: mode L) and interlaced GIF (under a tinted table: mode
    P), raw PGM at 8 and at 16 bits (maxval 65535: the samples as they
    are, PIL's I clipped) and plain PGM (P2). Each is held to a digest of
    PIL's grey of the same bytes (a6_pages.sha256)."""
    import numpy as np
    grey = golden["scan_420.jpg"]
    g = grey.astype(np.int64)
    ramp = np.repeat(np.arange(256), 3).reshape(256, 3)
    tint = np.stack([np.arange(256), np.arange(256) * 7 // 8, np.minimum(np.arange(256) + 20, 255)], 1)
    return {
        "planar_ojpeg_page.tif": ojpeg_planes_tiff([g, 128 + (g - 128) // 6, 128 - (g - 128) // 5], Q90),
        "gif_page.gif": gif_file(grey, global_table=ramp),
        "gif_interlaced_page.gif": gif_file(grey, global_table=tint, interlace=True),
        "p5_page.pgm": pnm_file("P5", grey),
        "p5_16bit_page.pgm": pnm_file("P5", g * 3 // 2, 65535),
        "p2_page.pgm": pnm_file("P2", grey),
    }


# An 8 x 8 grey ramp (4 x the pixel's index) as Pillow 12.1.0 writes it in
# JPEG 2000 and AVIF, codecs whose writers this script does not carry.
JP2_RAMP = bytes.fromhex(
    "0000000c6a5020200d0a870a00000014667479706a703220000000006a7032200000002d6a70326800000016"
    "6968647200000008000000080001070700000000000f636f6c7201000000000011000000b06a703263ff4fff"
    "510029000000000008000000080000000000000000000000080000000800000000000000000001070101ff52"
    "000c00000001000304040001ff5c000d4040484850484850484850ff64002500014372656174656420627920"
    "4f70656e4a5045472076657273696f6e20322e352e34ff90000a0000000000350001ff93c7d40405efc1f382"
    "9f8010043f045fc0f90147da060d010b3d86c07c21c3ea0300221a0f037febffd9")
AVIF_RAMP = bytes.fromhex(
    "00000020667479706176696600000000617669666d6966316d6961664d413142000000eb6d65746100000000"
    "0000002168646c72000000000000000070696374000000000000000000000000000000000e7069746d000000"
    "0000010000001e696c6f630000000044000001000100000001000001130000001a0000002869696e66000000"
    "0000010000001a696e6665020000000001000061763031436f6c6f72000000006a697072700000004b697063"
    "6f0000001469737065000000000000000800000008000000107069786900000000030808080000000c617631"
    "4381000c0000000013636f6c726e636c780001000d0006800000001769706d61000000000000000100010401"
    "028304000000226d64617412000a051808bf6042320f18000a28a2840001bbb94677fc9c52")


def c21_files() -> dict:
    """One file of each format PIL opens that the port did not read when
    C.21 was repaired, by the format's name, built without PIL: a 6 x 9
    grey ramp in AVIF and JPEG 2000 (Pillow's bytes of an 8 x 8 ramp), BLP2
    (a palette), DDS (luminance), DIB, ICNS (a 128 x 128 PNG icon), ICO (a
    PNG icon), CUR (a BMP cursor), IM, MSP, PCX, DCX, PSD, QOI, SGI, SPIDER,
    SUN, TGA, XBM and XPM. PIL reads each (tests/test_torch_port_pil_formats.py);
    the port reads those of ``C21_READ`` (A.6.33-A.6.55) and raises naming
    each other format and ROADMAP A.6."""
    import struct
    import numpy as np
    from siggan_tpu_torch.infer.export import encode_png
    h, w = 6, 9
    g = (np.arange(h * w).reshape(h, w) * 4).astype(np.uint8)
    ink = g < 100
    dib = bmp_grey(g)[14:]
    pcx_rows = b"".join(bytes(b for v in row for b in ((0xC1, v) if v >= 0xC0 else (v,)))
                        + (b"\0" if w % 2 else b"") for row in g)
    pcx = (bytes([10, 5, 1, 8]) + struct.pack("<HHHHHH", 0, 0, w - 1, h - 1, 72, 72) + bytes(48)
           + bytes([0, 1]) + struct.pack("<HH", w + w % 2, 1) + bytes(58) + pcx_rows
           + b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes())
    png = encode_png(g)
    icon = encode_png(np.resize(g, (128, 128)))
    cur_dib = bytearray(dib)
    struct.pack_into("<i", cur_dib, 8, 2 * h)
    msp = [0x6144, 0x4D6E, w, h, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0]
    for v in msp[:12]:
        msp[12] ^= v
    rec = w * 4
    labrec = -(-1024 // rec)
    spider = np.zeros(labrec * rec // 4, ">f4")
    spider[[0, 1, 4, 11, 12, 21, 22]] = [1, h, 1, w, labrec, labrec * rec, rec]
    xbm = np.packbits(ink, axis=1, bitorder="little").reshape(-1)
    xpm_rows = "".join('"' + "".join("a" if v else "b" for v in row) + '",\n' for row in ink)
    return {
        "AVIF": AVIF_RAMP,
        "BLP": (b"BLP2" + struct.pack("<iBBBB", 1, 1, 0, 0, 0) + struct.pack("<II", w, h)
                + struct.pack("<16I", 1172, *[0] * 15) + struct.pack("<16I", w * h, *[0] * 15)
                + np.repeat(np.arange(256, dtype=np.uint8), 4).tobytes() + g.tobytes()),
        "DDS": (b"DDS " + struct.pack("<7I", 124, 0x100F, h, w, w, 0, 0) + bytes(44)
                + struct.pack("<8I", 32, 0x20000, 0, 8, 0xFF, 0, 0, 0) + struct.pack("<I", 0x1000)
                + bytes(16) + g.tobytes()),
        "DIB": dib,
        "ICNS": (b"icns" + struct.pack(">I", 16 + len(icon)) + b"ic07"
                 + struct.pack(">I", 8 + len(icon)) + icon),
        "ICO": struct.pack("<HHHBBBBHHII", 0, 1, 1, w, h, 0, 0, 1, 32, len(png), 22) + png,
        "CUR": struct.pack("<HHHBBBBHHII", 0, 2, 1, w, h, 0, 0, 0, 0, len(cur_dib), 22) + bytes(cur_dib),
        "IM": (f"Image type: Greyscale image\r\nImage size (x*y): {w}*{h}\r\n".encode()
               + b"\x1a" + g.tobytes()),
        "JPEG2000": JP2_RAMP,
        "MSP": struct.pack("<16H", *msp) + np.packbits(~ink, axis=1).tobytes(),
        "PCX": pcx,
        "DCX": struct.pack("<III", 987654321, 12, 0) + pcx,
        "PSD": (b"8BPS" + struct.pack(">H6xHIIHH", 1, 1, h, w, 8, 1) + struct.pack(">III", 0, 0, 0)
                + struct.pack(">H", 0) + g.tobytes()),
        "QOI": (b"qoif" + struct.pack(">IIBB", w, h, 3, 0)
                + b"".join(bytes([0xFE, v, v, v]) for v in g.reshape(-1)) + bytes(7) + b"\x01"),
        "SGI": (struct.pack(">HBBHHHHIIi", 474, 0, 1, 2, w, h, 1, 0, 255, 0) + bytes(488)
                + g[::-1].tobytes()),
        "SPIDER": spider.tobytes() + g.astype(">f4").tobytes(),
        "SUN": (struct.pack(">8I", 0x59A66A95, w, h, 8, h * (w + w % 2), 1, 0, 0)
                + np.pad(g, ((0, 0), (0, w % 2))).tobytes()),
        "TGA": struct.pack("<BBBHHBHHHHBB", 0, 0, 3, 0, 0, 0, 0, 0, w, h, 8, 0x20) + g.tobytes(),
        "XBM": (f"#define ramp_width {w}\n#define ramp_height {h}\nstatic char ramp_bits[] = {{\n"
                + ", ".join(f"0x{b:02x}" for b in xbm) + "\n};\n").encode(),
        "XPM": ("/* XPM */\nstatic char *ramp[] = {\n" + f'"{w} {h} 2 1",\n' + '"a c #000000",\n'
                + '"b c #FFFFFF",\n' + xpm_rows + "};\n").encode(),
    }


# Writers of the formats of A.6.33-A.6.42 (DIB, ICO, CUR, TGA, PCX, DCX,
# SGI, SUN, MSP, QOI), without PIL: phase 12's pages and tree, and the
# tests' hand-built files.

def dib_bytes(rows, w: int, h: int, bits: int, palette=b"", *, header: int = 40,
              compression: int = 0, colors: int = None, masks=b"", top_down: bool = False) -> bytes:
    """A DIB (a BMP without its file header): the info header of
    ``header`` bytes (12: OS/2, else Windows's 40 to 124), ``masks`` after
    it, the ``palette`` entries (3 or 4 bytes each), then ``rows`` (bytes,
    in file order)."""
    import struct
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression,
                           len(rows), 2835, 2835, len(palette) // 4 if colors is None else colors, 0)
        info += bytes(header - 40)
    return info + masks + bytes(palette) + bytes(rows)


def dib_rows(pixels, bits: int) -> bytes:
    """(h, w) indices or (h, w, 3) BGR -> bottom-up rows of ``bits``, each
    padded to 32 bits."""
    import numpy as np
    a = np.asarray(pixels, np.uint8)
    h, w = a.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    for y in range(h):
        r = a[h - 1 - y]
        if bits == 24:
            b = r.reshape(-1)
        elif bits == 8:
            b = r
        else:
            per = 8 // bits
            r = np.pad(r, (0, -w % per)).reshape(-1, per).astype(np.int64)
            b = sum(r[:, i] << (8 - bits * (i + 1)) for i in range(per)).astype(np.uint8)
        out[y, :len(b)] = b
    return out.tobytes()


def icon_dib(grey, bits: int = 8) -> bytes:
    """An icon's bitmap: a DIB of twice its height, the image (grey
    palette indices at 1, 4 or 8 bits, or BGR at 24) then an AND mask of
    every pixel opaque."""
    import numpy as np
    g = np.asarray(grey, np.uint8)
    h, w = g.shape
    if bits == 24:
        pal, px = b"", np.repeat(g[..., None], 3, 2)
    else:
        k = 1 << bits
        levels = (np.arange(k) * 255 // (k - 1)).astype(np.uint8)
        pal = np.repeat(levels[:, None], 4, 1)
        pal[:, 3] = 0
        pal, px = pal.tobytes(), (g.astype(np.int64) * (k - 1) // 255).astype(np.uint8)
    mask = bytes(((w + 31) // 32 * 4) * h)
    return dib_bytes(dib_rows(px, bits) + mask, w, 2 * h, bits, pal)


def ico_file(icons, kind: bytes = b"\x00\x00\x01\x00") -> bytes:
    """An ICO (or, with ``kind`` 0 0 2 0, a CUR) of ``icons``: each (width
    byte, height byte, colours byte, planes, bits, data), the data a DIB
    with its mask or a PNG."""
    import struct
    out = kind + struct.pack("<H", len(icons))
    at, body = 6 + 16 * len(icons), b""
    for w, h, colors, planes, bits, data in icons:
        out += struct.pack("<BBBBHHII", w & 255, h & 255, colors, 0, planes, bits, len(data), at + len(body))
        body += data
    return out + body


def value_runs(a):
    """(start, length) of each run of equal values along the first axis of
    ``a`` (bytes, or pixels of several bytes), in order."""
    import numpy as np
    a = np.asarray(a)
    if not len(a):
        return []
    flat = a.reshape(len(a), -1)
    cut = np.flatnonzero((flat[1:] != flat[:-1]).any(axis=1)) + 1
    starts = np.concatenate([[0], cut])
    return list(zip(starts.tolist(), np.diff(np.concatenate([starts, [len(a)]])).tolist()))


def tga_rle(pixels, cross_rows: bool = True) -> bytes:
    """TGA run-length packets of (h, w, k) pixel bytes in file order: runs
    of a repeated pixel within a row, literal packets of the rest, up to
    128 pixels each; with ``cross_rows`` a literal packet may run on into
    the next row (Pillow's decoder reads that, and refuses a run that
    does)."""
    import numpy as np
    a = np.asarray(pixels, np.uint8)
    h, w, k = a.shape
    raw, out, lit = a.tobytes(), bytearray(), []

    def flush():
        for i in range(0, len(lit), 128):
            part = lit[i:i + 128]
            out.append(len(part) - 1)
            out.extend(raw[part[0] * k:(part[-1] + 1) * k])
        lit.clear()
    for y in range(h):
        for start, n in value_runs(a[y]):
            if n == 1:
                lit.append(y * w + start)
                continue
            flush()
            for i in range(0, n, 128):
                out.append(0x80 | (min(128, n - i) - 1))
                out.extend(raw[(y * w + start) * k:(y * w + start + 1) * k])
        if not cross_rows:
            flush()
    flush()
    return bytes(out)


def tga_file(pixels, image_type: int, depth: int, *, colormap=None, start: int = 0,
             map_depth: int = 24, flags: int = 0x20, image_id: bytes = b"",
             cross_rows: bool = True) -> bytes:
    """A Targa file of (h, w, k) pixel bytes in display order, written top
    down (flag 0x20) or bottom up, mirrored for flag 0x10; ``colormap`` the
    map's raw entries (bytes) from index ``start``; types 9-11 run-length
    coded (``tga_rle``)."""
    import struct
    import numpy as np
    a = np.asarray(pixels, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w = a.shape[:2]
    rows = a if flags & 0x20 else a[::-1]
    if flags & 0x10:
        rows = rows[:, ::-1]
    cmap = bytes(colormap or b"")
    entry = {16: 2, 24: 3, 32: 4}[map_depth]
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), 1 if colormap is not None else 0, image_type,
                       start, len(cmap) // entry, map_depth if colormap is not None else 0,
                       0, 0, w, h, depth, flags)
    if depth == 1:
        body = np.packbits(rows[..., 0] & 1, axis=1).tobytes()
    elif image_type & 8:
        body = tga_rle(rows, cross_rows)
    else:
        body = rows.tobytes()
    return head + image_id + cmap + body


def pcx_rle(row: bytes) -> bytes:
    """PCX run-length coding of one row: runs of up to 63, a byte of 0xC0 or
    more always as a run."""
    import numpy as np
    out = bytearray()
    for start, n in value_runs(np.frombuffer(row, np.uint8)):
        v = row[start]
        if n == 1 and v < 0xC0:
            out.append(v)
            continue
        for i in range(0, n, 63):
            out += bytes([0xC0 | min(63, n - i), v])
    return bytes(out)


def pcx_file(planes_rows, w: int, h: int, bits: int, planes: int, *, version: int = 5,
             header_palette: bytes = b"", palette: bytes = None, stride: int = None) -> bytes:
    """A PCX file: ``planes_rows`` (h rows, each ``planes`` plane rows of
    bytes, each ``stride`` long as the header says, even by default),
    run-length coded; a 16-colour ``header_palette`` and a 768-byte
    ``palette`` after a 0x0C byte at the end."""
    import struct
    stride = stride or ((w * bits + 7) // 8 + 1) & ~1
    head = (bytes([10, version, 1, bits]) + struct.pack("<HHHHHH", 0, 0, w - 1, h - 1, 72, 72)
            + bytes(header_palette).ljust(48, b"\0") + bytes([0, planes])
            + struct.pack("<HH", stride, 1) + bytes(58))
    body = b"".join(pcx_rle(b"".join(bytes(p).ljust(stride, b"\0")[:stride] for p in row))
                    for row in planes_rows)
    return head + body + (b"\x0c" + bytes(palette) if palette is not None else b"")


def pcx_grey(grey, palette: bytes = None) -> bytes:
    """An 8-bit PCX of uint8 (H, W) grey: the identity ramp as its palette
    (PIL's mode L), or ``palette`` (mode P)."""
    import numpy as np
    g = np.asarray(grey, np.uint8)
    h, w = g.shape
    ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    return pcx_file([[r.tobytes()] for r in g], w, h, 8, 1, palette=palette or ramp)


def dcx_file(pages) -> bytes:
    """A DCX of PCX ``pages``: the offset list, ended by 0, then the pages."""
    import struct
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for p in pages:
        offsets.append(at)
        at += len(p)
    return struct.pack(f"<I{len(pages) + 1}I", 987654321, *offsets, 0) + b"".join(pages)


def sgi_rle_row(samples, bpc: int) -> bytes:
    """SGI run-length coding of one channel's row (numbers), ended by a 0
    packet; 2-byte packets and samples at ``bpc`` 2."""
    import numpy as np
    vals, out, lit = np.asarray(samples, np.int64), [], []

    def flush():
        for i in range(0, len(lit), 127):
            part = lit[i:i + 127]
            out.extend([0x80 | len(part)] + part)
        lit.clear()
    for start, n in value_runs(vals):
        v = int(vals[start])
        if n == 1:
            lit.append(v)
            continue
        flush()
        for i in range(0, n, 127):
            out.extend([min(127, n - i), v])
    flush()
    out.append(0)
    return np.asarray(out, ">u2" if bpc == 2 else np.uint8).tobytes()


def sgi_file(channels, bpc: int = 1, rle: bool = False, dimension: int = None) -> bytes:
    """An SGI image of (z, h, w) ``channels`` in display order (rows are
    stored bottom up), raw planes or run-length rows with their tables."""
    import struct
    import numpy as np
    c = np.asarray(channels)
    z, h, w = c.shape
    dimension = dimension or (2 if z == 1 else 3)
    head = struct.pack(">HBBHHHHIIi", 474, 1 if rle else 0, bpc, dimension, w, h, z, 0,
                       255 if bpc == 1 else 65535, 0).ljust(512, b"\0")
    flipped = c[:, ::-1]
    if not rle:
        return head + flipped.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    rows = [sgi_rle_row(flipped[k, y], bpc) for k in range(z) for y in range(h)]
    at, starts = 512 + 8 * z * h, []
    for r in rows:
        starts.append(at)
        at += len(r)
    return head + struct.pack(f">{z * h}I{z * h}I", *starts, *map(len, rows)) + b"".join(rows)


def sun_rle(data: bytes) -> bytes:
    """Sun raster run-length coding: 0x80 n v for n + 1 copies of v, 0x80 0
    for a literal 0x80, other bytes as they are."""
    import numpy as np
    out = bytearray()
    for start, n in value_runs(np.frombuffer(bytes(data), np.uint8)):
        v = data[start]
        for i in range(0, n, 256):
            k = min(256, n - i)
            if k >= 3 or (v == 0x80 and k == 2):
                out += bytes([0x80, k - 1, v])
            else:
                out += (b"\x80\x00" if v == 0x80 else bytes([v])) * k
    return bytes(out)


def sun_file(rows, w: int, h: int, depth: int, *, file_type: int = 1, palette: bytes = b"") -> bytes:
    """A Sun raster file of ``rows`` (bytes in file order): raw rows padded
    to 16 bits, or for ``file_type`` 2 unpadded rows run-length coded; a
    planar RGB ``palette``."""
    import struct
    stride = ((w * depth + 15) // 16) * 2
    if file_type == 2:
        body = sun_rle(b"".join(bytes(r) for r in rows))
    else:
        body = b"".join(bytes(r).ljust(stride, b"\0") for r in rows)
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), file_type,
                       1 if palette else 0, len(palette)) + bytes(palette) + body


def msp_file(ink, version: int = 2) -> bytes:
    """A Windows Paint file of (h, w) bool ``ink`` (set: black): version 1
    raw rows, version 2 a row map and run-length rows (0 n v runs, literal
    runs of up to 255 bytes)."""
    import struct
    import numpy as np
    h, w = ink.shape
    rows = np.packbits(~np.asarray(ink, bool), axis=1)
    words = [0x6144, 0x4D6E, w, h, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0]
    if version == 2:
        words[:2] = [0x694C, 0x536E]
    for v in words[:12]:
        words[12] ^= v
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    coded = []
    for r in rows:
        out, lit = bytearray(), bytearray()

        def flush():
            for i in range(0, len(lit), 255):
                out.append(len(lit[i:i + 255]))
                out.extend(lit[i:i + 255])
            lit.clear()
        for start, n in value_runs(r):
            if n < 3:
                lit.extend(r[start:start + n].tobytes())
                continue
            flush()
            for i in range(0, n, 255):
                out += bytes([0, min(255, n - i), int(r[start])])
        flush()
        coded.append(bytes(out))
    return head + struct.pack(f"<{h}H", *map(len, coded)) + b"".join(coded)


def qoi_file(pixels, channels: int = None) -> bytes:
    """A QOI file of (h, w, 3 or 4) uint8 ``pixels``: the reference
    encoder's ops (run, index, diff, luma, RGB, RGBA) and its end marker."""
    import struct
    import numpy as np
    a = np.asarray(pixels, np.uint8)
    h, w, k = a.shape
    px = np.concatenate([a, np.full((h, w, 1), 255, np.uint8)], 2) if k == 3 else a
    flat = px.reshape(-1, 4)
    out, seen, prev = bytearray(), [[0, 0, 0, 0]] * 64, [0, 0, 0, 255]
    for start, n in value_runs(flat):
        p = flat[start].tolist()
        if p != prev:
            h6 = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
            if seen[h6] == p:
                out.append(h6)
            else:
                seen[h6] = p
                dr, dg, db = ((p[c] - prev[c] + 128) % 256 - 128 for c in range(3))
                if p[3] != prev[3]:
                    out += bytes([0xFF] + p)
                elif -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
                elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
                    out += bytes([0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)])
                else:
                    out += bytes([0xFE] + p[:3])
            prev, n = p, n - 1
        for i in range(0, n, 62):
            out.append(0xC0 | (min(62, n - i) - 1))
    return (b"qoif" + struct.pack(">IIBB", w, h, channels or k, 0) + bytes(out)
            + bytes(7) + b"\x01")


# Writers of the formats of A.6.43-A.6.47 (IM, XBM, XPM, XV thumbnail,
# PSD), without PIL: phase 12's pages and tree, and the tests' hand-built
# files.

def im_file(kind: str, rows, w: int, h: int, *, lines=(), lut: bytes = None) -> bytes:
    """An IM file: "Image type: ``kind``" (ImImagePlugin's OPEN name), its
    size and ``lines``, CR LF each, then ^Z, the 768 bytes of a ``lut``
    (256 reds, greens, blues) and ``rows`` (bytes, the bottom row first)."""
    head = [f"Image type: {kind}", f"Image size (x*y): {w}*{h}", *lines]
    if lut is not None:
        head.append("Lut: 1")
    return ("".join(f"{line}\r\n" for line in head).encode("latin-1") + b"\x1a"
            + (bytes(lut) if lut is not None else b"") + bytes(rows))


def im_grey(grey) -> bytes:
    """A grey IM page: "Greyscale image", rows bottom-up."""
    import numpy as np
    g = np.asarray(grey, np.uint8)
    return im_file("Greyscale image", g[::-1].tobytes(), g.shape[1], g.shape[0])


def xbm_file(white, name: str = "page", hotspot=None, per_line: int = 12, upper: bool = False) -> bytes:
    """An X11 bitmap of a (h, w) bool image, a set bit white (as PIL reads
    it), least significant bit first, ``per_line`` tokens a line."""
    import numpy as np
    a = np.asarray(white, bool)
    h, w = a.shape
    data = np.packbits(a, axis=1, bitorder="little").reshape(-1)
    head = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hotspot:
        head += f"#define {name}_x_hot {hotspot[0]}\n#define {name}_y_hot {hotspot[1]}\n"
    fmt = "0x{:02X}" if upper else "0x{:02x}"
    body = ",\n".join(", ".join(fmt.format(b) for b in data[i:i + per_line])
                      for i in range(0, len(data), per_line))
    return (head + f"static char {name}_bits[] = {{\n{body}\n}};\n").encode()


def xpm_file(indices, colours, *, chars: int = 1, keys=None, header_extra: str = "",
             pixels_comment: bool = True) -> bytes:
    """An X11 pixmap: the "W H C P" line, a "c #RRGGBB" line per colour
    (``colours``: (r, g, b) each; a colour of None is "None"), then a
    quoted line per row of ``indices``' keys, ``chars`` characters a key
    (``keys``: the keys, by default drawn from printable characters)."""
    import numpy as np
    idx = np.asarray(indices)
    h, w = idx.shape
    alphabet = [chr(c) for c in range(35, 127) if chr(c) not in '"\\']
    if keys is None:
        keys = ["".join(alphabet[(k // len(alphabet) ** j) % len(alphabet)] for j in range(chars))
                for k in range(len(colours))]
    lines = ["/* XPM */", "static char *page[] = {", "/* width height colours chars */",
             f'"{w} {h} {len(colours)} {chars}{header_extra}",']
    for key, c in zip(keys, colours):
        lines.append(f'"{key} c {"None" if c is None else "#%02X%02X%02X" % tuple(c)}",')
    if pixels_comment:
        lines.append("/* pixels */")
    lines += ['"' + "".join(keys[v] for v in row) + '",' for row in idx]
    lines.append("};")
    return ("\n".join(lines) + "\n").encode("latin-1")


def xv_thumb(indices, comments=("#XVVERSION:Version 2.28", "#END_OF_COMMENTS")) -> bytes:
    """An XV thumbnail: "P7 332", comment lines, "W H 255", then the rows
    of 3-3-2 palette indices."""
    import numpy as np
    idx = np.asarray(indices, np.uint8)
    h, w = idx.shape
    return (b"P7 332\n" + "".join(f"{c}\n" for c in comments).encode() + f"{w} {h} 255\n".encode()
            + idx.tobytes())


def xv_index(grey):
    """The 3-3-2 palette index nearest each grey level's r = g, b."""
    import numpy as np
    g = np.asarray(grey).astype(np.int64)
    return ((g * 7 + 127) // 255 << 5 | (g * 7 + 127) // 255 << 2 | (g * 3 + 127) // 255).astype(np.uint8)


def psd_file(planes, mode: int, *, bits: int = 8, compression: int = 0, channels: int = None,
             mode_data: bytes = b"", resources: bytes = b"", layers: bytes = b"", counts=None,
             width: int = None) -> bytes:
    """A Photoshop file: the header (``mode``: 0 bitmap, 1 grey, 2 indexed,
    3 RGB, 4 CMYK, 7 multichannel, 8 duotone, 9 LAB; ``channels`` by
    default the planes'; ``width`` by default the rows' pixels), the colour
    mode data, image resources and the layer section as given, then the
    composite image of ``planes`` ((h, row bytes) uint8 each): raw, or
    PackBits a row at a time after the table of row byte counts
    (``counts`` replaces the table)."""
    import struct
    import numpy as np
    planes = [np.asarray(p, np.uint8) for p in planes]
    h = planes[0].shape[0]
    w = width or planes[0].shape[1] * (8 if bits == 1 else 1)
    head = (b"8BPS" + struct.pack(">H6xHIIHH", 1, len(planes) if channels is None else channels, h, w,
                                  bits, mode)
            + struct.pack(">I", len(mode_data)) + mode_data + struct.pack(">I", len(resources)) + resources
            + struct.pack(">I", len(layers)) + layers + struct.pack(">H", compression))
    if compression != 1:
        return head + b"".join(p.tobytes() for p in planes)
    rows = [packbits_encode(r.tobytes()) for p in planes for r in p]
    table = counts if counts is not None else [len(r) for r in rows]
    return head + struct.pack(f">{len(table)}H", *table) + b"".join(rows)


def psd_grey(grey, compression: int) -> bytes:
    """A grey PSD page (mode 1), raw or PackBits."""
    return psd_file([grey], 1, compression=compression)


# The formats of c21_files that the port reads since A.6.33-A.6.55.
C21_READ = ("BLP", "CUR", "DCX", "DDS", "DIB", "ICO", "IM", "MSP", "PCX", "PSD", "QOI", "SGI", "SPIDER", "SUN",
            "TGA", "XBM", "XPM")


def c21_greys() -> dict:
    """The greys ``c21_files``' files of ``C21_READ`` hold: the 6 x 9 ramp;
    IM's upside down (its rows are written top row first, and PIL reads an
    IM file's rows bottom-up); MSP's and XPM's its ink (below 100) black and
    the rest white, XBM's the ink white (a set bit is white to PIL)."""
    import numpy as np
    g = (np.arange(54).reshape(6, 9) * 4).astype(np.uint8)
    ink = np.where(g < 100, 0, 255).astype(np.uint8)
    special = {"MSP": ink, "XPM": ink, "XBM": 255 - ink, "IM": g[::-1]}
    return {f: special.get(f, g) for f in C21_READ}


def a6_raster_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of A.6.33-A.6.42, built without PIL from
    scan_420.jpg's grey, the RLE variant where the format has one: a DIB
    (8-bit, a grey palette), TGA (type 11, grey RLE, bottom-up), PCX (8-bit,
    the identity palette: mode L), DCX (that PCX as its one page), ICO of
    an 8-bit bitmap and ICO of a PNG icon (the page larger than the
    directory's 256), CUR (an 8-bit bitmap), SGI (grey RLE), SUN (type 2,
    8-bit RLE), MSP (version 2, the ink below 128) and QOI (RGB). Each is
    held to a digest of PIL's grey of the same bytes (a6_pages.sha256)."""
    import numpy as np
    from siggan_tpu_torch.infer.export import encode_png
    grey = golden["scan_420.jpg"]
    h, w = grey.shape
    pcx = pcx_grey(grey)
    return {
        "dib_page.dib": bmp_grey(grey)[14:],
        "tga_rle_page.tga": tga_file(grey, 11, 8, flags=0),
        "pcx_page.pcx": pcx,
        "dcx_page.dcx": dcx_file([pcx]),
        "ico_bitmap_page.ico": ico_file([(0, 0, 0, 1, 8, icon_dib(grey, 8))]),
        "ico_png_page.ico": ico_file([(0, 0, 0, 1, 32, encode_png(grey))]),
        "cur_page.cur": ico_file([(0, 0, 0, 1, 0, icon_dib(grey, 8))], b"\0\0\2\0"),
        "sgi_rle_page.sgi": sgi_file(grey[None], 1, rle=True),
        "sun_rle_page.ras": sun_file([r.tobytes() for r in grey], w, h, 8, file_type=2),
        "msp_page.msp": msp_file(grey < 128, 2),
        "qoi_page.qoi": qoi_file(np.repeat(grey[..., None], 3, 2)),
    }


def xpm_grey(grey) -> bytes:
    """An X11 pixmap of a grey: its 256 levels a palette of 2-character keys
    (mode P), each row a quoted line."""
    import numpy as np
    return xpm_file(np.asarray(grey, np.int64), [(v, v, v) for v in range(256)], chars=2)


def a6_text_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of A.6.43-A.6.48, built without PIL from
    scan_420.jpg's grey: IM (grey), XBM (the ink below 128 black), XPM (the
    grey's 256 levels, 2-character keys), XV thumbnail (the 3-3-2 index of
    each level), PSD raw and PackBits (grey), and planar YCbCr old-style
    JPEG-in-TIFF in 1200 x 64 tiles (the grey as Y, two chroma planes of it;
    the last row of tiles partial). Each is held to a digest of PIL's grey
    of the same bytes (a6_pages.sha256)."""
    import numpy as np
    grey = golden["scan_420.jpg"]
    g = grey.astype(np.int64)
    return {
        "im_page.im": im_grey(grey),
        "xbm_page.xbm": xbm_file(grey >= 128),
        "xpm_page.xpm": xpm_grey(grey),
        "xv_thumb_page.xvt": xv_thumb(xv_index(grey)),
        "psd_raw_page.psd": psd_grey(grey, 0),
        "psd_packbits_page.psd": psd_grey(grey, 1),
        "planar_ojpeg_tiles_page.tif": ojpeg_planes_tiles(
            [g, 128 + (g - 128) // 6, 128 - (g - 128) // 5], Q90, 1200, 64),
    }


# Writers of the formats of A.6.49-A.6.55 (DDS, FTEX, BLP, SPIDER), without
# PIL: phase 12's pages and tree, and the tests' hand-built files.

def dds_file(w: int, h: int, data, *, fourcc: bytes = b"", dx10: int = None, flags: int = None,
             bits: int = 0, masks=(0, 0, 0, 0), palette=b"") -> bytes:
    """A DDS file of a ``w`` x ``h`` image: the 124-byte header with pixel
    format ``flags`` (FOURCC where ``fourcc`` is given, else luminance),
    ``bits`` a pixel and four channel ``masks``; DX10's 20 bytes where
    ``dx10`` names a DXGI format; then ``palette`` and ``data``."""
    import struct
    if flags is None:
        flags = 0x4 if fourcc else 0x20000
    head = struct.pack("<7I", 124, 0x100F, h, w, 0, 0, 0) + bytes(44)
    head += struct.pack("<4I", 32, flags, struct.unpack("<I", fourcc or bytes(4))[0], bits)
    head += struct.pack("<4I", *masks) + struct.pack("<I", 0x1000) + bytes(16)
    ext = struct.pack("<5I", dx10, 3, 0, 1, 0) if dx10 is not None else b""
    return b"DDS " + head + ext + bytes(palette) + bytes(data)


def _blocks(grey):
    """(H, W) uint8 -> (H/4 * W/4, 16) int64 4 x 4 blocks in raster order,
    the edges repeated out to a multiple of 4."""
    import numpy as np
    g = np.asarray(grey, np.int64)
    h, w = g.shape
    g = np.pad(g, ((0, -h % 4), (0, -w % 4)), mode="edge")
    return g.reshape(g.shape[0] // 4, 4, g.shape[1] // 4, 4).transpose(0, 2, 1, 3).reshape(-1, 16)


def _unblock(px, h: int, w: int):
    """``_blocks``' inverse: (blocks, 16) values -> (h, w) uint8."""
    import numpy as np
    bh, bw = -(-h // 4), -(-w // 4)
    return px.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)[:h, :w].astype(np.uint8)


def _bit_fields(fields) -> bytes:
    """Blocks of little-endian bit fields: ``fields`` a list of (values of
    shape (blocks,) or (blocks, k), bits each), packed in order, 16 bytes
    or 8 a block."""
    import numpy as np
    cols = []
    for v, nbits in fields:
        v = np.asarray(v, np.int64)
        v = v[:, None] if v.ndim == 1 else v
        cols.append(((v[..., None] >> np.arange(nbits)) & 1).reshape(len(v), -1))
    return np.packbits(np.concatenate(cols, axis=1).astype(np.uint8), axis=1, bitorder="little").tobytes()


def _565(c):
    """565 codes -> (r, g, b) as Pillow's bcn decoder widens them."""
    r, g, b = c >> 11, c >> 5 & 63, c & 31
    return (r << 3 | r >> 2), (g << 2 | g >> 4), (b << 3 | b >> 2)


def bc1_grey(grey) -> tuple:
    """(BC1 blocks, the grey Pillow's bcn decoder gives back) of a uint8
    grey: each block's endpoints its brightest and darkest pixel as 565
    grey (c0 > c1: the 4-colour mode; all index 0 where they meet), each
    pixel the index of the nearest of the four colours' lumas."""
    import numpy as np
    px = _blocks(grey)
    code = lambda v: (v >> 3) << 11 | (v >> 2) << 5 | v >> 3  # noqa: E731
    c0, c1 = code(px.max(1)), code(px.min(1))
    e0, e1 = np.stack(_565(c0), 1), np.stack(_565(c1), 1)
    pal = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], 1)        # (blocks, 4, rgb)
    lum = (19595 * pal[..., 0] + 38470 * pal[..., 1] + 7471 * pal[..., 2] + 0x8000) >> 16
    idx = np.abs(px[:, :, None] - lum[:, None, :]).argmin(2)
    idx[c0 == c1] = 0
    out = np.take_along_axis(lum, idx, 1)
    return _bit_fields([(c0, 16), (c1, 16), (idx, 2)]), _unblock(out, *np.shape(grey))


def bc4_grey(grey) -> tuple:
    """(BC4 blocks, the grey decoded) of a uint8 grey: endpoints each
    block's max and min (the 8-value ramp; index 0 where they meet), each
    pixel the nearest ramp value's index."""
    import numpy as np
    px = _blocks(grey)
    a0, a1 = px.max(1), px.min(1)
    k = np.arange(2, 8)
    ramp = np.concatenate([a0[:, None], a1[:, None],
                           ((8 - k) * a0[:, None] + (k - 1) * a1[:, None]) // 7], 1)
    idx = np.abs(px[:, :, None] - ramp[:, None, :]).argmin(2)
    idx[a0 == a1] = 0
    out = np.take_along_axis(ramp, idx, 1)
    return _bit_fields([(a0, 8), (a1, 8), (idx, 3)]), _unblock(out, *np.shape(grey))


def bc7_grey(grey) -> tuple:
    """(BC7 blocks in mode 6, the grey decoded) of a uint8 grey: one subset,
    7-bit endpoints with a p-bit each (so 8 bits exact: the block's max
    and min in every channel, alpha 255), 4-bit indices to the nearest of
    the 16 weights; endpoints swapped where the first pixel's index would
    need its top bit (the anchor keeps 3)."""
    import numpy as np
    px = _blocks(grey)
    w = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])
    e0, e1 = px.max(1), px.min(1)
    ramp = ((64 - w) * e0[:, None] + w * e1[:, None] + 32) >> 6
    idx = np.abs(px[:, :, None] - ramp[:, None, :]).argmin(2)
    swap = idx[:, 0] >= 8
    e0, e1 = np.where(swap, e1, e0), np.where(swap, e0, e1)
    idx = np.where(swap[:, None], 15 - idx, idx)
    out = np.take_along_axis(((64 - w) * e0[:, None] + w * e1[:, None] + 32) >> 6, idx, 1)
    ends = np.stack([e0 >> 1, e1 >> 1], 1)
    a = np.full_like(ends, 127)
    fields = [(np.full(len(px), 64), 7), (ends, 7), (ends, 7), (ends, 7), (a, 7),
              (np.stack([e0 & 1, e1 & 1], 1), 1), (idx[:, :1], 3), (idx[:, 1:], 4)]
    return _bit_fields(fields), _unblock(out, *np.shape(grey))


def ftex_file(w: int, h: int, data, fmt: int = 0, *, formats: int = 1, size: int = None) -> bytes:
    """An FTEX file: one format (``fmt`` 0 DXT1, 1 raw RGB), one mipmap of
    ``data`` (its byte count ``size``, by default the data's)."""
    import struct
    data = bytes(data)
    return (b"FTEX" + struct.pack("<5i", 0, w, h, 1, formats) + struct.pack("<2i", fmt, 32)
            + struct.pack("<i", len(data) if size is None else size) + data)


def blp_file(w: int, h: int, data, *, version: int = 2, compression: int = 1, encoding: int = 1,
             alpha: int = 0, alpha_encoding: int = 0, jpeg_header=b"", gap=b"", offset: int = None) -> bytes:
    """A BLP file: BLP2 (``encoding`` 1 indices, 2 DXT of ``alpha_encoding``
    0, 1 or 7) or BLP1 (``compression`` 1: a palette and ``encoding`` 4 or
    5; 0: a JPEG whose ``jpeg_header`` comes before the mipmap table's
    first entry, ``data`` the rest). The palette is a grey ramp of BGRA
    entries; the first mipmap is ``data``, after ``gap``, its offset in
    the table ``offset`` (by default where it is)."""
    import struct
    import numpy as np
    data = bytes(data)
    palette = np.repeat(np.arange(256, dtype=np.uint8), 4).tobytes()
    if version == 2:
        head = b"BLP2" + struct.pack("<iBBBB", compression, encoding, alpha, alpha_encoding, 0)
        head += struct.pack("<II", w, h)
    else:
        head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h, encoding, 0)
    if version == 1 and compression == 0:
        body = struct.pack("<I", len(jpeg_header)) + bytes(jpeg_header)
    else:
        body = bytes(palette)
    at = len(head) + 128 + len(body) + len(gap) if offset is None else offset
    return (head + struct.pack("<16I", at, *[0] * 15) + struct.pack("<16I", len(data), *[0] * 15) + body
            + bytes(gap) + data)


def blp_grey(grey, alpha_encoding: int = None) -> bytes:
    """A BLP2 page of a uint8 grey: its indices over the grey ramp, or
    (``alpha_encoding`` 0) ``bc1_grey``'s DXT1 blocks."""
    import numpy as np
    g = np.asarray(grey, np.uint8)
    h, w = g.shape
    if alpha_encoding is None:
        return blp_file(w, h, g.tobytes())
    return blp_file(w, h, bc1_grey(g)[0], encoding=2, alpha_encoding=alpha_encoding)


def spider_file(values, big_endian: bool = True, *, stack: int = 0, fields: dict = None) -> bytes:
    """A SPIDER 2D image of (h, w) ``values`` as float32: the header
    padded to whole records of 4 w bytes (at least 1024 bytes), its fields
    1-based (``fields`` overrides any), ``stack`` its istack (a stack's
    first image after a second header)."""
    import numpy as np
    v = np.asarray(values, np.float32)
    h, w = v.shape
    rec = 4 * w
    labrec = -(-1024 // rec)
    head = np.zeros(labrec * rec // 4, np.float32)
    for k, x in {1: 1, 2: h, 5: 1, 12: w, 13: labrec, 22: labrec * rec, 23: rec, 24: stack, 26: 1,
                 **(fields or {})}.items():
        head[k - 1] = x
    order = ">f4" if big_endian else "<f4"
    body = head.astype(order).tobytes()
    if stack > 0:
        body += body
    return body + v.astype(order).tobytes()


def a6_texture_pages(golden) -> dict:
    """Phase 12's 1200 x 500 pages of A.6.49-A.6.55, built without PIL from
    scan_420.jpg's grey: DDS uncompressed (luminance), BC1, BC4 and BC7
    (mode 6), FTEX (DXT1), BLP2 (DXT1 and the grey's indices), BLP1 (a
    palette) and SPIDER (the grey as floats, stretched past 0 .. 255 so
    that convert("L") clips). Each is held to a digest of PIL's grey of the
    same bytes (a6_pages.sha256)."""
    import numpy as np
    grey = golden["scan_420.jpg"]
    h, w = grey.shape
    return {
        "dds_l_page.dds": dds_file(w, h, grey.tobytes(), bits=8),
        "dds_bc1_page.dds": dds_file(w, h, bc1_grey(grey)[0], fourcc=b"DXT1"),
        "dds_bc4_page.dds": dds_file(w, h, bc4_grey(grey)[0], fourcc=b"ATI1"),
        "dds_bc7_page.dds": dds_file(w, h, bc7_grey(grey)[0], fourcc=b"DX10", dx10=98),
        "ftex_page.ftc": ftex_file(w, h, bc1_grey(grey)[0]),
        "blp_dxt1_page.blp": blp_grey(grey, 0),
        "blp_palette_page.blp": blp_grey(grey),
        "blp1_palette_page.blp": blp_file(w, h, grey.tobytes(), version=1, encoding=5),
        "spider_page.spi": spider_file(grey.astype(np.float32) * 1.25 - 20.3),
    }


# The formats of A.6.33-A.6.55 in phase 12's raster tree, in turns (ICO with
# a bitmap and with a PNG icon; DDS as BC7, FTEX as DXT1, BLP as BLP2 of a
# grey palette).
RASTER_TREE_KINDS = ("DIB", "TGA", "PCX", "DCX", "ICO", "ICO-PNG", "CUR", "SGI", "SUN", "MSP", "QOI",
                     "IM", "XBM", "XPM", "XVThumb", "PSD", "DDS", "FTEX", "BLP", "SPIDER")

# The kinds of RASTER_TREE_KINDS that do not keep every grey level.
RASTER_TREE_LOSSY = ("MSP", "XBM", "XVThumb", "DDS", "FTEX")


def raster_grey(kind: str, grey):
    """The grey PIL reads back from ``raster_scan``'s file of a uint8 scan:
    the scan, but MSP's and XBM's 1 bit (the ink below 128, black), the
    XV thumbnail's 3-3-2 palette (each level's index, then PIL's luma) and
    the block encoders' greys (DDS: BC7, FTEX: BC1)."""
    import numpy as np
    if kind == "DDS":
        return bc7_grey(grey)[1]
    if kind == "FTEX":
        return bc1_grey(grey)[1]
    if kind in ("MSP", "XBM"):
        return np.where(grey < 128, 0, 255).astype(np.uint8)
    if kind == "XVThumb":
        idx = xv_index(grey).astype(np.int64)
        r, g, b = (idx >> 5) * 255 // 7, (idx >> 2 & 7) * 255 // 7, (idx & 3) * 255 // 3
        return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)
    return grey


def raster_scan(kind: str, grey, png: bytes = None) -> tuple:
    """(bytes, the grey PIL reads back: ``raster_grey``) of a uint8 (H, W)
    scan as a file of ``kind`` (``RASTER_TREE_KINDS``); an ICO's PNG icon
    is ``png`` (the grey's PNG)."""
    import numpy as np
    h, w = grey.shape
    if kind == "ICO-PNG" and png is None:
        from siggan_tpu_torch.infer.export import encode_png
        png = encode_png(grey)
    if kind in RASTER_TREE_LOSSY:
        data = {"MSP": lambda: msp_file(grey < 128, 2), "XBM": lambda: xbm_file(grey >= 128),
                "XVThumb": lambda: xv_thumb(xv_index(grey)),
                "DDS": lambda: dds_file(w, h, bc7_grey(grey)[0], fourcc=b"DX10", dx10=98),
                "FTEX": lambda: ftex_file(w, h, bc1_grey(grey)[0])}[kind]()
        return data, raster_grey(kind, grey)
    data = {"DIB": lambda: bmp_grey(grey)[14:],
            "TGA": lambda: tga_file(grey, 11, 8),
            "PCX": lambda: pcx_grey(grey),
            "DCX": lambda: dcx_file([pcx_grey(grey)]),
            "ICO": lambda: ico_file([(w, h, 0, 1, 8, icon_dib(grey, 8))]),
            "ICO-PNG": lambda: ico_file([(w, h, 0, 1, 32, png)]),
            "CUR": lambda: ico_file([(w, h, 0, 1, 0, icon_dib(grey, 8))], b"\0\0\2\0"),
            "SGI": lambda: sgi_file(grey[None], 1, rle=True),
            "SUN": lambda: sun_file([r.tobytes() for r in grey], w, h, 8, file_type=2),
            "QOI": lambda: qoi_file(np.repeat(grey[..., None], 3, 2)),
            "IM": lambda: im_grey(grey),
            "XPM": lambda: xpm_grey(grey),
            "PSD": lambda: psd_grey(grey, 1),
            "BLP": lambda: blp_grey(grey),
            "SPIDER": lambda: spider_file(grey)}[kind]()
    return data, grey


# The decoder fixtures of A.6.7-A.6.12 (tests/test_torch_port_decode.py::
# write_fixtures).
LAYOUT_FIXTURES = ("bigtiff_lzw.tif", "planar_rgb.tif", "planar_cmyk_raw.tif", "ycbcr_22.tif",
                   "ycbcr_44_tiles.tif", "ycbcr_raw.tif", "fill2_lzw_rgb.tif", "fill2_raw_grey.tif",
                   "rgba_assoc.tif", "pa.tif")


def gray_digest(gray) -> str:
    """SHA-256 of a grey image's shape and pixels, in hex."""
    import numpy as np
    data = repr(gray.shape).encode() + np.ascontiguousarray(gray).tobytes()
    return hashlib.sha256(data).hexdigest()


def golden_arrays() -> dict:
    """The decoder fixtures' golden arrays by name. Four fixtures hold
    pixels another's array holds, and ``golden.npz`` no array of their own:
    the progressive page scan_420.jpg's (its quality and subsampling),
    arith_444.jpg restart_444.jpg's (its coefficients arithmetic-coded),
    lossless_stripe.jpg the first 8 rows of scan_420.jpg's grey and
    zstd_g4_page.tif ccitt_g4_page.tif's (PIL's ZSTD TIFF of that grey)."""
    import numpy as np
    with np.load(FIXTURES / "golden.npz") as f:
        golden = dict(f)
    return {**golden, "progressive_page.jpg": golden["scan_420.jpg"],
            "arith_444.jpg": golden["restart_444.jpg"],
            "lossless_stripe.jpg": golden["scan_420.jpg"][:8],
            "zstd_g4_page.tif": golden["ccitt_g4_page.tif"]}


def decode_phase(card: str, work: str, build_s: float):
    """Phase 12: the host decoders: the fixtures bit-equal to their golden
    arrays, the pages built here bit-equal to their sources or to digests
    of PIL's grey (the TIFF layouts of A.6.7-A.6.12, LZMA TIFF, damaged
    Group 4 data, Group 4 in tiles, with a palette and with the
    uncompressed-mode bit, old-style LZW and old-style JPEG-in-TIFF in tiles,
    JPEG-in-TIFF of photometric 0, of 12 bits and planar, CCITT RLE-W,
    ThunderScan and LZMA with the ARM64 BCJ filter among them, planar YCbCr
    old-style JPEG-in-TIFF, GIF and PGM; a SOF11 JPEG corrupt, as PIL
    refuses it), Pillow's three WebP pages to their digests, a cut
    progressive scan script smoothed, a file PIL refuses a zero image, the
    threaded batch decode's rate per format, ``cli.preprocess`` and a
    ``SignatureDataset`` on a mixed tree of 1320 scans whose TIFFs take
    those layouts in turns and whose PNGs are in turns GIF and PGM files
    named .png, then SOF11 JPEGs added to it: zero images in the dataset,
    and ``cli.preprocess`` stops on one; the same scans as WebP files
    under .jpg and .png names (``webp_tree_step``) and in the formats of
    A.6.33-A.6.55 (``raster_tree_step``; their pages, ``a6_raster_pages``,
    ``a6_text_pages`` with planar old-style JPEG-in-TIFF in tiles and
    ``a6_texture_pages``, held to PIL's grey by digest and timed); then the C.21 files the port
    now reads, and a tree for each format PIL opens and the port does not
    read: the build stops naming it (A.6). ``build_s``: the library's g++
    build, timed where it was built."""
    import shutil
    import numpy as np
    import torch
    from siggan_tpu_torch.cli import preprocess as pre_cli
    from siggan_tpu_torch.data import dataset as ds_mod
    from siggan_tpu_torch.data.native import loader as native
    from siggan_tpu_torch.infer.export import decode_png

    import lzma  # the LZMA page is written here; no fallback if the stdlib lacks it
    golden = golden_arrays()
    if len(golden) != 59:
        raise AssertionError(f"expected 59 decoder fixtures, found {sorted(golden)}")
    for name, want in golden.items():
        got = ds_mod.decode_gray(FIXTURES / name)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"decoder fixture {name}: not bit-equal to PIL's grey")
    print(f"decode: g++ build of data/native/decode.cpp and webp.cpp {build_s:.2f} s (at the "
          f"script's start); all {len(golden)} "
          f"fixtures bit-equal to PIL's grey ({', '.join(sorted(golden))})", flush=True)
    # The Deflate page: lossless, so its golden is the grey it was written from.
    deflate_page = Path(work) / "deflate_page.tif"
    deflate_page.write_bytes(tiff_grey(golden["scan_420.jpg"], 54, deflate=True))
    if not np.array_equal(ds_mod.decode_gray(deflate_page), golden["scan_420.jpg"]):
        raise AssertionError("the Deflate page is not bit-equal to the grey it was written from")
    # PIL's progressive script cut after 6 of its 10 scans: libjpeg smooths
    # its unrefined coefficients between blocks, and so does the port. Its
    # grey is held to the digest of PIL's that the fixtures keep
    # (progressive_cut_page.sha256; progressive_cut.jpg above is a small
    # such cut, held to PIL's grey itself).
    page = (FIXTURES / "progressive_page.jpg").read_bytes()
    sos = [i for i in range(len(page) - 1) if page[i] == 0xFF and page[i + 1] == 0xDA]
    cut_page = Path(work) / "progressive_cut_page.jpg"
    cut_page.write_bytes(page[:sos[6]] + b"\xff\xd9")
    cut = ds_mod.decode_gray(cut_page)
    if (cut.shape != (500, 1200) or [gray_digest(cut)]
            != (FIXTURES / "progressive_cut_page.sha256").read_text().split()):
        raise AssertionError("the cut progressive page is not bit-equal to PIL's grey")
    # Page-sized files of the kinds this slice reads, with golden arrays
    # from the fixtures': restart intervals of restart_444.jpg and cmyk.jpg
    # tiled into 1200 x 500 pages (some restart markers numbered 4 ahead,
    # which libjpeg's resynchronisation consumes), and a CMYK TIFF of
    # scan_420.jpg's grey as K ink.
    pages = {"restart_damaged_page.jpg": (tile_jpeg(
                 (FIXTURES / "restart_444.jpg").read_bytes(), 1200, 500, page_pick, renumber_ahead),
                 tile_golden(golden["restart_444.jpg"], 1200, 500, page_pick)),
             "cmyk_page.jpg": (tile_jpeg((FIXTURES / "cmyk.jpg").read_bytes(), 1200, 500,
                                         page_pick),
                               tile_golden(golden["cmyk.jpg"], 1200, 500, page_pick)),
             "cmyk_page.tif": (tiff_cmyk(golden["scan_420.jpg"], 50), golden["scan_420.jpg"])}
    for name, (data, want) in pages.items():
        (Path(work) / name).write_bytes(data)
        if not np.array_equal(ds_mod.decode_gray(Path(work) / name), want):
            raise AssertionError(f"{name}: not bit-equal to the grey it was built from")
    # Pages of old-style JPEG-in-TIFF, float TIFF, arithmetic-coded and
    # lossless JPEG, of the TIFF layouts of A.6.7-A.6.12, of LZMA TIFF, of
    # damaged Group 4 data (C.14) and of A.6.15-A.6.25, each held to the
    # digest of PIL's grey of the same bytes (a6_pages.sha256), or to PIL's
    # refusal (the arithmetic page past PIL's 64 KB block and the SOF11
    # stripe: corrupt).
    digests = dict(reversed(line.split()) for line in
                   (FIXTURES / "a6_pages.sha256").read_text().splitlines())
    a6 = {**a6_pages(golden), **a6_layout_pages(golden), **a6_codec_pages(golden),
          **a6_ccitt_lzw_pages(golden), **a6_kind_pages(golden), **a6_gif_pnm_pages(golden),
          **a6_raster_pages(golden), **a6_text_pages(golden), **a6_texture_pages(golden)}
    for name, data in a6.items():
        (Path(work) / name).write_bytes(data)
        if digests[name] == "refused":
            try:
                native.decode(data, name)
            except ValueError:
                continue
            raise AssertionError(f"{name}: PIL refuses it, the port read it")
        got = ds_mod.decode_gray(Path(work) / name)
        if got.shape[1] != 1200 or gray_digest(got) != digests[name]:
            raise AssertionError(f"{name}: not bit-equal to PIL's grey (its SHA-256)")
    print("decode: " + ", ".join(f"{n} ({len(d)} B, {digests[n][:16]})" for n, d in a6.items())
          + " bit-equal to PIL's grey by their SHA-256, or corrupt where PIL refuses them ("
          + ", ".join(n for n in a6 if digests[n] == "refused") + ")", flush=True)
    # Pillow's WebP pages (A.6.30-A.6.32): lossy 'VP8 ', lossless grey 'VP8L',
    # lossy with ALPH in VP8X, each held to the digest of PIL's grey.
    for name in WEBP_PAGES_NAMES:
        got = ds_mod.decode_gray(WEBP_PAGES / name)
        if got.shape != (500, 1200) or gray_digest(got) != digests[name]:
            raise AssertionError(f"{name}: not bit-equal to PIL's grey (its SHA-256)")
    print("decode: " + ", ".join(f"{n} ({(WEBP_PAGES / n).stat().st_size} B, {digests[n][:16]})"
                                 for n in WEBP_PAGES_NAMES)
          + " bit-equal to PIL's grey by their SHA-256", flush=True)
    # A file PIL refuses (grey.jpg as a 12-bit frame) is a zero image in a
    # SignatureDataset beside a good one, as in the JAX package.
    refused = Path(work) / "refused_set"
    refused.mkdir(exist_ok=True)
    grey = bytearray((FIXTURES / "grey.jpg").read_bytes())
    at = grey.index(b"\xff\xc0")
    grey[at + 1], grey[at + 4] = 0xC1, 12
    (refused / "a_twelve_bit.jpg").write_bytes(bytes(grey))
    shutil.copy(FIXTURES / "grey.jpg", refused / "b_grey.jpg")
    refused_ds = ds_mod.SignatureDataset(refused, 64, use_cache=False)
    if refused_ds.images[0].any() or not refused_ds.images[1].any():
        raise AssertionError("a 12-bit JPEG beside a good one: not a zero image and a decoded one")
    print(f"decode: a Deflate 1200x500 page written here from scan_420.jpg's grey "
          f"({deflate_page.stat().st_size} B, predictor 2) bit-equal to it; the progressive page "
          f"cut after 6 of its {len(sos)} scans (libjpeg's block smoothing) bit-equal to PIL's "
          f"grey by its SHA-256; "
          + ", ".join(f"{n} ({len(d)} B)" for n, (d, _) in pages.items())
          + " bit-equal to the golden arrays they were built from; a 12-bit JPEG (PIL refuses "
          "it) a zero image in a SignatureDataset beside grey.jpg", flush=True)

    new = {"progressive_page.jpg", "progressive_grey.jpg", "progressive_420.jpg",
           "deflate_pred2.tif", "jpeg_ycbcr.tif", "jpeg_grey.tif", "restart_444.jpg",
           "restart_damaged.jpg", "bad_code.jpg", "dqt_q64.jpg", "cmyk.jpg", "ycck.jpg",
           "cmyk.tif", "progressive_cut.jpg", "ojpeg_grey.tif", "ojpeg_420.tif",
           "ojpeg_tables_420.tif", "float32_pred3.tif", "int16_be.tif", "uint32.tif",
           "grey12.tif", "int32_lzw.tif", "lossless_rgb.jpg", "arith_progressive.jpg",
           "arith_444.jpg", "lossless_stripe.jpg", "zstd_g4_page.tif", *LAYOUT_FIXTURES}
    old = [n for n in golden if n not in new]

    def fixtures(*names):
        return [FIXTURES / n for n in names]
    groups = {"JPEG 1200x500": (fixtures(*[n for n in old if n.startswith("scan_")]), 20),
              "JPEG 210x80": (fixtures(*[n for n in old if n.endswith(".jpg")
                                         and not n.startswith("scan_")]), 100),
              "BMP 210x80": (fixtures(*[n for n in old if n.endswith(".bmp")]), 100),
              "TIFF 210x80": (fixtures(*[n for n in old if n.endswith(".tif")
                                         and not n.startswith("ccitt_")]), 100),
              "CCITT TIFF 210x80 (G4, 2-D T.4, MH)": (
                  fixtures(*[n for n in old if n.startswith("ccitt_")
                             and not n.endswith("_page.tif")]), 100),
              "CCITT G4 TIFF 1200x500": (fixtures("ccitt_g4_page.tif"), 200),
              "progressive JPEG 1200x500 (4:2:0, PIL's 10 scans)": (
                  fixtures("progressive_page.jpg"), 60),
              "progressive JPEG 210x80 (grey; 4:2:0 optimised, restarts)": (
                  fixtures("progressive_grey.jpg", "progressive_420.jpg"), 100),
              "Deflate TIFF 1200x500 (grey, predictor 2)": ([deflate_page], 100),
              "Deflate TIFF 210x80 (RGB, predictor 2)": (fixtures("deflate_pred2.tif"), 100),
              "JPEG-in-TIFF 210x80 (YCbCr 4:2:0 in 5 strips; grey)": (
                  fixtures("jpeg_ycbcr.tif", "jpeg_grey.tif"), 100),
              "restart-damaged JPEG 1200x500 (4:4:4, restart markers numbered 4 ahead)": (
                  [Path(work) / "restart_damaged_page.jpg"], 20),
              "CMYK JPEG 1200x500 (Adobe, 4:4:4)": ([Path(work) / "cmyk_page.jpg"], 20),
              "CMYK TIFF 1200x500 (Deflate strips)": ([Path(work) / "cmyk_page.tif"], 20),
              "progressive JPEG 1200x500 cut after 6 scans (block smoothing)": ([cut_page], 20),
              "damaged JPEG 200x80 (restart marker missing; bad code; q = 64 at 32x32)": (
                  fixtures("restart_damaged.jpg", "bad_code.jpg", "dqt_q64.jpg"), 100),
              "CMYK and YCCK JPEG, CMYK TIFF 200x80": (
                  fixtures("cmyk.jpg", "ycck.jpg", "cmyk.tif"), 100),
              "old-style JPEG-in-TIFF 1200x500 (scan_420.jpg, YCbCr 4:2:0)": (
                  [Path(work) / "ojpeg_page.tif"], 20),
              "float32 TIFF 1200x500 (Deflate strips, predictor 3)": (
                  [Path(work) / "float32_page.tif"], 20),
              "arithmetic-coded JPEG 1200x160 (4:4:4, a restart an MCU row; inside PIL's "
              "64 KB block)": ([Path(work) / "arith_band.jpg"], 40),
              "lossless JPEG 1200x500 (grey, predictor 1, a restart a row)": (
                  [Path(work) / "lossless_page.jpg"], 20),
              "old-style JPEG-in-TIFF 48x32 (grey; 4:2:0 in both layouts)": (
                  fixtures("ojpeg_grey.tif", "ojpeg_420.tif", "ojpeg_tables_420.tif"), 200),
              "number TIFF 48x32 (float32, int16, uint32, 12-bit, int32)": (
                  fixtures("float32_pred3.tif", "int16_be.tif", "uint32.tif", "grey12.tif",
                           "int32_lzw.tif"), 200),
              "lossless and arithmetic-coded JPEG 48x32": (
                  fixtures("lossless_rgb.jpg", "arith_progressive.jpg"), 200),
              "BigTIFF 1200x500 (LZW strips)": ([Path(work) / "bigtiff_page.tif"], 20),
              "planar RGB TIFF 1200x500 (Deflate, predictor 2)": (
                  [Path(work) / "planar_page.tif"], 20),
              "YCbCr TIFF 1200x500 (2x2, Deflate; libtiff's RGBA reader)": (
                  [Path(work) / "ycbcr_page.tif"], 20),
              "CCITT G4 TIFF 1200x500 with FillOrder 2": ([Path(work) / "fill2_g4_page.tif"], 200),
              "palette + alpha TIFF 1200x500 (PA, Deflate)": ([Path(work) / "pa_page.tif"], 20),
              "TIFF layouts 48x32 (BigTIFF, planar, YCbCr, FillOrder 2, RGBa, PA)": (
                  fixtures(*LAYOUT_FIXTURES), 200),
              "LZMA TIFF 1200x500 (Delta + LZMA2, 50-row strips)": (
                  [Path(work) / "lzma_page.tif"], 20),
              "ZSTD TIFF 1200x500 (PIL's, of the G4 page's grey)": (
                  fixtures("zstd_g4_page.tif"), 20),
              "CCITT G4 TIFF 1200x500 with damaged code (C.14)": (
                  [Path(work) / "damaged_g4_page.tif"], 200),
              "CCITT G4 TIFF 1200x500 in 256x256 tiles": ([Path(work) / "g4_tiles_page.tif"], 200),
              "CCITT G4 TIFF 1200x500, 1-bit palette in 256x256 tiles": (
                  [Path(work) / "g4_palette_page.tif"], 200),
              "CCITT G4 TIFF 1200x500, uncompressed-mode bit set": (
                  [Path(work) / "g4_uncompressed_page.tif"], 200),
              "old-style LZW TIFF 1200x500 (grey, 50-row strips)": (
                  [Path(work) / "old_lzw_page.tif"], 20),
              "old-style JPEG-in-TIFF 1200x500 in 400x80 tiles (YCbCr 4:4:4)": (
                  [Path(work) / "ojpeg_tiles_page.tif"], 20),
              "JPEG-in-TIFF 1200x500, WhiteIsZero (grey SOF1, 50-row strips)": (
                  [Path(work) / "jpeg_white_is_zero_page.tif"], 20),
              "JPEG-in-TIFF 1200x500, 12-bit (SOF1, 50-row strips)": (
                  [Path(work) / "jpeg_12bit_page.tif"], 20),
              "JPEG-in-TIFF 1200x500, planar RGB (a SOF1 stream a plane a strip)": (
                  [Path(work) / "planar_jpeg_page.tif"], 20),
              "CCITT RLE-W TIFF 1200x500 (the G4 page's ink, 50-row strips)": (
                  [Path(work) / "rlew_page.tif"], 200),
              "ThunderScan TIFF 1200x500 (4-bit grey, 50-row strips)": (
                  [Path(work) / "thunderscan_page.tif"], 20),
              "LZMA TIFF 1200x500 with the ARM64 BCJ filter (one strip)": (
                  [Path(work) / "lzma_arm64_page.tif"], 20),
              "old-style JPEG-in-TIFF 1200x500, planar YCbCr (a plane a strip, C.20)": (
                  [Path(work) / "planar_ojpeg_page.tif"], 20),
              "GIF 1200x500 (identity ramp: mode L)": ([Path(work) / "gif_page.gif"], 20),
              "GIF 1200x500, interlaced (a tinted table: mode P)": (
                  [Path(work) / "gif_interlaced_page.gif"], 20),
              "PGM 1200x500, raw 8-bit (P5)": ([Path(work) / "p5_page.pgm"], 20),
              "PGM 1200x500, raw 16-bit (P5, maxval 65535)": ([Path(work) / "p5_16bit_page.pgm"], 20),
              "PGM 1200x500, plain (P2)": ([Path(work) / "p2_page.pgm"], 20),
              "WebP 1200x500, lossy (Pillow's q80 'VP8 ', RGB)": (
                  [WEBP_PAGES / "webp_lossy_page.webp"], 20),
              "WebP 1200x500, lossless (Pillow's 'VP8L', grey)": (
                  [WEBP_PAGES / "webp_lossless_page.webp"], 20),
              "WebP 1200x500, lossy with alpha (Pillow's VP8X + ALPH, q80)": (
                  [WEBP_PAGES / "webp_alpha_page.webp"], 20),
              "DIB 1200x500 (8-bit, a grey palette)": ([Path(work) / "dib_page.dib"], 100),
              "TGA 1200x500 (grey RLE, type 11)": ([Path(work) / "tga_rle_page.tga"], 100),
              "PCX 1200x500 (8-bit RLE, mode L)": ([Path(work) / "pcx_page.pcx"], 100),
              "DCX 1200x500 (that PCX as its page)": ([Path(work) / "dcx_page.dcx"], 100),
              "ICO 1200x500 (an 8-bit bitmap and its mask)": ([Path(work) / "ico_bitmap_page.ico"], 100),
              "CUR 1200x500 (an 8-bit bitmap and its mask)": ([Path(work) / "cur_page.cur"], 100),
              "SGI 1200x500 (grey RLE)": ([Path(work) / "sgi_rle_page.sgi"], 100),
              "SUN 1200x500 (8-bit RLE, type 2)": ([Path(work) / "sun_rle_page.ras"], 100),
              "MSP 1200x500 (version 2 RLE, 1 bit)": ([Path(work) / "msp_page.msp"], 100),
              "QOI 1200x500 (RGB)": ([Path(work) / "qoi_page.qoi"], 100),
              "IM 1200x500 (grey)": ([Path(work) / "im_page.im"], 100),
              "XBM 1200x500 (1 bit, hex text)": ([Path(work) / "xbm_page.xbm"], 20),
              "XPM 1200x500 (256 colours, 2-character keys)": ([Path(work) / "xpm_page.xpm"], 20),
              "XV thumbnail 1200x500 (3-3-2 palette)": ([Path(work) / "xv_thumb_page.xvt"], 100),
              "PSD 1200x500 (grey, raw)": ([Path(work) / "psd_raw_page.psd"], 100),
              "PSD 1200x500 (grey, PackBits)": ([Path(work) / "psd_packbits_page.psd"], 100),
              "old-style JPEG-in-TIFF 1200x500, planar YCbCr in 1200x64 tiles (A.6.48)": (
                  [Path(work) / "planar_ojpeg_tiles_page.tif"], 20),
              "DDS 1200x500 (uncompressed luminance)": ([Path(work) / "dds_l_page.dds"], 100),
              "DDS 1200x500 (BC1)": ([Path(work) / "dds_bc1_page.dds"], 100),
              "DDS 1200x500 (BC4)": ([Path(work) / "dds_bc4_page.dds"], 100),
              "DDS 1200x500 (BC7, mode 6)": ([Path(work) / "dds_bc7_page.dds"], 100),
              "FTEX 1200x500 (DXT1)": ([Path(work) / "ftex_page.ftc"], 100),
              "BLP2 1200x500 (DXT1)": ([Path(work) / "blp_dxt1_page.blp"], 100),
              "BLP2 1200x500 (grey palette)": ([Path(work) / "blp_palette_page.blp"], 100),
              "BLP1 1200x500 (palette)": ([Path(work) / "blp1_palette_page.blp"], 100),
              "SPIDER 1200x500 (float32, big-endian)": ([Path(work) / "spider_page.spi"], 100)}
    rates = {}
    for fmt, (files, reps) in groups.items():
        paths = files * reps
        for threads in (1, 8):
            native.decode_files(files, threads)
            t0 = time.perf_counter()
            _, status, _, _ = native.decode_files(paths, threads)
            dt = time.perf_counter() - t0
            if (status != native.OK).any():
                raise AssertionError(f"batch decode of {fmt}: statuses {set(status.tolist())}")
            rates[f"{fmt}, {threads} thread{'s' if threads > 1 else ''}"] = len(paths) / dt
    # The ICO of a PNG icon comes back from the C++ batch as a PNG stream:
    # decode_images decodes it (decode_png) and resizes it to 64.
    icos = [Path(work) / "ico_png_page.ico"] * 40
    for threads in (1, 8):
        ds_mod.decode_images(icos[:2], 64, n_threads=threads)
        t0 = time.perf_counter()
        ds_mod.decode_images(icos, 64, n_threads=threads)
        rates[f"ICO 1200x500 of a PNG icon (decode_images: decode_png, resized to 64), {threads} "
              f"thread{'s' if threads > 1 else ''}"] = len(icos) / (time.perf_counter() - t0)
    pngs = [FIXTURES / n for n in golden if n.endswith(".png")] * 30
    for threads in (1, 8, None):
        t0 = time.perf_counter()
        ds_mod.decode_images(pngs, 64, n_threads=threads)
        rates[f"PNG 210x80 (decode_images: zlib + C++ unfilter, resized to 64), "
              f"{pool_label(ds_mod, pngs, threads)}"] = len(pngs) / (time.perf_counter() - t0)
    for k, v in rates.items():
        print(f"decode: {k}: {v:.1f} images/s [{card}]", flush=True)

    # A mixed tree in CEDAR's shape from phase 11's scans: per writer, PNG,
    # BMP, TIFF and JPEG in turns (the JPEGs are the fixtures' scan pages);
    # the TIFFs in turn plain, of the layouts of A.6.7-A.6.12, LZMA, ZSTD
    # (the fixture page), damaged Group 4 (the damaged page), Group 4 in
    # tiles, with a palette and with the uncompressed-mode bit, old-style
    # LZW, and the kinds of A.6.20-A.6.25.
    raw, mixed = Path(work) / "scans", Path(work) / "mixed_scans"
    jpegs = sorted(FIXTURES.glob("scan_*.jpg"))
    t0 = time.perf_counter()
    kinds = {".png": 0, ".bmp": 0, ".tif": 0, ".jpg": 0}
    layouts = {}
    png_named = {"GIF": 0, "PGM": 0}  # other formats under a .png name (A.6.28, A.6.29)
    for i, p in enumerate(sorted(raw.rglob("*.png"))):
        d = mixed / p.parent.name
        d.mkdir(parents=True, exist_ok=True)
        k = i % 4
        if k == 0 and (i // 4) % 3:  # a GIF (interlaced in turns) or a PGM, named .png
            grey = decode_png(p.read_bytes())[..., 0]
            fmt = "GIF" if (i // 4) % 3 == 1 else "PGM"
            (d / p.name).write_bytes(gif_file(grey, interlace=(i // 12) % 2 == 1) if fmt == "GIF"
                                     else pnm_file("P5", grey))
            png_named[fmt] += 1
        elif k == 0:
            shutil.copy(p, d / p.name)
        elif k == 3:
            shutil.copy(jpegs[i % len(jpegs)], d / f"{p.stem}.jpg")
        else:
            grey = decode_png(p.read_bytes())[..., 0]
            if k == 1:
                data = bmp_grey(grey)
            else:
                layout, data = mixed_tiff(grey, i // 4)
                layouts[layout] = layouts.get(layout, 0) + 1
            (d / f"{p.stem}{'.bmp' if k == 1 else '.tif'}").write_bytes(data)
        kinds[[".png", ".bmp", ".tif", ".jpg"][k]] += 1
    write_s = time.perf_counter() - t0
    paths = ds_mod.list_images(mixed)
    per_kind = {}
    for p in paths:
        t0 = time.perf_counter()
        ds_mod.decode_gray(p)
        t1 = time.perf_counter()
        pre_cli.load_canvas(p, 512)
        t2 = time.perf_counter()
        d, c = per_kind.get(p.suffix, (0.0, 0.0))
        per_kind[p.suffix] = (d + t1 - t0, c + t2 - t1)
    host_s = sum(c for _, c in per_kind.values())
    print("decode: host ms a scan of the mixed tree, decode alone / decode + letterbox "
          "(resize past 512 px): " + "; ".join(
              f"{k} {1e3 * d / kinds[k]:.2f} / {1e3 * c / kinds[k]:.2f}"
              for k, (d, c) in sorted(per_kind.items())) + f" [{card}]", flush=True)
    t0 = time.perf_counter()
    run_cli(pre_cli.main, ["--input_dir", str(mixed), "--output_dir", str(Path(work) / "mixed_clean")])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    rep = json.loads((Path(work) / "mixed_clean" / "preprocess_report.json").read_text())
    n = len(rep["processed"]) + len(rep["invalid"])
    if n != 1320 or len(paths) != 1320:
        raise AssertionError(f"cli.preprocess on the mixed tree: {n} of {len(paths)} scans")
    t0 = time.perf_counter()
    ds = ds_mod.SignatureDataset(mixed, 64, use_cache=False)
    ds_s = time.perf_counter() - t0
    if ds.images.shape != (1320, 64, 64, 1) or not np.isfinite(ds.images).all():
        raise AssertionError(f"SignatureDataset on the mixed tree: {ds.images.shape}")
    # SOF11 JPEGs (PIL refuses them) beside the scans: zero images in the
    # SignatureDataset, and cli.preprocess stops on one with ValueError, as
    # the JAX package's PIL path does.
    stripe = sof11((FIXTURES / "lossless_stripe.jpg").read_bytes())
    sof11_paths = [mixed / f"w{k:02d}" / f"w{k:02d}_sof11.jpg" for k in range(0, 55, 11)]
    for p in sof11_paths:
        p.write_bytes(stripe)
    with_sof11 = ds_mod.SignatureDataset(mixed, 64, use_cache=False)
    at = {p.name: i for i, p in enumerate(with_sof11.paths)}
    zero = [not with_sof11.images[at[p.name]].any() for p in sof11_paths]
    kept = np.array_equal(np.delete(with_sof11.images, [at[p.name] for p in sof11_paths], axis=0),
                          ds.images)
    if with_sof11.images.shape[0] != 1320 + len(sof11_paths) or not all(zero) or not kept:
        raise AssertionError("SOF11 JPEGs in the mixed tree: not zero images beside the same scans")
    one = Path(work) / "sof11_tree" / "w00"
    one.mkdir(parents=True, exist_ok=True)
    shutil.copy(sof11_paths[0], one / "w00_sof11.jpg")
    shutil.copy(jpegs[0], one / "w00_scan.jpg")
    try:
        run_cli(pre_cli.main, ["--input_dir", str(one.parent), "--output_dir",
                               str(Path(work) / "sof11_clean")])
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("cli.preprocess read a SOF11 JPEG, which PIL refuses")
    for p in sof11_paths:
        p.unlink()
    webp = webp_tree_step(card, work)
    raster = raster_tree_step(card, work)
    # C.21: a file of each format PIL opens and the port does not read, named
    # .png beside a scan: the build stops naming the format and A.6. The
    # formats of A.6.33-A.6.55 read, bit-equal to the greys they were built
    # from (PIL's, tests/test_torch_port_pil_formats.py).
    stops, c21 = {}, c21_files()
    for fmt in C21_READ:
        want = c21_greys()[fmt]
        path = Path(work) / "c21_read" / f"{fmt}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(c21.pop(fmt))
        got = ds_mod.decode_gray(path)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"the C.21 {fmt} file: not the grey it was built from")
    for fmt, data in c21.items():
        tree = Path(work) / "c21_tree" / fmt
        tree.mkdir(parents=True, exist_ok=True)
        shutil.copy(jpegs[0], tree / "w00_scan.jpg")
        (tree / "w00_c21.png").write_bytes(data)
        try:
            ds_mod.SignatureDataset(tree, 64, use_cache=False)
        except NotImplementedError as e:
            stops[fmt] = str(e)
        if fmt not in stops or fmt not in stops[fmt] or "ROADMAP A.6" not in stops[fmt]:
            raise AssertionError(f"a {fmt} file named .png: the build did not stop naming {fmt} and A.6")
    print(f"decode: C.21: {', '.join(C21_READ)} (A.6.33-A.6.55) files named .png read bit-equal "
          f"to the greys they were built from; {len(stops)} trees, each a scan and one file of a "
          f"format PIL opens and the port does not read, named .png ({', '.join(stops)}): each build "
          f"stopped with NotImplementedError naming its format and ROADMAP A.6 (ICNS: "
          f"{stops['ICNS']!r})", flush=True)
    print(f"decode: mixed tree of 1320 scans (55 writers x 24; {json.dumps(kinds)}, of the .png "
          f"{json.dumps(png_named)} other formats under a .png name; the TIFFs "
          f"{json.dumps(layouts)}) written in "
          f"{write_s:.2f} s; cli.preprocess {pre_s:.2f} s ({1320 / pre_s:.1f} images/s), "
          f"{len(rep['processed'])} written, {len(rep['invalid'])} invalid; the host decode + "
          f"letterbox of every scan alone {host_s:.2f} s ({host_s / pre_s:.4f} of the CLI's "
          f"wall time); SignatureDataset (threaded decode + resize to 64) {ds_s:.2f} s "
          f"({1320 / ds_s:.1f} images/s); {len(sof11_paths)} SOF11 JPEGs added: zero images in a "
          f"SignatureDataset of {with_sof11.images.shape[0]}, the other scans' arrays unchanged; "
          f"cli.preprocess on a tree holding one: ValueError ({refusal}) [{card}]", flush=True)
    png = png_tree_phase(card, work)
    return {"build_s": build_s, "images_per_s": rates, "preprocess_s": pre_s, "webp_tree": webp,
            "raster_tree": raster,
            "preprocess_host_decode_s": host_s, "dataset_s": ds_s,
            "host_ms_per_scan": {k: [1e3 * d / kinds[k], 1e3 * c / kinds[k]]
                                 for k, (d, c) in per_kind.items()},
            "pil_png_tree": png}


# What cli.preprocess writes and refuses of phase 11's 1320 scans on the CPU,
# from their PNGs and from their WebP files alike (scripts/webp_tree_cpu.py).
WEBP_TREE_CPU_COUNTS = (1171, 149)


def webp_tree_step(card: str, work: str, run=None) -> dict:
    """Phase 12's WebP tree (A.6.30): phase 11's 1320 scans, each written
    here as a lossless WebP file of its grey (``vp8l_grey_file``; no PIL on
    this host) under a .jpg or a .png name in turns. ``cli.preprocess``
    must write and refuse the scans phase 11's run on their PNGs did, as
    many as on the CPU (``WEBP_TREE_CPU_COUNTS``), and a
    ``SignatureDataset`` of the tree must equal one of the PNGs. ``run``
    runs a CLI (``run_cli``; ``scripts/webp_tree_cpu.py`` adds ``--device
    cpu``)."""
    import concurrent.futures
    import numpy as np
    import torch
    from siggan_tpu_torch.cli import preprocess as pre_cli
    from siggan_tpu_torch.data import dataset as ds_mod
    from siggan_tpu_torch.infer.export import decode_png
    run = run or run_cli
    raw, tree = Path(work) / "scans", Path(work) / "webp_scans"
    pngs = sorted(raw.rglob("*.png"))

    def write(item):
        i, p = item
        (tree / p.parent.name).mkdir(parents=True, exist_ok=True)
        data = vp8l_grey_file(decode_png(p.read_bytes())[..., 0])
        (tree / p.parent.name / f"{p.stem}{'.jpg' if i % 2 else '.png'}").write_bytes(data)
        return len(data)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        sizes = list(pool.map(write, enumerate(pngs)))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(pre_cli.main, ["--input_dir", str(tree), "--output_dir", str(Path(work) / "webp_clean")])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    rep = json.loads((Path(work) / "webp_clean" / "preprocess_report.json").read_text())
    want = json.loads((Path(work) / "clean" / "preprocess_report.json").read_text())

    def stems(names):
        return sorted(Path(n).stem for n in names)
    if (len(pngs) != 1320 or any(stems(rep[k]) != stems(want[k]) for k in ("processed", "invalid"))
            or (len(rep["processed"]), len(rep["invalid"])) != WEBP_TREE_CPU_COUNTS):
        raise AssertionError(f"cli.preprocess on the WebP tree: {len(rep['processed'])} written, "
                             f"{len(rep['invalid'])} invalid; on the same scans' PNGs "
                             f"{len(want['processed'])} and {len(want['invalid'])}; on the CPU "
                             f"{WEBP_TREE_CPU_COUNTS}")
    t0 = time.perf_counter()
    ds = ds_mod.SignatureDataset(tree, 64, use_cache=False)
    ds_s = time.perf_counter() - t0
    ref = ds_mod.SignatureDataset(raw, 64, use_cache=False)
    if [p.stem for p in ds.paths] != [p.stem for p in ref.paths] or not np.array_equal(ds.images, ref.images):
        raise AssertionError("SignatureDataset of the WebP tree: not the arrays of the same scans' PNGs")
    print(f"decode: WebP tree of 1320 scans (phase 11's, lossless grey VP8L under .jpg and .png "
          f"names in turns; {sum(sizes) / len(sizes) / 1e3:.1f} KB a file) written in {write_s:.2f} s; "
          f"cli.preprocess {pre_s:.2f} s ({1320 / pre_s:.1f} images/s), {len(rep['processed'])} "
          f"written, {len(rep['invalid'])} invalid, the scans phase 11 wrote and refused from "
          f"their PNGs and as many as on the CPU; SignatureDataset {ds_s:.2f} s ({1320 / ds_s:.1f} images/s), its arrays the "
          f"PNGs' [{card}]", flush=True)
    return {"write_s": write_s, "preprocess_s": pre_s, "dataset_s": ds_s,
            "written": len(rep["processed"]), "invalid": len(rep["invalid"])}


def _write_raster_scan(job) -> int:
    """A worker of ``raster_tree_step``: (kind, grey, the scan's PNG, path)
    -> the file's size, written."""
    kind, grey, png, path = job
    data = raster_scan(kind, grey, png)[0]
    Path(path).write_bytes(data)
    return len(data)


# What cli.preprocess writes and refuses of phase 11's 1320 scans written in
# the formats of A.6.33-A.6.55 (raster_tree_step), on the CPU
# (scripts/raster_tree_cpu.py).
RASTER_TREE_CPU_COUNTS = (1170, 150)


def raster_tree_step(card: str, work: str, run=None) -> dict:
    """Phase 12's raster tree (A.6.33-A.6.55): phase 11's 1320 scans, each
    written here without PIL in the formats of ``RASTER_TREE_KINDS`` in
    turns, under .png and .bmp names in turns (the datasets list only the
    JAX package's six extensions, so not .tga, .pcx, ...). ``cli.preprocess``
    must write and refuse as many scans as on the CPU
    (``RASTER_TREE_CPU_COUNTS``) and the ones phase 11 did from the lossless
    kinds' PNGs; a ``SignatureDataset`` of the tree must equal the greys
    the files were built from (``raster_grey``: the PNGs', but the 1 bit of
    MSP and XBM, the XV thumbnail's palette and the block encoders' greys
    of DDS and FTEX). ``run`` runs a
    CLI (``run_cli``; ``scripts/raster_tree_cpu.py`` adds ``--device cpu``)."""
    import numpy as np
    import torch
    from siggan_tpu_torch.cli import preprocess as pre_cli
    from siggan_tpu_torch.data import dataset as ds_mod
    from siggan_tpu_torch.infer.export import decode_png
    run = run or run_cli
    raw, tree = Path(work) / "scans", Path(work) / "raster_scans"
    pngs = sorted(raw.rglob("*.png"))
    # The encoders are numpy and Python loops: 8 worker processes write the
    # files (spawned: this process may hold the card).
    import concurrent.futures
    import multiprocessing
    t0 = time.perf_counter()
    kinds, expected, jobs = {}, {}, []
    for i, p in enumerate(pngs):
        kind = RASTER_TREE_KINDS[i % len(RASTER_TREE_KINDS)]
        png = p.read_bytes()
        grey = decode_png(png)[..., 0]
        (tree / p.parent.name).mkdir(parents=True, exist_ok=True)
        name = tree / p.parent.name / f"{p.stem}{'.bmp' if (i // len(RASTER_TREE_KINDS)) % 2 else '.png'}"
        jobs.append((kind, grey, png, str(name)))
        kinds[kind] = kinds.get(kind, 0) + 1
        expected[p.stem] = (kind, raster_grey(kind, grey))
    with concurrent.futures.ProcessPoolExecutor(
            min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn")) as pool:
        sizes = list(pool.map(_write_raster_scan, jobs, chunksize=16))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(pre_cli.main, ["--input_dir", str(tree), "--output_dir", str(Path(work) / "raster_clean")])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    rep = json.loads((Path(work) / "raster_clean" / "preprocess_report.json").read_text())
    counts = (len(rep["processed"]), len(rep["invalid"]))
    want = json.loads((Path(work) / "clean" / "preprocess_report.json").read_text())

    def lossless(names):
        return sorted(Path(n).stem for n in names if expected[Path(n).stem][0] not in RASTER_TREE_LOSSY)
    if (len(pngs) != 1320 or any(lossless(rep[k]) != lossless(want[k]) for k in ("processed", "invalid"))
            or (RASTER_TREE_CPU_COUNTS is not None and counts != RASTER_TREE_CPU_COUNTS)):
        raise AssertionError(f"cli.preprocess on the raster tree: {counts[0]} written, {counts[1]} "
                             f"invalid; on the CPU {RASTER_TREE_CPU_COUNTS}; the lossless kinds' scans "
                             "not the ones phase 11 wrote and refused from their PNGs")
    t0 = time.perf_counter()
    ds = ds_mod.SignatureDataset(tree, 64, use_cache=False)
    ds_s = time.perf_counter() - t0
    ref = np.stack([ds_mod._scaled(expected[p.stem][1], 64) for p in ds.paths])
    if len(ds.paths) != 1320 or not np.array_equal(ds.images, ref):
        raise AssertionError("SignatureDataset of the raster tree: not the arrays of the greys written")
    print(f"decode: raster tree of 1320 scans (phase 11's, {json.dumps(kinds)}, under .png and .bmp "
          f"names in turns; {sum(sizes) / len(sizes) / 1e3:.1f} KB a file) written in {write_s:.2f} s; "
          f"cli.preprocess {pre_s:.2f} s ({1320 / pre_s:.1f} images/s), {counts[0]} written, "
          f"{counts[1]} invalid (on the CPU {RASTER_TREE_CPU_COUNTS}), the lossless kinds' scans the "
          f"ones phase 11 wrote and refused from their PNGs; SignatureDataset {ds_s:.2f} s "
          f"({1320 / ds_s:.1f} images/s), its arrays the greys written [{card}]", flush=True)
    return {"write_s": write_s, "preprocess_s": pre_s, "dataset_s": ds_s, "written": counts[0],
            "invalid": counts[1], "kinds": kinds}


def mixed_tiff(grey, turn: int):
    """(layout, bytes) of phase 12's mixed tree's TIFF scan ``turn``: plain
    grey, then a layout of A.6.7-A.6.12 in turns (BigTIFF in LZW strips,
    planar RGB in Deflate with predictor 2, YCbCr 2 x 2 in Deflate, grey
    with FillOrder 2 in Deflate, a palette with alpha), of uint8 (H, W)
    ``grey``, then LZMA grey in strips of 32 rows, the ZSTD and the
    damaged Group 4 page as they are, then the scan's ink (grey below 128)
    in Group 4: in 256 x 256 tiles, with a 1-bit palette in such tiles, and
    with the uncompressed-mode bit set; then old-style LZW grey in strips
    of 32 rows; then JPEG-in-TIFF of photometric 0 (the grey inverted), of
    12 bits (the grey, the ink from 3000 up) and planar RGB (the grey
    tinted), the ink as CCITT RLE-W, the grey >> 4 as ThunderScan and the
    grey as LZMA with the ARM64 BCJ filter, in strips of 32 rows."""
    import numpy as np
    g = grey.astype(np.int64)
    layout = ("plain", "bigtiff", "planar", "ycbcr", "fill2", "pa", "lzma", "zstd",
              "damaged_g4", "g4_tiles", "g4_palette", "g4_uncompressed", "old_lzw",
              "jpeg_white_is_zero", "jpeg_12bit", "planar_jpeg", "rlew", "thunderscan",
              "lzma_arm64")[turn % 19]
    if layout == "plain":
        return layout, tiff_grey(grey)
    h, w = g.shape
    rows = range(0, h, 32)
    if layout in ("jpeg_white_is_zero", "jpeg_12bit"):
        twelve = layout == "jpeg_12bit"
        src = g // 2 + (g < 60) * 3000 if twelve else 255 - g
        return layout, jpeg_in_tiff([jpeg_sof1(src[y:y + 32], np.full(64, 4) if twelve else Q90,
                                               precision=12 if twelve else 8) for y in rows],
                                    w, h, 12 if twelve else 8, 1 if twelve else 0, 1,
                                    rows_per_strip=32)
    if layout == "planar_jpeg":
        planes = [g, g * 31 // 32, np.minimum(g + 6, 255)]
        return layout, jpeg_in_tiff([jpeg_sof1(p[y:y + 32], Q90, precision=8) for p in planes
                                     for y in rows], w, h, 8, 2, 3, planar=2, rows_per_strip=32)
    if layout in ("rlew", "thunderscan", "lzma_arm64"):
        blobs = ([rlew_strip(grey[y:y + 32] < 128) for y in rows] if layout == "rlew" else
                 [thunder_codes(g[y:y + 32] >> 4) for y in rows] if layout == "thunderscan" else
                 [lzma_bcj(grey[y:y + 32].astype(np.uint8).tobytes(), 0x0A) for y in rows])
        bits, compression, photometric = {"rlew": (1, 32771, 0), "thunderscan": (4, 32809, 1),
                                          "lzma_arm64": (8, 34925, 1)}[layout]
        return layout, tiff_pack(w, h, blobs, [
            (258, 3, [bits]), (259, 3, [compression]), (262, 3, [photometric]), (277, 3, [1]),
            (273, 4, lambda o: o), (278, 4, [32]), (279, 4, [len(b) for b in blobs])])
    if layout == "lzma":
        return layout, tiff_layout(g[..., None], 8, 1, compression=34925, rows_per_strip=32)
    if layout == "zstd":
        return layout, (FIXTURES / "zstd_g4_page.tif").read_bytes()
    if layout == "damaged_g4":
        return layout, damaged_g4_page()
    if layout in ("g4_tiles", "g4_palette", "g4_uncompressed"):
        ink = grey < 128
        if layout == "g4_uncompressed":
            return layout, tiff_g4(ink, tags=[(293, 4, [2])])
        if layout == "g4_palette":
            return layout, tiff_g4(ink, tile=(256, 256), photometric=3, tags=[(320, 3, PAPER_INK)])
        return layout, tiff_g4(ink, tile=(256, 256))
    if layout == "old_lzw":
        return layout, tiff_layout(g[..., None], 8, 1, compression=-5, rows_per_strip=32)
    if layout == "bigtiff":
        return layout, tiff_layout(g[..., None], 8, 1, compression=5, big=True, rows_per_strip=32)
    if layout == "planar":
        rgb = np.dstack([g, g * 31 // 32, np.minimum(g + 6, 255)])
        return layout, tiff_layout(rgb, 8, 2, compression=8, planar=2, predictor=2,
                                   rows_per_strip=32)
    if layout == "ycbcr":
        h, w = g.shape
        pad = np.pad(g, ((0, h % 2), (0, w % 2)), mode="edge")
        block = pad.reshape(pad.shape[0] // 2, 2, pad.shape[1] // 2, 2).sum(axis=(1, 3)) // 4
        return layout, tiff_ycbcr(g, 128 + (block - 128) // 8, 128 - (block - 128) // 16, (2, 2),
                                  rows_per_strip=32)
    if layout == "fill2":
        return layout, tiff_layout(g[..., None], 8, 1, compression=8, fill=2, rows_per_strip=32)
    ramp = np.arange(256)
    palette = list(ramp * 257) + list(ramp * 250 // 255 * 257) + list(np.minimum(ramp + 9, 255) * 257)
    return layout, tiff_layout(np.dstack([g, 255 - g // 2]), 8, 3, compression=8,
                               rows_per_strip=32, tags=[(338, 3, [2]), (320, 3, palette)])


def pool_label(ds_mod, paths, threads) -> str:
    """'N threads', or for ``threads`` None the default pool's size."""
    if threads is None:
        from siggan_tpu_torch.data.native import loader as native
        grays, status, _, png_at = native.decode_files(paths[:8])
        n = ds_mod.pool_threads(paths[:8], grays, status, png_at, min(8, os.cpu_count() or 1))
        return f"default ({n} thread{'s' if n > 1 else ''})"
    return f"{threads} thread{'s' if threads > 1 else ''}"


def png_tree_phase(card: str, work: str):
    """Phase 12, PNG scans saved by PIL: the committed 1200 x 500 page (PIL's
    default adaptive filters) bit-equal to PIL's committed grey; 1320 copies
    of it in CEDAR's shape (55 writers x 24) through the dataset's threaded
    path, ``decode_images`` (zlib, the C++ row unfilter and the resize to 64
    on a pool of Python threads), at 1 and 8 threads and its default
    (images/s), and through ``cli.preprocess``."""
    import shutil
    import numpy as np
    import torch
    from siggan_tpu_torch.cli import preprocess as pre_cli
    from siggan_tpu_torch.data import dataset as ds_mod

    page = FIXTURES / "png_page" / "page.png"
    with np.load(FIXTURES / "png_page" / "page_grey.npz") as f:
        want = f["grey"]
    t0 = time.perf_counter()
    got = ds_mod.decode_gray(page)
    one_ms = (time.perf_counter() - t0) * 1e3
    if got.shape != (500, 1200) or not np.array_equal(got, want):
        raise AssertionError("the PIL-saved PNG page is not bit-equal to PIL's grey")
    tree = Path(work) / "pil_png_scans"
    for w in range(55):
        d = tree / f"writer_{w:03d}"
        d.mkdir(parents=True)
        for i in range(24):
            shutil.copy(page, d / f"w{w:03d}_{i:02d}.png")
    paths = ds_mod.list_images(tree)
    want64 = ds_mod._scaled(want, 64)
    rates = {}
    for threads, n in ((1, 132), (8, 1320), (None, 660)):
        ds_mod.decode_images(paths[:16], 64, n_threads=threads)
        t0 = time.perf_counter()
        out = ds_mod.decode_images(paths[:n], 64, n_threads=threads)
        rates[pool_label(ds_mod, paths, threads)] = n / (time.perf_counter() - t0)
        if out.shape != (n, 64, 64, 1) or not (out == want64).all():
            raise AssertionError(f"decode_images on {threads} threads: not PIL's grey resized")
    t0 = time.perf_counter()
    run_cli(pre_cli.main, ["--input_dir", str(tree), "--output_dir",
                           str(Path(work) / "pil_png_clean")])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    rep = json.loads((Path(work) / "pil_png_clean" / "preprocess_report.json").read_text())
    if len(rep["processed"]) + len(rep["invalid"]) != 1320 or len(paths) != 1320:
        raise AssertionError("cli.preprocess on the PIL-saved PNG tree: "
                             f"{len(rep['processed'])} + {len(rep['invalid'])} of {len(paths)}")
    print(f"decode: PIL-saved PNG page 1200x500 ({page.stat().st_size} bytes) bit-equal to "
          f"PIL's grey, first decode {one_ms:.2f} ms; 1320 copies (55 writers x 24) through "
          f"decode_images (decode + resize to 64), images/s: "
          + "; ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + " (1 thread on 132 of them, the default on 660); cli.preprocess "
          f"{pre_s:.2f} s ({1320 / pre_s:.1f} images/s), {len(rep['processed'])} written "
          f"[{card}]", flush=True)
    return {"first_decode_ms": one_ms, "decode_images_per_s": rates, "preprocess_s": pre_s}


def windows_in_turns(cfgs, order, images, state, k):
    """Graphed K-step windows of each route's step (``cfgs``: route ->
    TrainConfig; one multi-step and one copy of ``state`` a route) in the
    turns of ``order``: per route a list of (host ms/step, device busy
    ms/step or None, device operations per step), each turn's first window
    a warm-up (the route's first one also its capture)."""
    import torch
    from siggan_tpu_torch.train import train_step as ts
    multis = {r: ts.make_resident_multi_step(c, len(images), k)[0] for r, c in cfgs.items()}
    states = {r: copy.deepcopy(state) for r in cfgs}
    rows = {r: [] for r in cfgs}
    for route in order:
        def window(route=route):
            states[route], m = multis[route](states[route], images)
            return m
        window()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        w = (time.perf_counter() - t0) * 1e3 / k
        _, busy, ops = device_time(window, calls=1)
        rows[route].append((w, None if busy is None else busy / k, ops / k))
    return rows


def print_turns(tag, k, rows, card):
    for route, rs in rows.items():
        print(f"{tag}: graphed {k}-step windows, {route} step: " + "; ".join(
            f"wall {w:.3f} ms/step, device busy {fmt_ms(b)}/step, idle share "
            f"{'not measured' if b is None else f'{1 - b / w:.4f}'}, {o:.0f} device "
            f"operations per step" for w, b, o in rs) + f" [{card}]", flush=True)


def shared_fakes_phase(card: str, work: str):
    """Phase 13a: ``cli.train --share_fakes`` at full width on phase 7's
    PNGs; graphed against eager; the default and the shared-fake step's
    graphed windows in turns. Returns the main path's launches."""
    import numpy as np
    import torch
    from siggan_tpu_torch.ckpt.manager import CheckpointManager
    from siggan_tpu_torch.cli import train as train_cli
    from siggan_tpu_torch.core.config import TrainConfig
    from siggan_tpu_torch.data.dataset import SignatureDataset
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    from siggan_tpu_torch.train import train_step as ts

    tag, data, run = "train share_fakes", f"{work}/data", f"{work}/run_share"
    for counter in (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES):
        counter.reset()
    t0 = time.perf_counter()
    out = run_cli(train_cli.main, ["--data_dir", data, "--epochs", "2", "--checkpoint_interval",
                                   "1", "--run_dir", run, "--device", "cuda", "--share_fakes"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pack_tail": pt.FWD_LAUNCHES.count,
                "pack_tail_backward": pt.BWD_LAUNCHES.count, "train_tail": tt.LAUNCHES.count}
    dispatch = re.search(r"Dispatch: (\d+) steps per call", out)
    if dispatch is None:
        raise AssertionError(f"{tag}: the CLI did not train on the graphed dispatch")
    k = int(dispatch.group(1))
    cfg = TrainConfig.from_json(open(f"{run}/checkpoints/config.json").read())
    steps = 2 * (2048 // cfg.batch_size)
    if not cfg.share_fakes or cfg.batch_size != 64 or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{tag}: not the expected configuration: {cfg.to_json()}")
    if launches != {"pack_tail": steps, "pack_tail_backward": steps, "train_tail": 0}:
        raise AssertionError(f"{tag}: launches {launches} for {steps} steps")
    metrics = json.loads(sorted(Path(f"{run}/logs").glob("*.json"))[-1].read_text())["metrics"]
    for m in metrics:
        if not np.all(np.isfinite([m[key] for key in ("d_loss", "g_loss", "d_on_g_mean")])):
            raise AssertionError(f"{tag}: non-finite metrics {m}")
    print(f"{tag}: CLI 2 epochs in {wall:.1f} s, K = {k}; launches per step B1 "
          f"{launches['pack_tail'] / steps:g}, B1' {launches['pack_tail_backward'] / steps:g}, "
          f"B2 {launches['train_tail'] / steps:g}; " + "; ".join(
              f"epoch {m['epoch']}: d_loss {m['d_loss']:.4f} g_loss {m['g_loss']:.4f} "
              f"{m['ms_per_step']:.3f} ms/step" for m in metrics) + f" [{card}]", flush=True)

    state, _ = CheckpointManager(f"{run}/checkpoints", cfg).restore("latest", "cuda")
    images = torch.from_numpy(SignatureDataset(data, 64).images).cuda()
    agreement, _ = graphed_vs_eager(tag, cfg, 2048, images, state, k)

    # The default and the shared-fake step, graphed windows in turns on copies.
    rows = windows_in_turns({"default": cfg.replace(share_fakes=False), "share_fakes": cfg},
                            ("default", "share_fakes", "share_fakes", "default"), images,
                            state, k)
    eager_fn, _ = ts.make_resident_train_step(cfg, 2048)
    estate = copy.deepcopy(state)

    def ten():
        nonlocal estate
        for _ in range(10):
            estate, m = eager_fn(estate, images)
        return m
    ten()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ten()
    torch.cuda.synchronize()
    ewall = (time.perf_counter() - t0) * 1e3 / 10
    _, ebusy, eops = device_time(ten, calls=1)
    print_turns(tag, k, rows, card)
    print(f"{tag}: eager, 10 profiled steps: wall {ewall:.3f} ms/step, device busy "
          f"{fmt_ms(None if ebusy is None else ebusy / 10)}/step, {eops / 10:.0f} device "
          f"operations per step [{card}]", flush=True)
    print(f"{tag}: graphed vs eager: {json.dumps(agreement)}", flush=True)
    return launches


FUSE_STEPS = 4
FUSE_NOTE = ("the fused step against the sequential step, 4 eager steps of each from one "
             "seeded state on the same draws and phase 7's first 64 images, the sequential "
             "D step's G tail on the module path (the fused step's route: B2 takes one "
             "group over its batch, and its own bar against the module path is phase 6's; "
             "in bf16 the two tails round apart by that bar, which Adam's moments carry). "
             "f32 (LRs 1e-6, "
             "TF32 off): G and D parameters, G's BN running statistics and the metrics "
             "allclose rtol 2e-5 atol 2e-5, the JAX package's bar at n_critic 1 "
             "(tests/test_train_step.py), with no fallback; the other parts (Adam, u's) "
             "within twice the spread of the sequential step's own runs (a repeat, 3 "
             "permutations of the batch rows and of every draw's rows: the same steps "
             "summed in other orders, and its D step's G tail on B2). bf16 (TrainConfig() defaults): parameters within "
             "Adam's bound over the steps, 2 lr x 1.01 x the sum over steps t of "
             "sqrt(sum_i w_i^2 / u_i) (the largest |m_hat| / sqrt(v_hat) at step t for beta "
             "(0.5, 0.999); 1 % for bf16 moments), BN running statistics rtol 1e-2 atol 1e-3 "
             "(B2's bf16 bar), Adam's bf16 moments within 1e-2 of each tensor's largest "
             "entry (the bar tests/test_torch_port_dp_cli.py holds bf16 moments to), each "
             "part else within twice the spread, as phase 16b holds bf16 ranks. In both, "
             "accuracies (counts of logits on each side of 0) within 4 of 64 rows")


def adam_step_bounds(steps: int, b1: float = 0.5, b2: float = 0.999):
    """Per step t, the largest |m_hat| / sqrt(v_hat) any gradients give
    (Cauchy-Schwarz over the bias-corrected weights)."""
    out = []
    for t in range(1, steps + 1):
        w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        out.append(math.sqrt(sum(wi * wi / ui for wi, ui in zip(w, u))))
    return out


def fuse_bar(steps: int):
    """Phase 13c's bar for a tensor of ``part`` whose reference is ``y``
    (FUSE_NOTE); None where only the spread holds it."""
    adam = 2 * 1.01 * sum(adam_step_bounds(steps))

    def bar(part, y, f32, lr):
        if f32:
            strict = ("G parameters", "D parameters", "G BN statistics", "metrics")
            return 2e-5 + 2e-5 * y.abs() if part in strict else None
        if part.endswith("parameters") or part == "G EMA":
            return adam * lr + 0 * y
        if part == "G BN statistics":
            return 1e-3 + 1e-2 * y.abs()
        if part.endswith("Adam"):
            return 1e-2 * y.abs().max() + 0 * y
        return None
    return bar


def fused_vs_sequential(tag, cfg, real, dev):
    """FUSE_STEPS eager steps of the fused and of the sequential step of
    ``cfg`` on the same draws, held at FUSE_NOTE's bar: (max abs diff by
    part, the spread, the share of the bar by part, the worst tensors)."""
    import torch
    from siggan_tpu_torch.models.generator import fused_tail_supported
    from siggan_tpu_torch.train import train_step as ts
    f32 = cfg.compute_dtype == "float32"
    seq_cfg, fused_cfg = cfg.replace(fuse_g_forwards=False), cfg.replace(fuse_g_forwards=True)
    fstate, fmetrics = dp_one_process(fused_cfg, real, dev, steps=FUSE_STEPS)
    b2state, b2metrics = dp_one_process(seq_cfg, real, dev, steps=FUSE_STEPS)
    perms = [None] + [torch.randperm(64, generator=torch.Generator().manual_seed(s)).to(dev)
                      for s in (21, 22, 23)]
    spread = {}
    ts.fused_tail_supported = lambda m: False   # the D step's G tail on the module path
    try:
        state, metrics = dp_one_process(seq_cfg, real, dev, steps=FUSE_STEPS)
        keys = [k for k in metrics if "acc" not in k]
        one = state_groups(state, {k: metrics[k] for k in keys})
        others = [dp_one_process(seq_cfg, real, dev, perm, steps=FUSE_STEPS)
                  for perm in perms] + [(b2state, b2metrics)]
        for o, om in others:
            for part, d in group_diffs(state_groups(o, {k: om[k] for k in keys}), one).items():
                spread[part] = max(spread.get(part, 0.0), d)
    finally:
        ts.fused_tail_supported = fused_tail_supported
    fused = state_groups(fstate, {k: fmetrics[k] for k in keys})
    table = []
    use, bad = dp_within(tag, fused, one, spread, dp_names(state, {k: None for k in keys}),
                         f32, max(cfg.optim.g_lr, cfg.optim.d_lr), table,
                         bar=fuse_bar(FUSE_STEPS))
    if f32:
        bad += [f"{tag}: {part} {name} over the JAX bar ({d:.3e}, {u:.2f} of it)"
                for part, name, _, d, u in table if u is not None and u > 1.0]
    for k in set(metrics) - set(keys):
        d = float((fmetrics[k] - metrics[k]).abs().max())
        if d > 4 / 64:
            bad.append(f"{tag}: {k} differs by {d} (over 4 of 64 rows)")
    if bad:
        raise AssertionError("; ".join(bad))
    worst = sorted(table, key=lambda r: -(r[4] if r[4] is not None else -1))[:5]
    return group_diffs(fused, one), spread, use, worst


def fused_phase(card: str, work: str):
    """Phase 13c: the fused generator forwards (``TrainConfig(fuse_g_forwards=
    True)``, no CLI flag) through GANTrainer at full width on phase 7's
    PNGs; graphed against eager; fused against sequential in f32 and bf16;
    n_critic 2; the default and the fused step's graphed windows in turns.
    Returns the main path's launches."""
    import numpy as np
    import torch
    from siggan_tpu_torch.ckpt.manager import CheckpointManager, load_generator
    from siggan_tpu_torch.core.config import OptimConfig, TrainConfig
    from siggan_tpu_torch.data.dataset import SignatureDataset
    from siggan_tpu_torch.infer.generate import GeneratorSession
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    from siggan_tpu_torch.train import train_step as ts
    from siggan_tpu_torch.train.trainer import GANTrainer

    tag, root = "train fuse_g_forwards", Path(work) / "run_fused"
    dev = torch.device("cuda", 0)
    images = SignatureDataset(f"{work}/data", 64).images
    cfg = TrainConfig(fuse_g_forwards=True, epochs=2, sample_interval=0,
                      checkpoint_interval=1, checkpoint_dir=str(root / "checkpoints"),
                      sample_dir=str(root / "samples"), log_dir=str(root / "logs"))
    counters = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES)
    for counter in counters:
        counter.reset()
    t0 = time.perf_counter()
    trainer = GANTrainer(cfg, images, device=dev)
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pack_tail": pt.FWD_LAUNCHES.count,
                "pack_tail_backward": pt.BWD_LAUNCHES.count, "train_tail": tt.LAUNCHES.count}
    steps, k = trainer.state.step, trainer.scan_steps
    graphed = trainer._step_fn.graphed
    if steps != 64 or graphed.graph is None or k < 2:
        raise AssertionError(f"{tag}: {steps} steps, K {k}, graph {graphed.graph}: not the "
                             f"graphed dispatch over 2 epochs of 32 steps")
    if launches != {"pack_tail": steps, "pack_tail_backward": steps, "train_tail": 0}:
        raise AssertionError(f"{tag}: launches {launches} for {steps} steps")
    metrics = trainer.logger.metrics
    for m in metrics:
        if not np.all(np.isfinite([m[key] for key in ("d_loss", "g_loss", "d_on_g_mean")])):
            raise AssertionError(f"{tag}: non-finite metrics {m}")
    print(f"{tag}: GANTrainer 2 epochs in {wall:.1f} s, K = {k} (capture "
          f"{graphed.capture_s:.3f} s); launches per step B1 "
          f"{launches['pack_tail'] / steps:g}, B1' {launches['pack_tail_backward'] / steps:g}, "
          f"B2 {launches['train_tail'] / steps:g}; " + "; ".join(
              f"epoch {m['epoch']}: d_loss {m['d_loss']:.4f} g_loss {m['g_loss']:.4f} "
              f"{m['ms_per_step']:.3f} ms/step" for m in metrics) + f" [{card}]", flush=True)

    # The saved generator serves on B4.
    model, _ = load_generator(cfg.checkpoint_dir, "cuda")
    gf.LAUNCHES.reset()
    session = GeneratorSession(model, compute_dtype="float32", use_pallas=True, device="cuda")
    imgs = session.sample(64, seed=1)
    if imgs.shape != (64, 64, 64, 1) or not np.isfinite(imgs).all() \
            or np.abs(imgs).max() > 1 or not session.uses_kernel or gf.LAUNCHES.count < 1:
        raise AssertionError(f"{tag}: the trained generator does not serve on B4")
    serve_b4 = gf.LAUNCHES.count

    state, _ = CheckpointManager(cfg.checkpoint_dir, cfg).restore("latest", "cuda")
    images_dev = torch.from_numpy(images).cuda()
    agreement, _ = graphed_vs_eager(tag, cfg, 2048, images_dev, state, k)

    # Fused against sequential on the same draws, f32 and bf16.
    real = images_dev[:64]
    versus = {}
    for name, c in (("f32", cfg.replace(compute_dtype="float32", optim=OptimConfig(
                        moment_dtype="float32", g_lr=1e-6, d_lr=1e-6))),
                    ("bf16", cfg)):
        diffs, spread, use, worst = fused_vs_sequential(f"{tag} vs sequential {name}", c,
                                                        real, dev)
        versus[name] = {"max_abs_diff_by_part": diffs, "sequential_spread_by_part": spread,
                        "share_of_bar_by_part": use, "worst_tensors": worst}
        print(f"{tag} vs sequential, {name}, {FUSE_STEPS} eager steps on the same draws: max "
              f"abs diff by part {json.dumps(diffs)}; the sequential step's spread "
              f"{json.dumps(spread)}; share of the bar by part (null: the spread alone) "
              f"{json.dumps(use)}; worst (part, tensor, max |ref|, diff, share) "
              f"{json.dumps(worst)}", flush=True)

    # n_critic 2: three groups in one forward, still one B1 and one B1' a step.
    c2 = cfg.replace(n_critic=2)
    multi, _ = ts.make_resident_multi_step(c2, 2048, k)
    s2 = copy.deepcopy(state)
    before = [c.count for c in counters]
    t0 = time.perf_counter()
    ms = []
    for _ in range(2):
        s2, m = multi(s2, images_dev)
        ms.append(m)
    torch.cuda.synchronize()
    n2_wall = (time.perf_counter() - t0) * 1e3 / (2 * k)
    n2 = [b - a for a, b in zip(before, (c.count for c in counters))]
    if len(multi.graphed.draws["z"]) != 3 or n2 != [2 * k, 2 * k, 0]:
        raise AssertionError(f"{tag} n_critic 2: {len(multi.graphed.draws['z'])} latent "
                             f"batches a step, launches {n2} in {2 * k} steps")
    if not all(torch.isfinite(v).all() for m in ms for v in m.values()):
        raise AssertionError(f"{tag} n_critic 2: non-finite metrics")
    print(f"{tag} n_critic 2: 2 graphed windows of {k} steps, 3 groups a forward, launches "
          f"per step B1 {n2[0] / (2 * k):g}, B1' {n2[1] / (2 * k):g}, B2 {n2[2] / (2 * k):g}; "
          f"{n2_wall:.3f} ms/step with the capture [{card}]", flush=True)

    # The default and the fused step, graphed windows in turns on copies.
    rows = windows_in_turns({"default": cfg.replace(fuse_g_forwards=False),
                             "fuse_g_forwards": cfg},
                            ("default", "fuse_g_forwards", "fuse_g_forwards", "default"),
                            images_dev, state, k)
    print_turns(tag, k, rows, card)
    print(f"{tag}: graphed vs eager: {json.dumps(agreement)}", flush=True)
    return launches, {"epoch_ms_per_step": [m["ms_per_step"] for m in metrics],
                      "k": k, "capture_s": graphed.capture_s, "serve_b4_launches": serve_b4,
                      "graphed_vs_eager": agreement, "vs_sequential": versus,
                      "vs_sequential_bar": FUSE_NOTE,
                      "n_critic_2": {"launches": n2, "steps": 2 * k, "ms_per_step": n2_wall},
                      "windows_in_turns": rows}


def ablation_phase(card: str, work: str):
    """Phase 13b: ``cli.ablate`` over the 12-run grid at full width."""
    import numpy as np
    from siggan_tpu_torch.cli import ablate as ablate_cli
    from siggan_tpu_torch.ops.kernels import build

    out = Path(work) / "ablation"
    before = build.launch_counts()
    t0 = time.perf_counter()
    log = run_cli(ablate_cli.main, ["--data_dir", f"{work}/data", "--output_dir", str(out),
                                    "--epochs", "1"])
    wall = time.perf_counter() - t0
    if build.launch_counts() != before:
        raise AssertionError("the ablation grid launched a kernel: its G is unpacked")
    rows = json.loads((out / "results.json").read_text())
    names = [r["short_name"] for r in rows]
    want = [f"z{z}_{a}_sn{s}" for z in (50, 100, 200) for a in ("relu", "lrelu") for s in (0, 1)]
    if names != want:
        raise AssertionError(f"ablation runs {names}")
    for name in ("results.csv", "results.md", "plots.json"):
        if not (out / name).exists():
            raise AssertionError(f"ablation: {name} missing")
    if sorted(p.stem for p in (out / "samples").glob("*.png")) != sorted(want):
        raise AssertionError("ablation: sample grids missing")
    ms = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\] (z\S+)\n.*?([0-9.]+) ms/step", log)}
    for r in rows:
        if not np.all(np.isfinite([r["final_d_loss"], r["final_g_loss"], r["fid"]])):
            raise AssertionError(f"ablation run {r['short_name']}: {r}")
        print(f"ablate: {r['short_name']}: d_loss {r['final_d_loss']:.4f} g_loss "
              f"{r['final_g_loss']:.4f} FID {r['fid']:.4f} (random-init InceptionV3, 256 "
              f"samples against 512 reals), {r['wall_time_sec'] / 32 * 1e3:.3f} ms/step "
              f"(32 eager steps), {r['wall_time_sec']:.2f} s training, G "
              f"{r['g_params']} parameters [{card}]", flush=True)
    print(f"ablate: the 12-run grid in {wall:.1f} s (the CLI: dataset, 12 x (init, 32 steps, "
          f"256 samples, FID)) [{card}]", flush=True)
    return {"wall_s": wall, "ms_per_step": ms}


def imported_run_phase(card: str, work: str):
    """Phase 14a: a run trained by the JAX package and imported with
    ``scripts/import_jax_run.py`` (the committed ``tests/data/torch_port/
    jax_run``: 64 px, base 32, EMA on; its generators, fixed noise and
    state, and JAX's eval images of 16 fixed latents). Serve it through B4
    against JAX's images; then resume it with ``cli.train --resume`` on
    phase 7's PNGs for one epoch of the run's 48 steps. The committed run
    holds no D and no Adam states (D keeps its 2.76 M parameters at every
    generator width, too many for a fixture), so the epoch is completed with
    the port's initial D and zero moments at the run's step count, written
    by ``ckpt/manager.py::write_epoch``, the writer the script uses."""
    import shutil
    import numpy as np
    import torch
    from siggan_tpu_torch import bridge
    from siggan_tpu_torch.ckpt import manager as ckpt
    from siggan_tpu_torch.cli import train as train_cli
    from siggan_tpu_torch.core.state import create_train_state
    from siggan_tpu_torch.infer.generate import load_session
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    from siggan_tpu_torch.ops.kernels import upsample as up

    fixture = FIXTURES / "jax_run"
    with np.load(fixture / "jax_eval.npz") as f:
        z, want = f["z"], f["images"]
    session = load_session(str(fixture), device="cuda")
    if not session.uses_kernel:
        raise AssertionError("the imported run is not served through the generator kernel")
    gf.LAUNCHES.reset()
    up.LAUNCHES.reset()
    t0 = time.perf_counter()
    got = session._fwd(torch.from_numpy(z).cuda()).cpu().numpy()
    serve_ms = (time.perf_counter() - t0) * 1e3
    serve_launches = {"generator_forward": gf.LAUNCHES.count,
                      "upsample_block": up.LAUNCHES.count}
    if serve_launches != {"generator_forward": 1, "upsample_block": 3}:
        raise AssertionError(f"imported run served with launches {serve_launches}")
    err = close("imported JAX run through B4 vs JAX's eval images", got, want, 1e-3, 1e-4)
    print(f"imported run: {fixture.relative_to(FIXTURES.parents[2])} served through B4 "
          f"({serve_launches}), 16 images in {serve_ms:.2f} ms, max abs diff against the JAX "
          f"package's images {err:.3e} (rtol 1e-3, atol 1e-4) [{card}]", flush=True)

    run = Path(work) / "imported_run"
    shutil.copytree(fixture, run)
    ep = run / "epoch_0001"
    meta = json.loads((ep / "state.json").read_text())
    cfg = ckpt.load_config(run)
    state = create_train_state(cfg, "cuda")
    with np.load(ep / "generator.npz") as f:
        g = bridge.unflatten(dict(f))
    with np.load(ep / "generator_ema.npz") as f:
        g_ema = bridge.unflatten(dict(f))
    noise = np.load(ep / "fixed_noise.npy")

    def adam(opt, model):
        return {**bridge.opt_to_jax(opt, model), "count": np.int32(meta["step"]), "lr": 0.0}
    ckpt.write_epoch(ep, (run / "config.json").read_text(), epoch=meta["epoch"],
                     step=meta["step"], best_g_loss=meta["best_g_loss"], g=g, g_ema=g_ema,
                     d=bridge.d_to_jax(state.d), g_opt=adam(state.g_opt, state.g),
                     d_opt=adam(state.d_opt, state.d), fixed_noise=noise)
    before = {k: v.copy() for k, v in np.load(ep / "generator.npz").items()}
    for c in (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES):
        c.reset()
    t0 = time.perf_counter()
    # The run's 48 steps an epoch (its step counter keys the epochs), at
    # batch 32 on 1536 of phase 7's PNGs.
    out = run_cli(train_cli.main, [
        "--data_dir", str(Path(work) / "data"), "--checkpoint_dir", str(run),
        "--sample_dir", str(Path(work) / "imported_samples"),
        "--log_dir", str(Path(work) / "imported_logs"), "--resume", "--epochs", "3",
        "--batch_size", "32", "--max_images", "1536",
        "--ema_decay", str(cfg.ema_decay), "--seed", str(cfg.seed),
        "--checkpoint_interval", "1", "--device", "cuda"])
    resume_s = time.perf_counter() - t0
    launches = {"pack_tail": pt.FWD_LAUNCHES.count,
                "pack_tail_backward": pt.BWD_LAUNCHES.count, "train_tail": tt.LAUNCHES.count}
    if f"Resumed from epoch 1 (step {meta['step']})" not in out:
        raise AssertionError("the imported run did not resume at epoch 1")
    idx = json.loads((run / "index.json").read_text())
    new = json.loads((run / "epoch_0002" / "state.json").read_text())
    metrics = json.loads(next((Path(work) / "imported_logs").glob("*.json")).read_text())["metrics"]
    losses = [(m["d_loss"], m["g_loss"]) for m in metrics]
    after = np.load(run / "epoch_0002" / "generator.npz")
    moved = sum(not np.array_equal(before[k], after[k]) for k in before)
    if (idx["latest"] != 2 or new["step"] != meta["step"] + 48 or len(losses) != 1
            or not np.isfinite(losses).all() or moved < len(before) // 2
            or not np.array_equal(np.load(run / "epoch_0002" / "fixed_noise.npy"), noise)
            or launches != {"pack_tail": 96, "pack_tail_backward": 48, "train_tail": 48}):
        raise AssertionError(f"imported run's resume: index {idx}, state {new}, losses "
                             f"{losses}, {moved} of {len(before)} G arrays moved, launches "
                             f"{launches}")
    print(f"imported run: cli.train --resume at base_features {cfg.model.base_features} "
          f"trained epoch 2 (steps {meta['step']} -> {new['step']}) in {resume_s:.2f} s, "
          f"d_loss {losses[0][0]:.4f} g_loss {losses[0][1]:.4f}, {moved} of {len(before)} G "
          f"arrays moved, fixed noise kept, launches {launches} [{card}]", flush=True)
    return {"serve": serve_launches, "train": launches, "max_abs_err": err,
            "serve_ms": serve_ms, "resume_s": resume_s}


def panel_phase(card: str, work: str, b4_kernels, b4_ops: float):
    """Phase 14b: the port's control panel on the card (``serve/app.py``,
    what ``cli.app`` serves, on port 0), over a work directory with phase
    7's full-width run under ``runs/`` (its sidecars set ``use_pallas``, so
    generation runs B4) and phase 14a's imported run under
    ``checkpoints/``; every endpoint driven over HTTP, a training
    subprocess at ``TrainConfig()`` defaults run to its end. ``b4_kernels``,
    ``b4_ops``: B4's device kernels and operations a call, as phase 1's
    profile read them."""
    import shutil
    import numpy as np
    from siggan_tpu_torch.infer.export import decode_png
    from siggan_tpu_torch.ops.kernels import generator_fwd as gf
    from siggan_tpu_torch.ops.kernels import upsample as up
    from siggan_tpu_torch.serve.app import serve

    root = Path(work) / "panel"
    shutil.copytree(Path(work) / "run", root / "runs" / "p7")
    shutil.copytree(Path(work) / "imported_run", root / "checkpoints" / "imported")
    for side in (root / "runs" / "p7" / "checkpoints").rglob("config.json"):
        side.write_text(json.dumps({**json.loads(side.read_text()), "use_pallas": True}))
    p7 = "runs/p7/checkpoints"
    server = serve("127.0.0.1", 0, root, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    ms, launches, b3_launches = {}, {}, {}
    gf.LAUNCHES.reset()
    up.LAUNCHES.reset()

    def call(name, path, body=None, b4=None):
        """One request: its ms, and the B4 and B3 launches while it ran
        (summed over the requests of one name; a generation job's batches
        land in its status polls, which may split a batch). B4 launches B3
        three times a batch."""
        before, b3_before = gf.LAUNCHES.count, up.LAUNCHES.count
        payload, ctype, t = http(base + path, body)
        ms[name] = t
        n4, n3 = gf.LAUNCHES.count - before, up.LAUNCHES.count - b3_before
        launches[name] = launches.get(name, 0) + n4
        b3_launches[name] = b3_launches.get(name, 0) + n3
        if b4 is not None and (n4 != b4 or n3 != 3 * b4):
            raise AssertionError(f"panel {name}: {n4} B4 launches (expected {b4}), "
                                 f"{n3} B3 launches")
        return json.loads(payload) if ctype == "application/json" else payload

    try:
        found = {c["path"]: c for c in call("checkpoints", "/api/checkpoints")}
        if sorted(found) != ["checkpoints/imported", p7] or found[p7]["latest"] != 2:
            raise AssertionError(f"panel checkpoints: {found}")
        gen = call("generate n=64", "/api/generate", {"checkpoint": p7, "n": 64, "seed": 3},
                   b4=1)
        if gen["count"] != 64 or len(gen["thumbnails"]) != 64:
            raise AssertionError(f"panel generate: {gen['count']} images")
        # The request's card work, its session's sample(64), profiled from
        # this thread (the server's handler threads do not reach the trace).
        # Late in this script the trace may be empty or hold part of that
        # work (PERF.md section 7): its busy time counts only if it holds
        # every kernel of B4 and at least B4's operations a call; the
        # CUDA-event span is measured either way.
        session = server.core._session(p7, "latest")
        per, busy, ops = device_time(lambda: session.sample(64, seed=3), calls=3, cpu=True)
        missing = [k[:60] for k in sorted(set(b4_kernels) - set(per))]
        if missing or ops < b4_ops:
            busy = None
        span = card_span(session, 64)
        best = call("generate n=64, quality filter 0.5", "/api/generate",
                    {"checkpoint": p7, "n": 64, "seed": 4, "quality_filter": True,
                     "keep_fraction": 0.5}, b4=2)
        scores = best["scores"]
        if (len(scores) != 64 or scores != sorted(scores, reverse=True)
                or not all(0 < x < 1 for x in scores)):
            raise AssertionError("panel quality filter: scores not D's top 64 in (0, 1)")
        # Epoch 1 is the JAX run's (its sidecar sets use_pallas); epoch 2,
        # phase 14a's resume, has the CLI's config.
        imported = call("generate n=16 (imported run)", "/api/generate",
                        {"checkpoint": "checkpoints/imported", "which": 1, "n": 16}, b4=1)
        frames = call("interpolate", "/api/interpolate",
                      {"checkpoint": p7, "steps": 10}, b4=1)["frames"]
        if imported["count"] != 16 or len(frames) != 10:
            raise AssertionError("panel: imported run's generation or interpolation")
        b4_before_job, b3_before_job = gf.LAUNCHES.count, up.LAUNCHES.count
        job = call("generate_start n=100", "/api/generate/start",
                   {"checkpoint": p7, "n": 100, "batch_size": 32, "seed": 5})
        t0 = time.perf_counter()
        while True:
            st = call("generate_status", f"/api/generate/status/{job['job']}")
            if st["finished"] or time.perf_counter() - t0 > 120:
                break
            time.sleep(0.05)
        ms["generation job"] = (time.perf_counter() - t0) * 1e3
        # The job's batches run in the server's worker thread, between the
        # polls too: count them over the whole job.
        for counts in (launches, b3_launches):
            counts.pop("generate_start n=100")
            counts.pop("generate_status")
        launches["generation job"] = gf.LAUNCHES.count - b4_before_job
        b3_launches["generation job"] = up.LAUNCHES.count - b3_before_job
        if (st["error"] or st["kept"] != 100 or st["n_files"] != 100
                or launches["generation job"] != 4 or b3_launches["generation job"] != 12):
            raise AssertionError(f"panel generation job: {st}, B4 launches "
                                 f"{launches['generation job']} (4 batches of 32), B3 "
                                 f"{b3_launches['generation job']}")
        rel = job["output_rel"]
        page = call("gallery", f"/api/gallery?dir={rel}&page=1&page_size=24")
        sheet = decode_png(call("contact sheet", f"/api/contact_sheet?dir={rel}"))
        chart = decode_png(call("runs compare", "/api/runs/compare?runs=p7&key=g_loss"))
        zipped = zipfile.ZipFile(io.BytesIO(call("export zip", f"/api/export?dir={rel}")))
        saved = call("save, binarize + transparency", "/api/save",
                     {"dir": rel, "dest": "exports/bin", "binarize": True, "threshold": 128,
                      "transparent": True})
        rgba = decode_png((root / "exports" / "bin" / saved["names"][0]).read_bytes())
        if (page["total"] != 100 or len(page["items"]) != 24 or sheet.ndim != 3
                or chart.shape != (495, 880, 3) or len(zipped.namelist()) != 100
                or saved["saved"] != 100 or rgba.shape != (64, 64, 4)
                or not set(np.unique(rgba[..., 3])) <= {0, 255}):
            raise AssertionError("panel gallery / contact sheet / chart / zip / save")
        about = call("about", "/api/about")
        if about["platform"] != "gpu" or not about["memory"]["bytes_in_use"]:
            raise AssertionError(f"panel about: {about}")
        started = call("train_start", "/api/train/start",
                       {"data_dir": str(Path(work) / "data"), "run_name": "panel_run",
                        "epochs": 1})
        if "error" in started:
            raise AssertionError(f"panel train_start: {started}")
        t0 = time.perf_counter()
        while True:
            st = call("train_status", "/api/train/status")
            if not st["running"] or time.perf_counter() - t0 > 600:
                break
            time.sleep(1.0)
        train_s = time.perf_counter() - t0
        run = root / "runs" / "panel_run"
        tail = "\n".join(st.get("log_tail") or [])
        if (st["running"] or st["epochs_done"] != 1 or not st.get("latest_sample")
                or not (run / "checkpoints" / "config.json").exists()
                or "Training summary" not in tail):
            raise AssertionError(f"panel training subprocess: {st.get('metrics')}\n{tail}")
        runs = call("runs", "/api/runs")
        if sorted(r["name"] for r in runs) != ["p7", "panel_run"]:
            raise AssertionError(f"panel runs: {runs}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    m = st["metrics"][-1]
    print("panel: request ms " + "; ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; the generate n=64 request's card work (its session's sample(64)): "
          f"{span:.4f} ms between CUDA events (z in, B4, images out), card busy "
          f"{fmt_ms(busy)} by the profiler ({ops:.0f} device operations"
          + (f"; the trace lacks B4's kernels {missing} or operations ({b4_ops:.0f} a "
             f"call), so its busy time is not counted" if busy is None else "")
          + f"); B4 launches {launches}; B3 launches {b3_launches}; "
          f"training subprocess (TrainConfig() defaults, "
          f"1 epoch on phase 7's 2048 PNGs, 32 steps of 64) ran to its end in {train_s:.1f} s "
          f"from its start: d_loss {m['d_loss']:.4f} g_loss {m['g_loss']:.4f} [{card}]",
          flush=True)
    return {"request_ms": ms, "generate_busy_ms": busy, "generate_card_span_ms": span,
            "generate_trace_lacks": missing, "b4_launches": launches,
            "b3_launches": b3_launches, "train_subprocess_s": train_s}


# B2's kernels in a bf16 step (conv_tile_kernel is its f32 path), and the
# relayout it may add; the profiled epoch's trace must hold the first three.
STREAM_B2_KERNELS = ("convt_mma_kernel", "bn_finalize_kernel", "final_conv_kernel",
                     "relayout_kernel")


def train_dirs(root: Path, tag: str) -> dict:
    return {"checkpoint_dir": str(root / tag / "c"), "sample_dir": str(root / tag / "s"),
            "log_dir": str(root / tag / "l")}


class cudnn_deterministic:
    """cuDNN's deterministic algorithms (and no benchmark search) inside
    ``with``, the settings as they were restored on leaving: two runs of the
    same steps then give the same bits (cuDNN's default backward convs may
    sum in another order on every call)."""

    def __enter__(self):
        import torch
        self.saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        return self

    def __exit__(self, *exc):
        import torch
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = self.saved
        return False


def stream_graphed_vs_eager(tag, cfg, images, state0, steps: int):
    """Phase 15b: ``steps`` streamed steps from copies of ``state0`` on the
    loader's batches, twice eager (``make_train_step``) and once graphed
    (``make_stream_step``: two eager warm-up steps, the capture, replays),
    with cuDNN's deterministic algorithms (a capture may otherwise take
    other algorithms than the eager steps). Where the eager runs give the
    same bits the graphed run must too, else it must stay within their
    spread, part by part (as graphed_vs_eager)."""
    with cudnn_deterministic():
        return _stream_graphed_vs_eager(tag, cfg, images, state0, steps)


def _stream_graphed_vs_eager(tag, cfg, images, state0, steps: int):
    import torch
    from siggan_tpu_torch.data.loader import BatchLoader
    from siggan_tpu_torch.train import train_step as ts

    def run(step_fn, reshape):
        state, ms = copy.deepcopy(state0), []
        loader = BatchLoader(images, cfg.batch_size, seed=cfg.seed, prefetch=cfg.prefetch)
        for batch in loader.epoch(0):
            if len(ms) == steps:
                break
            state, m = step_fn(state, batch)
            ms.append({k: v.reshape(1) for k, v in m.items()} if reshape else m)
        return state, state_groups(state, {k: torch.cat([m[k] for m in ms]) for k in ms[0]})
    _, first = run(ts.make_train_step(cfg), True)
    _, second = run(ts.make_train_step(cfg), True)
    graphed_fn = ts.make_stream_step(cfg)
    _, graphed = run(graphed_fn, False)
    torch.cuda.synchronize()
    spread, diff = group_diffs(first, second), group_diffs(graphed, first)
    bit_equal = all(v == 0.0 for v in spread.values())
    for part, d in diff.items():
        if d > 2 * spread[part]:
            raise AssertionError(f"{tag}: graphed vs eager {part} differ by {d:.3e}, "
                                 f"two eager runs by {spread[part]:.3e}")
    print(f"{tag}: {steps} graphed streamed steps (capture "
          f"{graphed_fn.graphed.capture_s:.3f} s after 2 eager ones) vs {steps} eager "
          f"streamed steps on the loader's batches, cuDNN deterministic: eager vs eager max "
          f"abs diff by part "
          f"{json.dumps(spread)}; graphed vs eager {json.dumps(diff)}; "
          f"{'bit-equal' if bit_equal else 'within the eager spread'}", flush=True)
    return {"steps": steps, "eager_spread": spread, "graphed_vs_eager": diff,
            "eager_bit_equal": bit_equal}


def read_gif(data: bytes):
    """(grey frames, delays in centiseconds, loop count) of a GIF89a with a
    global grey palette, LZW decoded here, apart from the port's encoder."""
    import numpy as np
    import struct
    if data[:6] != b"GIF89a":
        raise AssertionError("not a GIF89a")
    _, _, packed = struct.unpack("<HHB", data[6:11])
    pos, pal = 13, None
    if packed & 0x80:
        n = 2 << (packed & 7)
        pal = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    frames, delays, loop, delay = [], [], None, 0

    def blocks():
        nonlocal pos
        out = []
        while data[pos]:
            out.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        pos += 1
        return out
    while data[pos] != 0x3B:
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            label = data[pos]
            pos += 1
            sub = blocks()
            if label == 0xF9:
                delay = struct.unpack("<H", sub[0][1:3])[0]
            elif label == 0xFF and sub[0] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", sub[1][1:3])[0]
        elif kind == 0x2C:
            _, _, fw, fh, _ = struct.unpack("<HHHHB", data[pos:pos + 9])
            mcs = data[pos + 9]
            pos += 10
            idx = lzw_decode(b"".join(blocks()), mcs)
            if len(idx) != fw * fh:
                raise AssertionError(f"GIF frame of {len(idx)} pixels, {fw} x {fh} expected")
            rgb = pal[np.frombuffer(idx, np.uint8)].reshape(fh, fw, 3)
            frames.append(rgb[..., 0])
            delays.append(delay)
        else:
            raise AssertionError(f"GIF block {kind:#x}")
    return frames, delays, loop


def lzw_decode(raw: bytes, mcs: int) -> bytes:
    """GIF's variable-width LZW (least significant bit first)."""
    clear, end = 1 << mcs, (1 << mcs) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, size, prev, bit, out = list(base), mcs + 1, None, 0, bytearray()
    raw = raw + b"\0\0\0"
    while bit + size <= 8 * (len(raw) - 3):
        word = int.from_bytes(raw[bit >> 3:(bit >> 3) + 3], "little")
        code = (word >> (bit & 7)) & ((1 << size) - 1)
        bit += size
        if code == clear:
            table, size, prev = list(base), mcs + 1, None
            continue
        if code == end:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else table[prev] + table[prev][:1]
            table.append(table[prev] + entry[:1])
        out += entry
        prev = code
        if len(table) == 1 << size and size < 12:
            size += 1
    return bytes(out)


def streaming_phase(card: str, work: str):
    """Phase 15: the rest of the trainer, the host resize in C++ and the
    charts. (a) one epoch at TrainConfig() defaults through GANTrainer on
    262,208 images (phase 7's 2048 decoded ones tiled 128 times plus the
    first 64: 4097 MB f32, over resident_max_mb), streamed by the loader
    as a graphed step: ms/step, images/s, the peak allocated memory (less
    than 1024 MB above what earlier phases hold), launches, finite losses, moved parameters, the checkpoint;
    (b) phase 7's 2048 images resident and streamed (resident_data=False)
    in turns, 2 epochs of 32 each; the streamed step's busy time, idle
    share and operations (profiler); graphed streamed steps against eager
    ones; v1.1 streamed for 1 epoch of 16 on 1024 128 px images; (c)
    ``cli.train --profile_dir`` in a fresh process, its trace holding B2's
    kernels; (d) the C++ resize against numpy's on phase 12's pages, with
    both routes' decode_images and cli.preprocess times; (e) the verifier
    and ablation charts, phase 7's training GIF, montage and loss plot."""
    import gc
    import numpy as np
    import torch
    from siggan_tpu_torch.ckpt.manager import CheckpointManager
    from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
    from siggan_tpu_torch.core.state import create_train_state
    from siggan_tpu_torch.data.dataset import SignatureDataset
    from siggan_tpu_torch.data.loader import BatchLoader
    from siggan_tpu_torch.data.synthetic import generate_dataset
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    from siggan_tpu_torch.train import train_step as ts
    from siggan_tpu_torch.train.trainer import GANTrainer

    root = Path(work) / "stream"
    base = SignatureDataset(f"{work}/data", 64).images
    counters = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES)

    def counts():
        return {"pack_tail": pt.FWD_LAUNCHES.count,
                "pack_tail_backward": pt.BWD_LAUNCHES.count, "train_tail": tt.LAUNCHES.count}

    def moved(cfg, state):
        init = create_train_state(cfg, "cuda")
        return all(not torch.equal(a, b) for a, b in zip(
            [*init.g.parameters(), *init.d.parameters()],
            [*state.g.parameters(), *state.d.parameters()]))

    # (a) Streaming at the real limit.
    big = np.concatenate([np.tile(base, (128, 1, 1, 1)), base[:64]])
    mb = big.nbytes / 2 ** 20
    cfg = TrainConfig(epochs=1, **train_dirs(root, "a"))
    if len(big) != 262208 or not mb > cfg.resident_max_mb:
        raise AssertionError(f"the streamed set holds {len(big)} images, {mb:.1f} MB")
    gc.collect()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = GANTrainer(cfg, big, device="cuda")
    if trainer.resident or hasattr(trainer, "images_dev"):
        raise AssertionError("the trainer did not take the streaming route")
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {"streaming 262,208 images": counts()}
    want = {"pack_tail": 2 * 4097, "pack_tail_backward": 4097, "train_tail": 4097}
    m = trainer.logger.metrics[-1]
    if launches["streaming 262,208 images"] != want:
        raise AssertionError(f"streaming launches {counts()}, expected {want}")
    if not np.all(np.isfinite([m["d_loss"], m["g_loss"]])) or not moved(cfg, trainer.state):
        raise AssertionError(f"streaming epoch: losses {m}, or a parameter did not move")
    if CheckpointManager(cfg.checkpoint_dir, cfg).resolve("latest") is None:
        raise AssertionError("the streamed run wrote no checkpoint")
    # Earlier phases leave tensors allocated (the served generator, the eval
    # networks, ...): the streamed run's own share is the peak above them.
    if not peak - alloc0 / 2 ** 20 < 1024:
        raise AssertionError(f"peak allocated {peak:.1f} MB while streaming, "
                             f"{alloc0 / 2 ** 20:.1f} MB of it before the trainer")
    capture = trainer._step_fn.graphed.capture_s
    print(f"stream (a): 1 epoch of 4097 steps on 262208 images ({mb:.1f} MB f32, over "
          f"resident_max_mb {cfg.resident_max_mb}) streamed as a graphed step (captured in "
          f"{capture:.3f} s after 2 eager steps): {m['ms_per_step']:.3f} ms/step, "
          f"{m['images_per_sec']:.1f} images/s (the epoch, host clock), {wall:.1f} s for "
          f"train(); peak allocated {peak:.1f} MB, {peak - alloc0 / 2 ** 20:.1f} MB above "
          f"the {alloc0 / 2 ** 20:.1f} MB allocated before the trainer; launches {json.dumps(counts())}; d_loss {m['d_loss']:.4f} g_loss "
          f"{m['g_loss']:.4f}; parameters moved; checkpoint written [{card}]", flush=True)
    stats = {"a": {"ms_per_step": m["ms_per_step"], "images_per_sec": m["images_per_sec"],
                   "peak_allocated_mb": peak, "allocated_before_mb": alloc0 / 2 ** 20,
                   "capture_s": capture, "train_s": wall}}
    del trainer, big
    gc.collect()

    # (b) The same set resident and streamed, in turns.
    routes = {"resident": [], "streaming": []}
    for i, route in enumerate(("resident", "streaming", "streaming", "resident")):
        cfg = TrainConfig(epochs=2, resident_data=route == "resident",
                          **train_dirs(root, f"b{i}"))
        trainer = GANTrainer(cfg, base, device="cuda")
        if trainer.resident != (route == "resident"):
            raise AssertionError(f"{route}: the trainer took the other route")
        trainer.train()
        routes[route].append(trainer.logger.metrics[-1]["ms_per_step"])
    cfg = TrainConfig()
    loader = BatchLoader(base, cfg.batch_size, seed=cfg.seed, prefetch=cfg.prefetch)
    step_fn = ts.make_stream_step(cfg)
    state = create_train_state(cfg, "cuda")
    feed = (b for e in range(100) for b in loader.epoch(e))

    def window(n=16):
        nonlocal state
        for _ in range(n):
            state, _m = step_fn(state, next(feed))
    window(4)   # the eager warm-up steps and the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    s_wall = (time.perf_counter() - t0) * 1e3 / 16
    _, busy, ops = device_time(window, calls=1, cpu=True)
    busy = None if busy is None else busy / 16
    idle = "not measured" if busy is None else f"{1 - busy / s_wall:.4f}"
    print(f"stream (b): 2048 images, epoch 1 of 2 (32 steps) in turns resident / streaming / "
          f"streaming / resident: {routes['resident'][0]:.3f} / {routes['streaming'][0]:.3f} / "
          f"{routes['streaming'][1]:.3f} / {routes['resident'][1]:.3f} ms/step; the streamed "
          f"graphed step over 16-step windows: wall {s_wall:.3f} ms/step, device busy "
          f"{fmt_ms(busy)}/step, idle share {idle}, {ops / 16:.0f} device operations per "
          f"step (profiler) [{card}]", flush=True)
    agreement = stream_graphed_vs_eager("stream (b)", cfg, base,
                                        create_train_state(cfg, "cuda"), 32)
    v11 = TrainConfig(model=ModelConfig(image_size=128, use_spectral_norm=True), epochs=1,
                      resident_data=False, **train_dirs(root, "v11"))
    t0 = time.perf_counter()
    set128 = generate_dataset(1024, 128, seed=0)
    gen_s = time.perf_counter() - t0
    trainer = GANTrainer(v11, set128, device="cuda")
    for c in counters:
        c.reset()
    trainer.train()
    torch.cuda.synchronize()
    launches["streaming v1.1 128 px"] = counts()
    mv = trainer.logger.metrics[-1]
    if counts() != {"pack_tail": 32, "pack_tail_backward": 16, "train_tail": 16} \
            or trainer.resident or not np.isfinite(mv["g_loss"]) or not moved(v11, trainer.state):
        raise AssertionError(f"v1.1 streamed: launches {counts()}, metrics {mv}")
    print(f"stream (b): v1.1 (128 px, spectral norm) streamed, 1 epoch of 16 steps on 1024 "
          f"images (generate_dataset(1024, 128, seed=0), {gen_s:.1f} s): "
          f"{mv['ms_per_step']:.3f} ms/step (the epoch holds the warm-up and the capture), "
          f"launches {json.dumps(counts())} [{card}]", flush=True)
    stats["b"] = {"resident_ms": routes["resident"], "streaming_ms": routes["streaming"],
                  "stream_wall_ms": s_wall, "stream_busy_ms": busy,
                  "stream_ops": ops / 16, "graphed_vs_eager": agreement,
                  "v11_ms_per_step": mv["ms_per_step"]}
    del trainer, set128, loader, feed
    gc.collect()

    # (c) The profiler hook, in a fresh process.
    pdir = root / "profile"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "siggan_tpu_torch.cli.train", "--data_dir",
                           f"{work}/data", "--epochs", "2", "--run_dir", str(root / "c"),
                           "--profile_dir", str(pdir)],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=600)
    prof_s = time.perf_counter() - t0
    if proc.returncode != 0 or f"Profiler trace written to {pdir}" not in proc.stdout:
        raise AssertionError(f"cli.train --profile_dir exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    trace = pdir / "epoch_0001.pt.trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    b2 = {k: sum(k in e["name"] for e in kernels) for k in STREAM_B2_KERNELS}
    if min(b2[k] for k in STREAM_B2_KERNELS[:3]) < 32:
        raise AssertionError(f"the trace of epoch 1 lacks B2's kernels: {b2}")
    print(f"stream (c): cli.train --profile_dir in a fresh process ({prof_s:.1f} s, 2 epochs "
          f"of 32 steps): {trace.name}, {trace.stat().st_size} bytes, {len(kernels)} kernel "
          f"events, B2's kernels {json.dumps(b2)} [{card}]", flush=True)
    stats["c"] = {"trace_bytes": trace.stat().st_size, "kernel_events": len(kernels),
                  "b2_kernels": b2, "cli_s": prof_s}

    # (d) The resize: C++ against numpy on phase 12's pages, and both routes' times.
    stats["d"] = resize_phase(card, work)

    # (e) The charts and the GIF.
    stats["e"] = charts_phase(card, work)
    return launches, stats


def resize_phase(card: str, work: str):
    """Phase 15d: ``sig_resize_bilinear`` bit-equal to the numpy resize on
    phase 12's 1320 PIL-saved pages (decode_images' resize to 64 and
    cli.preprocess's letterbox to the 512 canvas, and a few other sizes),
    and decode_images at 1 and 8 threads and cli.preprocess through the C++
    and the numpy resize, in that order."""
    import numpy as np
    import torch
    from siggan_tpu_torch.cli import preprocess as pre_cli
    from siggan_tpu_torch.data import dataset as ds_mod
    from siggan_tpu_torch.data import resample
    from siggan_tpu_torch.data.native import loader as native
    from siggan_tpu_torch.infer.export import decode_png

    tree = Path(work) / "pil_png_scans"
    paths = ds_mod.list_images(tree)
    page = ds_mod.decode_gray(paths[0])
    t0 = time.perf_counter()
    for w, h in ((64, 64), (512, 213), (1199, 500), (1200, 499), (37, 1000), (2400, 1000)):
        a, b = native.resize_bilinear(page, w, h), resample.resize_bilinear(page, w, h)
        if not np.array_equal(a, b):
            raise AssertionError(f"C++ resize of the page to {w} x {h} differs from numpy's")
    check_s = time.perf_counter() - t0
    cpp = native.resize_bilinear
    ms = {}
    for label, fn in (("C++", cpp), ("numpy", resample.resize_bilinear)):
        t0 = time.perf_counter()
        for _ in range(20):
            fn(page, 64, 64)
        ms[label] = (time.perf_counter() - t0) / 20 * 1e3
    routes, outs = {}, {}
    try:
        for label, fn in (("C++", cpp), ("numpy", resample.resize_bilinear)):
            native.resize_bilinear = fn
            rates = {}
            for threads, n in ((1, 132), (8, 1320)):
                t0 = time.perf_counter()
                out = ds_mod.decode_images(paths[:n], 64, n_threads=threads)
                rates[threads] = n / (time.perf_counter() - t0)
                outs[(label, threads)] = out
            dst = Path(work) / f"resize_clean_{label.replace('+', 'p')}"
            t0 = time.perf_counter()
            run_cli(pre_cli.main, ["--input_dir", str(tree), "--output_dir", str(dst)])
            torch.cuda.synchronize()
            routes[label] = {"images_per_s_1": rates[1], "images_per_s_8": rates[8],
                             "preprocess_s": time.perf_counter() - t0, "dir": dst}
    finally:
        native.resize_bilinear = cpp
    for threads in (1, 8):
        if not np.array_equal(outs[("C++", threads)], outs[("numpy", threads)]):
            raise AssertionError(f"decode_images on {threads} threads: the routes differ")
    files = sorted(p.name for p in routes["C++"]["dir"].glob("*.png"))
    if len(files) != 1320 or files != sorted(p.name for p in routes["numpy"]["dir"].glob("*.png")):
        raise AssertionError("cli.preprocess: the routes wrote other files")
    for name in files[::40]:
        if not np.array_equal(decode_png((routes["C++"]["dir"] / name).read_bytes()),
                              decode_png((routes["numpy"]["dir"] / name).read_bytes())):
            raise AssertionError(f"cli.preprocess: {name} differs between the routes")
    print(f"stream (d): the C++ resize bit-equal to numpy's on the 1200x500 page at 6 sizes "
          f"({check_s:.2f} s) and through decode_images on 132 and 1320 pages and "
          f"cli.preprocess (every 40th of 1320 outputs compared); the page to 64x64 "
          f"{ms['C++']:.3f} ms in C++, {ms['numpy']:.3f} ms in numpy; " + "; ".join(
              f"{k}: decode_images {r['images_per_s_1']:.1f} images/s on 1 thread, "
              f"{r['images_per_s_8']:.1f} on 8, cli.preprocess {r['preprocess_s']:.2f} s"
              for k, r in routes.items()) + f" [{card}]", flush=True)
    return {"page_to_64_ms": ms, **{k: {kk: v for kk, v in r.items() if kk != "dir"}
                                    for k, r in routes.items()}}


def charts_phase(card: str, work: str):
    """Phase 15e: the charts of phases 11 (cli.verifier_eval) and 13b
    (cli.ablate) decode at the JAX figures' pixel sizes; phase 7's sample
    grids as a GIF (decoded here: every frame equal to its grid's grey, the
    delay and the loop), its progress montage and its loss plot."""
    import numpy as np
    from siggan_tpu_torch.data.dataset import _to_gray
    from siggan_tpu_torch.infer.export import decode_png
    from siggan_tpu_torch.utils import visualizer as vis

    w = Path(work)
    want = {w / "verifier_eval" / "roc.png": (550, 660, 3),
            w / "verifier_eval" / "det.png": (550, 660, 3),
            w / "verifier_eval" / "score_distributions.png": (440, 1320, 3),
            w / "verifier_eval" / "metric_comparison.png": (495, 990, 3),
            w / "ablation" / "loss_curves.png": (495, 1320, 3),
            w / "ablation" / "stability.png": (440, 990, 3),
            w / "ablation" / "wall_time.png": (440, 990, 3),
            w / "ablation" / "fid_comparison.png": (440, 990, 3),
            w / "ablation" / "params_vs_fid.png": (495, 660, 3)}
    grids = sorted((w / "run" / "samples").glob("*.png"))
    t0 = time.perf_counter()
    gif = vis.create_training_gif(w / "run" / "samples", w / "charts" / "training.gif")
    gif_s = time.perf_counter() - t0
    frames, delays, loop = read_gif(gif.read_bytes())
    if len(frames) != len(grids) or set(delays) != {30} or loop != 0 or not all(
            np.array_equal(f, _to_gray(decode_png(g.read_bytes())))
            for f, g in zip(frames, grids)):
        raise AssertionError(f"the training GIF: {len(frames)} frames of {len(grids)} grids, "
                             f"delays {set(delays)}, loop {loop}")
    montage = vis.save_progress_montage(w / "run" / "samples", w / "charts" / "montage.png")
    want[montage] = (286, 242 * min(8, len(grids)), 3)
    logs = sorted((w / "run" / "logs").glob("*.json"))
    losses = vis.plot_losses_from_json(logs[-1], w / "charts" / "losses.png")
    want[losses] = (495, 880, 3)
    got = {}
    for path, shape in want.items():
        img = decode_png(path.read_bytes())
        got[path.name] = list(img.shape)
        if img.shape != shape or img.min() == img.max():
            raise AssertionError(f"{path}: {img.shape} (expected {shape}), or blank")
    print(f"stream (e): {len(want)} charts decode at their sizes "
          f"{json.dumps(got)}; the training GIF of {len(grids)} grids "
          f"({gif.stat().st_size} bytes, {gif_s:.2f} s) decodes to them, 30 cs a frame, "
          f"loop 0 [{card}]", flush=True)
    return {"charts": got, "gif_frames": len(frames), "gif_bytes": gif.stat().st_size,
            "gif_s": gif_s}


# Phase 16: data parallelism on the one card.
DP_STEPS = 2
DP_NOTE = ("both sides under cuDNN's deterministic algorithms (one process's repeat of "
           "its steps bit-equal to them); each part (G parameters, G Adam, ...) within "
           "its bar, or else within twice the spread of one process's steps (their "
           "largest difference from the steps on 3 permutations of the batch rows, the "
           "same steps summed in other orders), as phases 7-9 hold graphed steps to the "
           "eager spread. The bars: f32 every tensor allclose rtol 1e-4 atol 1e-5; bf16 "
           "parameters within Adam's bound, 2 lr (1 + 1.054) x 1.01 over the 2 steps (two "
           "runs' updates differ by at most the sum of their sizes; 1.054 bounds "
           "m_hat / sqrt(v_hat) at step 2 for beta (0.5, 0.999), 1 % for bf16 moments), "
           "bf16 BN running statistics B2's bf16 bar on batch statistics, rtol 1e-2 atol "
           "1e-3 (cuDNN runs other bf16 algorithms on 32 rows than on 64), bf16 "
           "accuracies within 4 of 64 rows, the other bf16 parts the spread alone. The "
           "spread is needed for Adam's moments: at init G's fakes are alike, so its "
           "BatchNorm backward cancels most of each gradient (G's fc bias to rounding "
           "noise), and summation order alone moves G's moments by up to 3 % of a "
           "tensor's largest entry)")


def dp_configs():
    """Phase 16b's configurations: the 64 px default, its fused generator
    forwards and v1.1, each in f32 (strict bar) and at its bf16 defaults
    (loose bar)."""
    from siggan_tpu_torch.core.config import ModelConfig, OptimConfig, TrainConfig
    # f32 at LRs 1/100 of the defaults, so that a sign-like Adam step moves a
    # weight by at most 2e-6, under the strict bar.
    f32 = dict(compute_dtype="float32",
               optim=OptimConfig(moment_dtype="float32", g_lr=2e-6, d_lr=2e-6))
    v11 = ModelConfig(image_size=128, use_spectral_norm=True)
    return {"64 px f32": TrainConfig(**f32), "64 px bf16": TrainConfig(),
            "64 px fused f32": TrainConfig(fuse_g_forwards=True, **f32),
            "64 px fused bf16": TrainConfig(fuse_g_forwards=True),
            "v1.1 128 px f32": TrainConfig(model=v11, **f32),
            "v1.1 128 px bf16": TrainConfig(model=v11)}


def dp_rank(work: str) -> None:
    """Phase 16b, one of two gloo ranks on card 0 (spawned): DP_STEPS eager
    steps of each ``dp_configs`` configuration on its 32 rows of a global
    batch of 64, and B2 over the two ranks (its layer route, with a real
    reduction of the totals) and its plain version with the same hook;
    saves what it got to ``dp_rank{r}.pt`` in ``work``."""
    import torch
    import torch.distributed as dist
    from siggan_tpu_torch.core.config import MeshConfig
    from siggan_tpu_torch.parallel.mesh import make_mesh
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", world_size=2, rank=rank, init_method=(
        f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"))
    try:
        with cudnn_deterministic():
            dp_rank_work(work, rank, make_mesh(MeshConfig(), "cuda"))
    finally:
        dist.destroy_process_group()


def dp_rank_work(work: str, rank: int, mesh) -> None:
    """``dp_rank``'s steps and B2 calls on ``mesh``."""
    import torch
    from siggan_tpu_torch.core.state import create_train_state
    from siggan_tpu_torch.data.synthetic import generate_dataset
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    from siggan_tpu_torch.train.train_step import make_train_step, state_tensors
    dev = mesh.device
    out = {}
    for name, cfg in dp_configs().items():
        state = create_train_state(cfg, dev)
        real = torch.from_numpy(generate_dataset(64, cfg.model.image_size, seed=5))
        real = real[mesh.rows(64)].to(dev)
        step = make_train_step(cfg, mesh=mesh)
        counts0 = (pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count, tt.LAUNCHES.count,
                   tt.LAYER_LAUNCHES.count, mesh.collectives.count)
        metrics = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_STEPS):
            state, m = step(state, real)
            metrics.append({k: v.detach().cpu() for k, v in m.items()})
        torch.cuda.synchronize()
        counts = [b - a for a, b in zip(counts0, (
            pt.FWD_LAUNCHES.count, pt.BWD_LAUNCHES.count, tt.LAUNCHES.count,
            tt.LAYER_LAUNCHES.count, mesh.collectives.count))]
        out[name] = {"state": [t.detach().cpu() for t in state_tensors(state)],
                     "metrics": metrics, "launches": counts,
                     "ms_per_step": (time.perf_counter() - t0) * 1e3 / DP_STEPS}
    for dtype in (torch.float32, torch.bfloat16):
        h0, ws, bn, states, bias, _ = train_tail_case(dev, 64, dtype)
        mine = h0[mesh.rows(64)].contiguous()
        got, ref = clone_states(states), clone_states(states)
        with torch.no_grad():
            img = tt.tail_forward_train(mine, ws, bn, got, bias, dtype, mesh=mesh)
            ref_img, ref_new = tt.tail_forward_train_reference(mine, ws, bn, ref, bias,
                                                               dtype, mesh)
        torch.cuda.synchronize()
        cpu = lambda sts: [{k: v.cpu() for k, v in s.items()} for s in sts]  # noqa: E731
        out[f"b2 {str(dtype).split('.')[-1]}"] = {
            "image": img.cpu(), "states": cpu(got), "plain": ref_img.cpu(),
            "plain_states": cpu(ref_new)}
    out["layer_launches"] = tt.LAYER_LAUNCHES.count
    torch.save(out, Path(work) / f"dp_rank{rank}.pt")


def dp_names(state, metrics):
    """The names of ``state_groups(state, metrics)``'s tensors, part by part."""
    g = [n for n, _ in state.g.named_parameters()]
    d = [n for n, _ in state.d.named_parameters()]
    return {"G parameters": g, "G BN statistics": [n for n, _ in state.g.named_buffers()],
            "D parameters": d, "D spectral-norm u": [n for n, _ in state.d.named_buffers()],
            "G Adam": ["count", "lr", *[f"m {n}" for n in g], *[f"v {n}" for n in g]],
            "D Adam": ["count", "lr", *[f"m {n}" for n in d], *[f"v {n}" for n in d]],
            "G EMA": ([] if state.g_ema is None else
                      [n for n, _ in state.g_ema.named_parameters()]
                      + [n for n, _ in state.g_ema.named_buffers()]),
            "metrics": list(metrics)}


def dp_bar(part: str, y, f32: bool, lr: float):
    """Phase 16b's bar for a tensor of ``part`` whose reference is ``y``
    (``DP_NOTE``); None where only the spread holds it."""
    if f32:
        return 1e-5 + 1e-4 * y.abs()
    if part.endswith("parameters") or part == "G EMA":
        return 2 * lr * (1 + 1.054) * 1.01 + 0 * y
    if part == "G BN statistics":
        return 1e-3 + 1e-2 * y.abs()
    return None


def dp_within(what: str, a, b, spread, names, f32: bool, lr: float, table=None, bar=dp_bar):
    """Hold ``a`` to ``b`` (tensor lists by part, ``state_groups``; their
    names ``names``) at phase 16b's bar (``DP_NOTE``; ``bar`` another), ``spread`` the part's
    largest difference between one process's steps and a repeat of them or
    the same steps on a permuted batch: (each part's largest share of its
    bar, None where the spread alone holds it; the failures); ``table``
    collects (part, name, max |ref|, max abs diff, share of the bar or
    None) of every tensor."""
    import torch
    use_by_part, failures = {}, []
    for part in a:
        worst, part_diff, bad = 0.0, 0.0, []
        for name, x, y in zip(names[part], a[part], b[part]):
            x, y = x.detach().float().cpu(), y.detach().float().cpu()
            if not x.numel():
                continue
            if not torch.isfinite(x).all():
                failures.append(f"{what}: {part} {name} is not finite")
            limit = bar(part, y, f32, lr)
            diff = float((x - y).abs().max())
            use = None if limit is None else float(((x - y).abs() / limit).max())
            if table is not None:
                table.append((part, name, float(y.abs().max()), diff, use))
            if diff > 0 and (use is None or use > 1.0):
                bad.append(f"{name} {diff:.3e}")
            if use is None:
                worst = None
            elif worst is not None:
                worst = max(worst, use)
            part_diff = max(part_diff, diff)
        if bad and part_diff > 2 * spread[part]:
            failures.append(f"{what}: {part} max abs diff {part_diff:.3e} over its bar and over "
                            f"twice one process's spread {spread[part]:.3e} "
                            f"({', '.join(bad[:6])})")
        use_by_part[part] = worst
    return use_by_part, failures


def dp_one_process(cfg, real, dev, perm=None, steps: int = DP_STEPS):
    """``steps`` eager steps of one process on the global batch ``real`` and
    its draws, made as the step makes them; with ``perm``, the batch's rows
    and every draw's rows (each half of a D step's 2b) permuted: the same
    steps, summed in another order. Returns (state, stacked metrics)."""
    import torch
    from siggan_tpu_torch.core.state import create_train_state
    from siggan_tpu_torch.train import train_step as ts
    state, step = create_train_state(cfg, dev), ts.make_train_step(cfg)
    streams, b, ms = ts.Streams(cfg.seed, dev), real.shape[0], []
    for _ in range(steps):
        draws = ts.step_draws(cfg, streams, state.step, b, dev)
        draws["masks"] = ts._keep_masks(cfg, draws.pop("u"))
        x = real
        if perm is not None:
            draws = ts._map_draws(lambda t: torch.cat([c[perm] for c in t.split(b)]), draws)
            x = real[perm]
        state, m = step(state, x, draws)
        ms.append(m)
    torch.cuda.synchronize()
    return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def dp_phase(card: str, work: str):
    """Phase 16: data parallelism (``parallel/mesh.py``) on the one card.

    (a) The graphed resident trainer at ``TrainConfig()`` full width, 2
    epochs of 32 steps on 2048 images, without a mesh and then under a
    one-rank NCCL process group (its gradient and metric all-reduces
    captured in the graph), with cuDNN deterministic: bit-equal states; per
    route ms/step and busy ms/step (windows in turns), collectives per step,
    B1 / B1' / B2 launches. Kernel B2's layer route (conv and totals, an
    all-reduce of the totals on the one-rank mesh, the finalize) against its
    single host call at both full-width tails and at the local batches of
    1, 2 and 4 ranks (64, 32, 16): bit-equal, and both timed; the single
    call held to the plain version at each batch.
    (b) Two gloo ranks on the card, spawned: eager steps of the 64 px
    default and v1.1 at global batch 64 (32 rows each), in f32 and bf16,
    against one process's steps at batch 64 on the same draws; the ranks'
    states bitwise equal; B2 over both ranks (layer route, real reduction)
    against its plain version with the same hook and against the single
    call on the whole batch."""
    import gc
    import torch
    import torch.distributed as dist
    from siggan_tpu_torch.core.config import TrainConfig
    from siggan_tpu_torch.data.synthetic import generate_dataset
    from siggan_tpu_torch.ops.kernels import pack_tail as pt
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    from siggan_tpu_torch.parallel.mesh import free_port
    from siggan_tpu_torch.train.train_step import state_tensors
    from siggan_tpu_torch.train.trainer import GANTrainer
    dev = torch.device("cuda", 0)
    out = {}
    images = generate_dataset(2048, 64, seed=7)

    def trainer(tag):
        root = Path(work) / "dp" / tag
        cfg = TrainConfig(epochs=2, sample_interval=0, checkpoint_interval=0,
                          checkpoint_dir=str(root / "c"), sample_dir=str(root / "s"),
                          log_dir=str(root / "l"))
        return GANTrainer(cfg, images, device=dev)

    # (a) The one-rank NCCL graphed trainer against the trainer without a mesh.
    determ = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    counters = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, tt.LAUNCHES, tt.LAYER_LAUNCHES)
    plain = meshed = None
    try:
        plain = trainer("no mesh")
        plain.train()
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
        meshed = trainer("one-rank mesh")
        mesh = meshed.mesh
        if mesh is None or mesh.size != 1 or mesh.backend != "nccl":
            raise AssertionError(f"phase 16a: the trainer's mesh is {mesh}")
        before = [c.count for c in counters] + [mesh.collectives.count]
        meshed.train()
        torch.cuda.synchronize()
        after = [c.count for c in counters] + [mesh.collectives.count]
        steps = meshed.state.step
        b1, b1b, b2, b2_layers, coll = (b - a for a, b in zip(before, after))
        if steps != plain.state.step or steps != 64:
            raise AssertionError(f"phase 16a: {steps} and {plain.state.step} steps, not 64")
        if (b1, b1b, b2, b2_layers) != (2 * steps, steps, steps, 0) or coll != 3 * steps:
            raise AssertionError(f"phase 16a: launches B1 {b1}, B1' {b1b}, B2 {b2} "
                                 f"(layer route {b2_layers}), collectives {coll} over "
                                 f"{steps} steps")
        for x, y in zip(state_tensors(meshed.state), state_tensors(plain.state)):
            if not torch.equal(x, y):
                raise AssertionError("phase 16a: the one-rank NCCL trainer's state differs "
                                     "from the trainer's without a mesh")
        logs = {t.mesh is None: t.logger.metrics for t in (plain, meshed)}
        for k in ("d_loss", "g_loss"):
            if [m[k] for m in logs[True]] != [m[k] for m in logs[False]]:
                raise AssertionError(f"phase 16a: {k} differs")

        # Windows of K = 32 graphed steps in turns: host ms/step and busy ms/step.
        times = {"no mesh": [], "one-rank NCCL mesh": []}
        for tag, t in (("no mesh", plain), ("one-rank NCCL mesh", meshed),
                       ("one-rank NCCL mesh", meshed), ("no mesh", plain)):
            def window(t=t):
                t.state, _ = t._step_fn(t.state, t.images_dev, t.labels_dev)
            window()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / t.scan_steps
            _, busy, ops = device_time(window, calls=1, cpu=True)
            times[tag].append((wall, None if busy is None else busy / t.scan_steps,
                               ops / t.scan_steps))
        out["a"] = {"steps": steps, "bit_equal": True, "launches_per_step": {
            "pack_tail": b1 / steps, "pack_tail_backward": b1b / steps,
            "train_tail": b2 / steps, "train_tail_layer_route": b2_layers / steps},
            "collectives_per_step": coll / steps, "launches": {
                "pack_tail": b1, "pack_tail_backward": b1b, "train_tail": b2},
            "epoch_ms_per_step": {k: [m["ms_per_step"] for m in v] for k, v in
                                  (("no mesh", logs[True]), ("one-rank NCCL mesh",
                                                             logs[False]))},
            "windows": times}
        print(f"16a one-rank NCCL graphed trainer (TrainConfig(), 64 steps, K "
              f"{meshed.scan_steps}): bit-equal to the trainer without a mesh; "
              f"collectives/step {coll / steps:.1f}; launches/step B1 {b1 / steps:.0f}, "
              f"B1' {b1b / steps:.0f}, B2 {b2 / steps:.0f} (layer route {b2_layers}); "
              f"epoch ms/step {json.dumps(out['a']['epoch_ms_per_step'])}; windows "
              f"(host ms/step, busy ms/step, device ops/step) "
              f"{json.dumps(times)}", flush=True)

        # B2's layer route against its single call, at 1, 2 and 4 ranks' batches.
        layer = {}
        for size in (64, 128):
            for dtype in (torch.bfloat16, torch.float32):
                name = str(dtype).split(".")[-1]
                h0, ws, bn, states, bias, canonical = train_tail_case(dev, size, dtype)
                for batch in (64, 32, 16):
                    h = h0[:batch].contiguous()
                    single, lay, spare = (clone_states(states) for _ in range(3))
                    with torch.no_grad():
                        a = tt.tail_forward_train_launch(h, ws, bn, single, bias, dtype)
                        b = tt.tail_forward_train_layers(h, ws, bn, lay, bias, dtype, mesh)
                        ref, ref_new = tt.tail_forward_train_reference(h, ws, bn, states,
                                                                       bias, dtype)
                    torch.cuda.synchronize()
                    if not torch.equal(a, b) or not all(
                            torch.equal(x[k], y[k]) for x, y in zip(single, lay) for k in x):
                        raise AssertionError(f"B2 {size} px {name} batch {batch}: the layer "
                                             f"route differs from the single call")
                    err, st_err, _ = compare_b2(f"B2 {size} px {name} batch {batch}", a, ref,
                                                single, ref_new, states,
                                                dtype == torch.float32)
                    with torch.no_grad():
                        s_ms = time_ms(lambda: tt.tail_forward_train_launch(
                            h, ws, bn, spare, bias, dtype))
                        l_ms = time_ms(lambda: tt.tail_forward_train_layers(
                            h, ws, bn, spare, bias, dtype, mesh))
                    flops, nbytes = tt.tail_cost(batch, h.shape[1], canonical,
                                                 h.element_size())
                    peak = F32_PEAK_FLOPS if dtype == torch.float32 else BF16_PEAK_FLOPS
                    bound = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
                    layer[f"{size}px_{name}_b{batch}"] = {
                        "single_ms": s_ms, "layer_route_ms": l_ms, "bound_ms": bound,
                        "max_abs_diff": err, "batch_stats_max_abs_diff": st_err}
                    print(f"B2 {size} px {name} batch {batch}: layer route bit-equal to the "
                          f"single call; vs plain image {err:.3e}, batch stats {st_err:.3e}; "
                          f"single call {s_ms:.4f} ms, layer route (one-rank NCCL "
                          f"all-reduces) {l_ms:.4f} ms, bound {bound:.4f} ms", flush=True)
        out["layer_route"] = layer
    finally:
        torch.backends.cudnn.deterministic = determ
        # The graphs that hold NCCL work go before the communicator does.
        plain = meshed = None
        gc.collect()
        torch.cuda.synchronize()
        if dist.is_initialized():
            dist.destroy_process_group()

    # (b) Two gloo ranks on the card against one process.
    out["b"] = dp_two_ranks(work)
    return out


def dp_two_ranks(work: str) -> dict:
    """Phase 16b (``dp_phase``'s (b)): ``dp_rank`` spawned on two gloo
    ranks against one process's steps, both under ``cudnn_deterministic``;
    raises AssertionError naming every failure. Returns the numbers, per
    configuration its max abs diff and one process's spread by part."""
    import torch
    from siggan_tpu_torch.data.synthetic import generate_dataset
    from siggan_tpu_torch.ops.kernels import train_tail as tt
    from siggan_tpu_torch.parallel.mesh import spawn
    from siggan_tpu_torch.train.train_step import state_tensors
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    spawn(dp_rank, 2, work)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(Path(work) / f"dp_rank{r}.pt", weights_only=False) for r in (0, 1)]
    b_out = {"spawn_s": spawn_s, "configs": {}, "bar": DP_NOTE}
    failures = []
    # The spread: the same steps on 3 permutations of the batch; a repeat of
    # the steps must give their bits.
    perms = [torch.randperm(64, generator=torch.Generator().manual_seed(s)).to(dev)
             for s in (11, 12, 13)]
    for name, cfg in dp_configs().items():
        f32 = cfg.compute_dtype == "float32"
        real = torch.from_numpy(generate_dataset(64, cfg.model.image_size, seed=5)).to(dev)
        with cudnn_deterministic():
            state, metrics = dp_one_process(cfg, real, dev)
            again, again_metrics = dp_one_process(cfg, real, dev)
            others = [dp_one_process(cfg, real, dev, perm) for perm in perms]
        if not all(torch.equal(x, y) for x, y in zip(state_tensors(state),
                                                     state_tensors(again))) or \
                not all(torch.equal(metrics[k], again_metrics[k]) for k in metrics):
            failures.append(f"16b {name}: one process's repeat of its steps differs")
        got = [r[name] for r in ranks]
        if not all(torch.equal(x, y) for x, y in zip(got[0]["state"], got[1]["state"])):
            failures.append(f"16b {name}: the two ranks' states differ")
        rank_state = copy.deepcopy(state)
        with torch.no_grad():
            for dst, src in zip(state_tensors(rank_state), got[0]["state"]):
                dst.copy_(src)
        # Accuracies count logits on each side of 0; in bf16 a few rows' logits
        # lie within the rounding of 0, so they are held to 4 of 64 rows.
        keys = [k for k in metrics if f32 or "acc" not in k]
        one = state_groups(state, {k: metrics[k] for k in keys})
        spreads = [group_diffs(state_groups(o, {k: om[k] for k in keys}), one)
                   for o, om in others]
        spread = {part: max(sp[part] for sp in spreads) for part in one}
        two = state_groups(rank_state, {k: torch.stack([m[k] for m in got[0]["metrics"]])
                                        .to(dev) for k in keys})
        table = []
        use, bad = dp_within(f"16b {name}", two, one, spread,
                             dp_names(state, {k: None for k in keys}), f32,
                             max(cfg.optim.g_lr, cfg.optim.d_lr), table)
        failures += bad
        for k in set(metrics) - set(keys):
            d = max(abs(float(m[k]) - float(w)) for m, w in zip(got[0]["metrics"], metrics[k]))
            if d > 4 / 64:
                failures.append(f"16b {name}: {k} differs by {d} (over 4 of 64 rows)")
        diffs = group_diffs(two, one)
        worst = sorted(table, key=lambda r: -(r[4] if r[4] is not None else -1))[:5]
        b1, b1b, b2, b2_layers, coll = got[0]["launches"]
        # A fused step: one G forward with gradients (B1, B1') and no B2.
        want = ((1, 1, 0) if cfg.fuse_g_forwards else (2, 1, 1))
        if (b1, b1b, b2, b2_layers) != (want[0] * DP_STEPS, want[1] * DP_STEPS,
                                        want[2] * DP_STEPS, want[2] * DP_STEPS):
            failures.append(f"16b {name}: launches B1 {b1}, B1' {b1b}, B2 {b2} ({b2_layers} "
                            f"on the layer route) in {DP_STEPS} steps")
        b_out["configs"][name] = {"max_abs_diff_by_part": diffs,
                                  "one_process_spread_by_part": spread,
                                  "share_of_bar_by_part": use,
                                  "worst_tensors": worst,
                                  "launches": {"pack_tail": b1, "pack_tail_backward": b1b,
                                               "train_tail": b2,
                                               "train_tail_layer_route": b2_layers},
                                  "collectives_per_step": coll / DP_STEPS,
                                  "rank_ms_per_step": [g["ms_per_step"] for g in got]}
        print(f"16b {name}: 2 gloo ranks x 32 rows vs one process x 64, {DP_STEPS} eager "
              f"steps: ranks bitwise equal; max abs diff by part {json.dumps(diffs)}; "
              f"one process's spread (3 permuted batches) {json.dumps(spread)}; "
              f"share of the bar "
              f"by part (null: the spread alone) {json.dumps(use)}; worst (part, tensor, max "
              f"|ref|, "
              f"diff, share) {json.dumps(worst)}; "
              f"launches/rank B1 {b1}, B1' {b1b}, B2 {b2} (layer route {b2_layers}); "
              f"collectives/step {coll / DP_STEPS:.0f}; rank ms/step "
              f"{[round(g['ms_per_step'], 3) for g in got]}", flush=True)
    b2_dp = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        got = [r[f"b2 {name}"] for r in ranks]
        h0, ws, bn, states, bias, _ = train_tail_case(dev, 64, dtype)
        single = clone_states(states)
        with torch.no_grad():
            whole = tt.tail_forward_train_launch(h0, ws, bn, single, bias, dtype)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        old = [{k: v.cpu() for k, v in s.items()} for s in states]
        err = st_err = whole_err = whole_st = float("nan")
        try:
            for r, g in enumerate(got):
                err, st_err, _ = compare_b2(f"16b B2 {name} rank {r} vs its plain version",
                                            g["image"], g["plain"], g["states"],
                                            g["plain_states"], old, f32)
            img = torch.cat([g["image"] for g in got]).to(dev)
            whole_err, whole_st, _ = compare_b2(
                f"16b B2 {name}: 2 ranks vs the single call on batch 64", img, whole,
                [{k: v.to(dev) for k, v in s.items()} for s in got[0]["states"]], single,
                states, f32)
        except AssertionError as e:
            failures.append(str(e))
        for x, y in zip(got[0]["states"], got[1]["states"]):
            if not all(torch.equal(x[k], y[k]) for k in x):
                failures.append(f"16b B2 {name}: the ranks' running statistics differ")
        b2_dp[name] = {"vs_plain_max_abs_diff": err, "vs_plain_batch_stats": st_err,
                       "vs_single_call_max_abs_diff": whole_err,
                       "vs_single_call_batch_stats": whole_st}
        print(f"16b B2 64 px {name}, 2 gloo ranks x 32 rows (layer route, totals "
              f"all-reduced): vs its plain version image {err:.3e}, batch stats "
              f"{st_err:.3e}; stacked vs the single call on 64 rows image {whole_err:.3e}, "
              f"batch stats {whole_st:.3e}", flush=True)
    b_out["b2"] = b2_dp
    b_out["layer_launches_rank0"] = ranks[0]["layer_launches"]
    print(f"16b: spawn and both ranks' work {spawn_s:.1f} s", flush=True)
    if failures:
        raise AssertionError("phase 16b: " + "; ".join(failures))
    return b_out


def card_span(session, n: int, reps: int = 5) -> float:
    """The median ms between CUDA events around what a request for ``n``
    images runs on the card: the latents in, the generator forward, the
    images out. A sleep kernel ahead of the first event lets the host queue
    all of it, so the span is the card's, not the host's launch pace."""
    import statistics
    import torch
    z = torch.randn(n, session.cfg.latent_dim,
                    generator=torch.Generator().manual_seed(3)).pin_memory()
    out = torch.empty((n, 64, 64, 1), pin_memory=True)
    spans = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        out.copy_(session._fwd(z.to("cuda", non_blocking=True)), non_blocking=True)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return statistics.median(spans[1:])



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
    # Wall seconds of each phase, printed before the kernels line: the script
    # must finish within its time limit as it grows.
    phase_s, clock = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - clock[0], 1)
        clock[0] = now

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
    # The host decoders' library, built once here (phase 12 reports its time).
    from siggan_tpu_torch.data.native import loader as native
    t0 = time.perf_counter()
    native.library()
    host_build_s = time.perf_counter() - t0
    print(f"build: g++ of data/native/decode.cpp and webp.cpp {host_build_s:.1f} s", flush=True)
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

    lap("build, SASS, setup")
    with torch.no_grad():
        b3, b4 = check_kernels(model, dev)
    launches = serve_phase(model, card)
    b1 = check_pack_tail(dev)
    b2 = check_train_tail(dev)
    b2_route = check_fused_route(dev)
    lap("kernels and serving (1-6)")
    with tempfile.TemporaryDirectory() as work:
        paths = {"train 64 px": train_phase(card, keep=work)}
        lap("train 64 px (7)")
        paths["train v1.1 128 px"] = train_phase(card, 128, epochs=2, n_images=1024)
        lap("train v1.1 (8)")
        paths["train v2.0"] = train_phase(card, v20=True)
        lap("train v2.0 (9)")
        eval_launches, stages = eval_phase(card, work)
        lap("evaluation (10)")
        verify_launches, verify_stages = verification_phase(card, work)
        lap("verification (11)")
        decode_stats = decode_phase(card, work, host_build_s)
        lap("decoders (12)")
        paths["train share_fakes"] = shared_fakes_phase(card, work)
        paths["train fuse_g_forwards"], fused_stats = fused_phase(card, work)
        ablation_stats = ablation_phase(card, work)
        lap("shared fakes, fused, ablation (13)")
        imported = imported_run_phase(card, work)
        paths["imported JAX run resume"] = imported["train"]
        panel = panel_phase(card, work, b4["device_kernels"], b4["device_ops"])
        lap("imported run, panel (14)")
        stream_launches, stream_stats = streaming_phase(card, work)
        paths.update(stream_launches)
        lap("streaming (15)")
        dp = dp_phase(card, work)
        paths["data parallel, one-rank NCCL graphed trainer"] = dp["a"]["launches"]
        lap("data parallel (16)")
    print(f"phase seconds: {json.dumps(phase_s)}", flush=True)
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
                                     "verification": verify_launches["generator_forward"],
                                     "imported JAX run": imported["serve"]["generator_forward"],
                                     "panel": sum(panel["b4_launches"].values())},
                   panel_b4_launches_by_request=panel["b4_launches"],
                   eval_stages=stages, verification_stages=verify_stages,
                   decode_stages=decode_stats, ablation=ablation_stats,
                   imported_run=imported, panel=panel)
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
                                     "verification": verify_launches["upsample_block"],
                                     "imported JAX run": imported["serve"]["upsample_block"],
                                     "panel": sum(panel["b3_launches"].values())},
                   panel_b3_launches_by_request=panel["b3_launches"])
    b1_tol = "torch.equal (a copy and a cast)"
    b1_line = entry("pack_tail", "cuda", "siggan_tpu_torch/csrc/pack_tail.cu",
                    "siggan_tpu/ops/packed.py:636", b1["bfloat16"]["fwd"])
    b1_line.update(tol=b1_tol, f32=b1["float32"]["fwd"], fuse_g_forwards=fused_stats,
                   library="torch.take of the zero-extended flat weights by the "
                           "constant index map, + cast to bf16; bf16 output")
    b1b_line = entry("pack_tail_backward", "cuda", "siggan_tpu_torch/csrc/pack_tail.cu",
                     "siggan_tpu/ops/packed.py:719", b1["bfloat16"]["bwd"])
    b1b_line.update(tol="allclose rtol 1e-5 atol 1e-6: f32 sums of up to 4 "
                        "placements, taken in another order by the plain version",
                    f32=b1["float32"]["bwd"],
                    library="index_add_ of the flat cotangent (cast to f32); bf16 input")
    not_counted = ("the panel's training subprocess (phase 14b) runs B1, B1' and B2 in its own "
                   "process, whose counters this script cannot read")
    for line in (b1_line, b1b_line):
        line["launches_by_path"] = {k: v[line["name"]] for k, v in paths.items()}
        line["not_counted"] = not_counted
    b2_line = entry("train_tail", "cuda", "siggan_tpu_torch/csrc/train_tail.cu",
                    "siggan_tpu/ops/pallas/train_tail.py:154", b2[128]["bfloat16"])
    b2_line.update(tol=B2_TOL_NOTE, launches_by_path={k: v["train_tail"]
                                                      for k, v in paths.items()},
                   f32=b2[128]["float32"], px64=b2[64], vs_module_path=b2_route,
                   streaming=stream_stats,
                   layer_route=dp["layer_route"],
                   layer_route_note="the layer route (siggan_train_tail_stage: per BN layer "
                                    "conv + totals, an all-reduce of the totals, the "
                                    "finalize; then the final conv) on a one-rank NCCL mesh "
                                    "beside the single host call, at the local batches of "
                                    "1, 2 and 4 ranks; bit-equal",
                   data_parallel={"one_rank_nccl_trainer": dp["a"], "two_gloo_ranks": dp["b"],
                                  "layer_route_launches_rank0": dp["b"]["layer_launches_rank0"]},
                   not_counted=not_counted,
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
