"""Kernel B1' (the packed-tail pack's backward, ``csrc/pack_tail.cu``) has no
CPU form: a Python mirror of its tile and index rules -- the (ci, co) tiles
and their block count, the runs it stages and whether it copies them in 16
bytes, the shared-memory bound, each canonical element's terms in the JAX
kernel's block order, and the runs it writes -- is held bit for bit against
the plain version ``pack_tail_backward_reference``, at the full-width tail
shapes and at ragged channel counts, in bf16 and f32. The plain version is
held against the Pallas kernel's VJP in ``test_torch_port_train_ops.py``."""

import math

import numpy as np
import pytest
import torch

from siggan_tpu_torch.ops.kernels import pack_tail as pt

STAGE = 4096           # kBwdStage: staged elements a block holds at most
MAX_FINAL_CO = 28      # kMaxFinalCo

# (Ci, Co) of [entry, interiors..., final] (the final as (Co, Ci) of its OIHW).
FULL_WIDTH = [(128, 64), (64, 32), (32, 32), (1, 32)]
RAGGED = [(13, 10), (10, 7), (7, 5), (3, 5)]


def tile_of(kind, co):
    """bwd_tile: (ti, tc) of one weight's tiles."""
    if kind == pt.ENTRY:
        return 8, 8
    if kind == pt.INTERIOR:
        return 2, 8
    return max(1, min(8, MAX_FINAL_CO // co)), co


def stage_runs(src, base, s1, s0, st2, st1, st0, length, n_seg, isz):
    """stage_runs: the dense staged runs, and whether the 16-byte path
    copies them (every run start and length a multiple of 16 bytes)."""
    kv = 16 // isz
    vec = (base | st2 | st1 | st0 | length) % kv == 0
    seg = torch.arange(n_seg)
    starts = base + seg // (s0 * s1) * st2 + (seg // s0) % s1 * st1 + seg % s0 * st0
    return src[(starts[:, None] + torch.arange(length)).reshape(-1)], vec


def bwd_sum(kind, s, r, e, ti, tc, co, length):
    """bwd_sum over a grid of (run r, element e): f32 sums from 0, each
    term in p-major order."""
    acc = torch.zeros(torch.broadcast_shapes(r.shape, e.shape))
    if kind == pt.ENTRY:
        v, u, co_l = e & 3, (e >> 2) & 3, e >> 4
        qr, qc = (u + 1) & 1, (v + 1) & 1
        a, b = (3 - u + qr) >> 1, (3 - v + qc) >> 1
        return acc + s[((2 * qr + qc) * tc + co_l) * length + r * 9 + a * 3 + b]
    if kind == pt.INTERIOR:
        v, u, co_l = e & 3, (e >> 2) & 3, e >> 4
        qr, qc = (u + 1) & 1, (v + 1) & 1
        for pr in (0, 1):
            for pc in (0, 1):
                big_a, big_b = (u + 1 + 2 * pr - qr) >> 1, (v + 1 + 2 * pc - qc) >> 1
                assert int(big_a.min()) >= 0 and int(big_a.max()) <= 3
                acc = acc + s[(((2 * pr + pc) * ti + r) * 4 + 2 * qr + qc) * length
                              + co_l * 16 + big_a * 4 + big_b]
        return acc
    ci_l, u, v = e // 9, (e % 9) // 3, e % 3
    for pr in (0, 1):
        for pc in (0, 1):
            qr, qc = (u + 1 + pr) & 1, (v + 1 + pc) & 1
            a, b = (u + 1 + qr - pr) >> 1, (v + 1 + qc - pc) >> 1
            assert int(a.min()) >= 0 and int(a.max()) <= 2
            acc = acc + s[(2 * pr + pc) * length + ((ci_l * 3 + a) * 3 + b) * 4 * co
                          + (2 * qr + qc) * co + r]
    return acc


def b1_bwd_mirror(ws, dps):
    """The kernel's gradients, the number of blocks it launches, and per
    weight whether every tile staged through the 16-byte path."""
    grads, blocks, vec_paths = [], 0, []
    for w, d, kind in zip(ws, dps, pt.kinds(len(ws))):
        ci_n, co_n = pt.dims(w, kind)
        ti_t, tc_t = tile_of(kind, co_n)
        co_tiles = math.ceil(co_n / tc_t)
        n_tiles = math.ceil(ci_n / ti_t) * co_tiles
        blocks += n_tiles
        src, isz = d.reshape(-1), d.element_size()
        out = torch.full((w.numel(),), float("nan"))
        written = torch.zeros(w.numel(), dtype=torch.long)
        all_vec = True
        for t in range(n_tiles):
            ci0, co0 = t // co_tiles * ti_t, t % co_tiles * tc_t
            ti, tc = min(ti_t, ci_n - ci0), min(tc_t, co_n - co0)
            if kind == pt.ENTRY:
                length = ti * 9
                s, vec = stage_runs(src, (co0 * ci_n + ci0) * 9, 4, tc, 0, co_n * ci_n * 9,
                                    ci_n * 9, length, 4 * tc, isz)
                n_runs, run_len = ti, tc * 16
            elif kind == pt.INTERIOR:
                length = tc * 16
                s, vec = stage_runs(src, (ci0 * 4 * co_n + co0) * 16, ti, 4, ci_n * 64 * co_n,
                                    64 * co_n, co_n * 16, length, 16 * ti, isz)
                n_runs, run_len = ti, tc * 16
            else:
                length = ti * 36 * co_n
                s, vec = stage_runs(src, ci0 * 36 * co_n, 1, 4, 0, 0, ci_n * 36 * co_n,
                                    length, 4, isz)
                n_runs, run_len = co_n, ti * 9
            assert s.numel() <= STAGE
            all_vec &= vec
            r, e = torch.arange(n_runs)[:, None], torch.arange(run_len)[None]
            val = bwd_sum(kind, s.float(), r, e, ti, tc, co_n, length)
            start = (r * ci_n + ci0) * 9 if kind == pt.FINAL else ((ci0 + r) * co_n + co0) * 16
            dst = (start + e).reshape(-1)
            out[dst] = val.reshape(-1)
            written[dst] += 1
        assert torch.equal(written, torch.ones_like(written))   # each output once
        grads.append(out.reshape(w.shape))
        vec_paths.append(all_vec)
    return grads, blocks, vec_paths


def tail(channels, seed):
    """Canonical weights of (Ci, Co) pairs in the stored layouts, and random
    packed cotangents in the consumer layouts."""
    g = torch.Generator().manual_seed(seed)
    ws = [torch.zeros(ci, co, 4, 4) for ci, co in channels[:-1]]
    ws.append(torch.zeros(channels[-1][0], channels[-1][1], 3, 3))
    shapes = [pt.packed_shape(k, *pt.dims(w, k)) for w, k in zip(ws, pt.kinds(len(ws)))]
    return ws, [torch.randn(s, generator=g) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels,full", [(FULL_WIDTH, True), (RAGGED, False)])
def test_b1_backward_mirror_matches_plain_version(channels, full, dtype):
    ws, cts = tail(channels, seed=len(channels) + int(full))
    dps = [c.to(dtype) for c in cts]
    got, blocks, vec_paths = b1_bwd_mirror(ws, dps)
    want = pt.pack_tail_backward_reference(ws, dps)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    if full:
        # The full-width tail stages every run with 16-byte copies, on
        # 128 + 128 + 64 + 4 blocks.
        assert vec_paths == [True] * 4 and blocks == 324
    else:
        assert not all(vec_paths)


def test_b1_backward_final_tile_bound():
    """The final's tile keeps every output channel; up to 28 of them fit
    the staged bound (the generator's final has one)."""
    for co in (1, 3, 7, 28):
        ti, tc = tile_of(pt.FINAL, co)
        assert tc == co and 1 <= ti <= 8 and 4 * ti * 36 * co <= STAGE
    assert 4 * tile_of(pt.FINAL, 29)[0] * 36 * 29 > STAGE
    assert np.prod(tile_of(pt.ENTRY, 1)) * 36 <= STAGE
    assert 4 * 4 * np.prod(tile_of(pt.INTERIOR, 1)) * 16 <= STAGE
