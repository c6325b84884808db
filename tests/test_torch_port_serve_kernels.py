"""The arithmetic of the serving kernels' tensor-core design, on the CPU.

B3 and B4 run their ConvT blocks on the tensor cores in 3xTF32: every
product is a_lo b_hi + a_hi b_lo + a_hi b_hi, hi = TF32(v), lo =
TF32(v - hi), summed in f32. The CUDA kernels run only on a card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``); here a plain
emulation, rounding to TF32 by integer arithmetic on the f32 words, holds
the scheme against the f32 plain version at full width and against the
JAX Pallas forward (interpret mode) at small width. A Python mirror of the
fused block-4 + final-conv kernel's row tiles builds the image tile by tile
with the plain ops.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siggan_tpu.core.config import ModelConfig as JModelConfig
from siggan_tpu.models import generator as jgen
from siggan_tpu.ops.pallas import generator_fwd as jfwd
from siggan_tpu_torch import bridge
from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.models.generator import init_fn
from siggan_tpu_torch.ops.conv import conv_transpose2d_iohw, linear_oi
from siggan_tpu_torch.ops.kernels import generator_fwd as gf
from siggan_tpu_torch.ops.kernels import upsample as up

TF32_DROPPED = (1 << 13) - 1   # the f32 mantissa bits TF32 does not keep
# The kernel reads channel 2t at the MMA's k index t and 2t + 1 at t + 4,
# in both operands: the floats of a 16-float row, in k order.
K_HI = [0, 4, 8, 12, 1, 5, 9, 13]
K_LO = [2, 6, 10, 14, 3, 7, 11, 15]
TAIL_ROWS = 8   # image rows one block of the fused kernel owns (kTailRows)
GEN_FWD_CU = Path(__file__).resolve().parents[1] / "siggan_tpu_torch/csrc/generator_fwd.cu"


def calibrated(cfg, seed=0, batch=16):
    """A random generator whose eval BN statistics are its own batch
    statistics with a jitter, so that activations have a trained model's
    scale."""
    model = init_fn(rng.generator(seed, rng.STREAM_INIT_G), cfg, "cpu").eval()
    g = torch.Generator().manual_seed(seed + 1)
    z = torch.randn(batch, cfg.latent_dim, generator=g)

    def set_stats(bn, h):
        flat = h.reshape(-1, h.shape[-1])
        bn.mean.copy_(flat.mean(0) * (0.8 + 0.4 * torch.rand(flat.shape[1], generator=g)))
        bn.var.copy_(flat.var(0) * (0.8 + 0.4 * torch.rand(flat.shape[1], generator=g)))

    with torch.no_grad():
        h = linear_oi(z, model.fc.weight, model.fc.bias)
        set_stats(model.fc_bn, h)
        h = torch.relu(model.fc_bn(h)).reshape(batch, 4, 4, -1)
        for blk in model.blocks:
            h = conv_transpose2d_iohw(h, blk.weight, stride=2, padding=1)
            set_stats(blk.bn, h)
            h = torch.relu(blk.bn(h))
    return model


def small_jax_generator(seed, cfg):
    """JAX init plus random BN running stats, as numpy trees."""
    params, state = jgen.init_fn(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rs = np.random.RandomState(seed)
    for st in [state["fc_bn"]] + state["blocks"]:
        st["mean"] = rs.randn(*st["mean"].shape).astype(np.float32) * 0.1
        st["var"] = (rs.rand(*st["var"].shape) + 0.5).astype(np.float32)
    return params, state


def tf32_matmul(a, b, passes):
    """a @ b with TF32 operands: 3 passes (hi hi + hi lo + lo hi) or 1."""
    ah, al = up.tf32_split(a.contiguous())
    bh, bl = up.tf32_split(b.contiguous())
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def block_tf32(x, taps, scale, offset, passes=3):
    """``convt_phase_reference`` with every tap product in TF32."""
    n, h, w, _ = x.shape
    cout = taps.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    out = x.new_empty((n, h, 2, w, 2, cout))
    for di in range(2):
        for dj in range(2):
            acc = 0
            for a in range(2):
                for b in range(2):
                    acc = acc + tf32_matmul(xp[:, di + a:di + a + h, dj + b:dj + b + w, :],
                                            taps[2 * di + dj, a, b], passes)
            out[:, :, di, :, dj, :] = torch.relu(acc * scale + offset)
    return out.reshape(n, 2 * h, 2 * w, cout)


def forward_tf32(packed, z, passes=3):
    """The kernels' forward: fc and final conv in f32, blocks in TF32."""
    c0 = packed["wfc16"].shape[-1]
    h = torch.relu(torch.einsum("nk,pkc->npc", z, packed["wfc16"])
                   + packed["bfc16"]).reshape(z.shape[0], 4, 4, c0)
    for blk in packed["blocks"]:
        h = block_tf32(h, blk["taps"], blk["scale"], blk["offset"], passes)
    return gf._final_reference(h, packed["wfin"], packed["bfin"])


@pytest.mark.parametrize("value,want", [
    (1 + 2 ** -11, 1 + 2 ** -10),        # a tie rounds away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -12, 1.0),                 # under half a unit rounds down
    (1 + 3 * 2 ** -12, 1 + 2 ** -10),    # over half a unit rounds up
    (2 - 2 ** -12, 2.0),                 # the carry reaches the exponent
    (0.0, 0.0),
])
def test_tf32_round_is_nearest_ties_away(value, want):
    got = up.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert float(got[0]) == want


def unpack_mma(mma, cin, cout):
    """``mma_taps``'s layout -> (hi, lo), each (4, 2, 2, Cin, Cout), read in
    the kernel's k order (K_HI / K_LO)."""
    kc, cop = mma.shape[1:3]
    parts = []
    for idx in (K_HI, K_LO):
        # (pt, kc, co, k) -> (pt, channel 8 kc + 2 (k % 4) + k // 4, co)
        v = mma[..., idx].reshape(16, kc, cop, 2, 4).permute(0, 1, 4, 3, 2)
        parts.append(v.reshape(16, kc * 8, cop)[:, :cin, :cout].reshape(4, 2, 2, cin, cout))
    return parts


@pytest.mark.parametrize("base", [32, 256])
def test_pack_generator_tf32_split_reconstructs_taps(base):
    model = init_fn(rng.generator(base, rng.STREAM_INIT_G),
                    ModelConfig(latent_dim=16, base_features=base), "cpu")
    for blk in gf.pack_generator(model)["blocks"]:
        taps = blk["taps"]
        hi, lo = unpack_mma(blk["taps_mma"], *taps.shape[-2:])
        assert blk["taps_mma"].dtype == torch.float32
        for part in (hi, lo):
            assert int((part.view(torch.int32) & TF32_DROPPED).abs().max()) == 0
        rel = ((hi.double() + lo.double() - taps.double()).abs()
               / taps.double().abs().clamp_min(1e-30))
        assert float(rel.max()) <= 2.0 ** -21
        assert torch.equal(hi, up.tf32_round(taps))


def test_3xtf32_forward_meets_the_f32_bar_at_full_width():
    """ModelConfig() (base 256, latent 100): the 3xTF32 forward stays within
    the serving bar (rtol 1e-4 / atol 1e-4) of the f32 plain version, where
    single-pass TF32 lands far outside it."""
    model = calibrated(ModelConfig())
    packed = gf.pack_generator(model)
    z = torch.randn(4, 100, generator=torch.Generator().manual_seed(9))
    ref = gf.generator_forward_reference(packed, z)
    assert float(ref.std()) > 0.1
    got = forward_tf32(packed, z)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    one = forward_tf32(packed, z, passes=1)
    assert not torch.allclose(one, ref, rtol=1e-4, atol=1e-4)
    assert float((got - ref).abs().max()) < float((one - ref).abs().max()) / 50


def test_3xtf32_forward_matches_pallas_interpret():
    cfg = JModelConfig(latent_dim=16, base_features=32, num_classes=0)
    params, state = small_jax_generator(3, cfg)
    z = np.random.RandomState(4).randn(8, 16).astype(np.float32)
    ref = jfwd.generator_forward(jfwd.pack_generator(params, state, cfg), jnp.asarray(z),
                                 tile=4, interpret=True)
    model = bridge.from_jax(params, state, ModelConfig(latent_dim=16, base_features=32))
    got = forward_tf32(gf.pack_generator(model), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


def test_mma_taps_layout():
    rs = np.random.RandomState(1)
    taps = torch.from_numpy(rs.randn(4, 2, 2, 12, 20).astype(np.float32))
    mma = up.mma_taps(taps)
    assert mma.shape == (16, 2, 32, 16) and mma.is_contiguous()
    for part, want in zip(unpack_mma(mma, 16, 32), up.tf32_split(taps)):
        assert torch.equal(part[..., :12, :20], want)
        assert not part[..., 12:, :].any() and not part[..., 20:].any()


def tile_geometry(n, h, w):
    """Mirror of convt_tile_geometry: (CW, Rs, IPT, TPI, HP, row tiles)."""
    cw = min(w, 64)
    r = min(128 // cw, 384 // (cw + 2) - 2)
    if h <= r:
        rs, tpi, ipt = h, 1, min(r // h, 384 // ((h + 2) * (cw + 2)))
    else:
        rs, ipt, tpi = r, 1, -(-h // r)
    return cw, rs, ipt, tpi, ipt * (rs + 2) * (cw + 2), -(-n // ipt) * tpi


def cluster_splits(blocks, kc):
    """Mirror of convt_tile_splits."""
    s = 1
    while s < 4 and blocks * s < 128 and kc >= 4 * s:
        s *= 2
    return s


def b3_mirror(x, taps, scale, offset, relu=True):
    """B3 as the kernel computes it, block by block: the staged halo (each
    image's rows between zero rows, zero columns beside), the 3xTF32
    products of each phase's 4 taps read from ``mma_taps`` in the kernel's
    k order, the chunk ranges of a cluster's S blocks summed in rank order,
    affine and ReLU. Returns the output and how often each element was
    written."""
    n, h, w, cin = x.shape
    cout = taps.shape[-1]
    cw, rs, ipt, tpi, hp, row_tiles = tile_geometry(n, h, w)
    assert hp <= 384 and ipt * rs * cw <= 128
    kc = -(-cin // 8)
    mma = up.mma_taps(taps)
    cop = mma.shape[2]
    col_tiles = -(-w // cw)
    s = cluster_splits(row_tiles * col_tiles * cop // 32, kc)
    whi = mma[..., K_HI].permute(0, 1, 3, 2).reshape(16, kc * 8, cop)   # (pt, k, co)
    wlo = mma[..., K_LO].permute(0, 1, 3, 2).reshape(16, kc * 8, cop)
    # x's channels in the same k order, chunk by chunk
    order = [8 * c + j for c in range(kc) for j in (0, 2, 4, 6, 1, 3, 5, 7)]
    xk = torch.nn.functional.pad(x, (0, kc * 8 - cin))[..., order]
    out = x.new_zeros((n, 2 * h, 2 * w, cop))
    writes = torch.zeros((n, 2 * h, 2 * w), dtype=torch.int32)
    for bx in range(row_tiles):
        n0, i0 = bx // tpi * ipt, bx % tpi * rs
        for by in range(col_tiles):
            c0 = by * cw
            halo = x.new_zeros((ipt, rs + 2, cw + 2, kc * 8))
            for seg in range(ipt):
                for hr in range(rs + 2):
                    i = i0 + hr - 1
                    if n0 + seg < n and 0 <= i < h:
                        cols = xk[n0 + seg, i, max(c0 - 1, 0):min(c0 + cw + 1, w)]
                        halo[seg, hr, max(c0 - 1, 0) - (c0 - 1):][:cols.shape[0]] = cols
            ahi, alo = up.tf32_split(halo)
            for p in range(4):
                di, dj = p // 2, p % 2
                parts = []
                for rank in range(s):
                    ks = slice(rank * kc // s * 8, (rank + 1) * kc // s * 8)
                    acc = 0
                    for a in range(2):
                        for b in range(2):
                            sl = (slice(None), slice(di + a, di + a + rs),
                                  slice(dj + b, dj + b + cw), ks)
                            bh, bl = whi[4 * p + 2 * a + b, ks], wlo[4 * p + 2 * a + b, ks]
                            acc = acc + (alo[sl] @ bh + ahi[sl] @ bl + ahi[sl] @ bh)
                    parts.append(acc)
                total = parts[0]
                for part in parts[1:]:
                    total = total + part
                for seg in range(ipt):
                    for r in range(rs):
                        for c in range(cw):
                            nn, i, j = n0 + seg, i0 + r, c0 + c
                            if nn < n and i < h and j < w:
                                out[nn, 2 * i + di, 2 * j + dj] = total[seg, r, c]
                                writes[nn, 2 * i + di, 2 * j + dj] += 1
    y = out[..., :cout] * scale + offset
    return (torch.relu(y) if relu else y), writes


@pytest.mark.parametrize("shape,cout", [
    ((2, 4, 4, 256), 128), ((2, 8, 8, 128), 64), ((1, 16, 16, 64), 32), ((1, 32, 32, 32), 32),
    ((3, 4, 4, 100), 36), ((9, 4, 4, 260), 8), ((2, 50, 3, 6), 8), ((1, 3, 130, 8), 12),
    ((70, 1, 1, 16), 4), ((5, 7, 3, 12), 20),
])
def test_b3_tiles_and_splits_mirror(shape, cout):
    """Every output element is written by exactly one block, and the
    block-by-block computation equals the plain version."""
    rs = np.random.RandomState(sum(shape))
    x = torch.from_numpy(np.maximum(rs.randn(*shape), 0).astype(np.float32))
    taps = torch.from_numpy((rs.randn(4, 2, 2, shape[-1], cout) / np.sqrt(4 * shape[-1]))
                            .astype(np.float32))
    scale = torch.from_numpy(rs.rand(cout).astype(np.float32) + 0.5)
    offset = torch.from_numpy(rs.randn(cout).astype(np.float32) * 0.1)
    got, writes = b3_mirror(x, taps, scale, offset)
    assert bool((writes == 1).all())
    torch.testing.assert_close(got, up.convt_phase_reference(x, taps, scale, offset),
                               rtol=1e-5, atol=1e-5)


def test_b3_cluster_splits_at_the_generator_shapes():
    """At batch 64 blocks 1 and 2 hold 32 and 64 tiles: clusters of 4 and 2
    blocks bring each to 128, each block keeping 8 chunks; blocks 3 and 4
    (128 and 512 tiles) are not split."""
    for side, cin, cout, want in ((4, 256, 128, 4), (8, 128, 64, 2), (16, 64, 32, 1),
                                  (32, 32, 32, 1)):
        cw, rs, ipt, tpi, hp, row_tiles = tile_geometry(64, side, side)
        blocks = row_tiles * -(-side // cw) * -(-cout // 32)
        assert cluster_splits(blocks, cin // 8) == want
        assert blocks * want == (128 if side < 32 else 512)


def phase_rows(y0, rows, di):
    """Input-grid rows whose phase-di outputs a fused block owning image
    rows y0 .. y0 + rows - 1 computes (the kernel's m // 32 + y0/2 - di)."""
    return range(y0 // 2 - di, y0 // 2 - di + rows // 2 + 1)


def fused_tile(y0, rows):
    """(block-4 input rows, block-4 output rows) such a block needs: output
    rows y0 - 1 .. y0 + rows (the 3x3 conv's halo) and the input rows they
    read, y0/2 - 1 .. y0/2 + rows/2. Rows outside 0..31 / 0..63 are zero."""
    return range(y0 // 2 - 1, y0 // 2 + rows // 2 + 1), range(y0 - 1, y0 + rows + 1)


def test_fused_tile_rule():
    rows = TAIL_ROWS
    assert f"constexpr int kTailRows = {rows};" in GEN_FWD_CU.read_text()
    for y0 in range(0, 64, rows):
        ins, outs = fused_tile(y0, rows)
        # Each output row is computed once, by the phase of its parity, and
        # reads only input rows the block stages.
        made = sorted(2 * i + di for di in (0, 1) for i in phase_rows(y0, rows, di))
        assert made == list(outs)
        for di in (0, 1):
            for i in phase_rows(y0, rows, di):
                assert {i + di - 1, i + di} <= set(ins)
        assert len(ins) == rows // 2 + 2 and len(outs) == rows + 2
    assert fused_tile(0, rows)[0][0] == -1 and fused_tile(64 - rows, rows)[1][-1] == 64


@pytest.mark.parametrize("base", [32, 256])
def test_fused_tiles_build_the_image(base):
    """Block 4 and the final conv tile by tile, each tile from only its
    rows' halo (zero rows outside the image) and the conv as the fused
    kernel runs it (a product with the 9 taps as columns, then the shifted
    sum), equal the whole forward."""
    rows = TAIL_ROWS
    model = calibrated(ModelConfig(latent_dim=16, base_features=base), seed=base, batch=4)
    packed = gf.pack_generator(model)
    z = torch.randn(3, 16, generator=torch.Generator().manual_seed(rows))
    c0 = packed["wfc16"].shape[-1]
    h = torch.relu(torch.einsum("nk,pkc->npc", z, packed["wfc16"])
                   + packed["bfc16"]).reshape(3, 4, 4, c0)
    for blk in packed["blocks"][:3]:
        h = up.convt_phase_reference(h, blk["taps"], blk["scale"], blk["offset"])
    b4, wfin = packed["blocks"][3], packed["wfin"]
    tiles = []
    for y0 in range(0, 64, rows):
        ins, outs = fused_tile(y0, rows)
        x = h.new_zeros((3, len(ins), 32, h.shape[-1]))
        for k, i in enumerate(ins):
            if 0 <= i < 32:
                x[:, k] = h[:, i]
        y = up.convt_phase_reference(x, b4["taps"], b4["scale"], b4["offset"])
        t = y[:, outs[0] - 2 * ins[0]:outs[-1] - 2 * ins[0] + 1].clone()
        for k, yy in enumerate(outs):
            if not 0 <= yy < 64:
                t[:, k] = 0.0
        # the kernel's final conv: T[pixel][tap] = y[pixel] . wfin[tap], then
        # the 9 shifted taps summed (zero columns beside the image)
        taps = torch.nn.functional.pad(t @ wfin.reshape(9, -1).t(), (0, 0, 1, 1))
        acc = sum(taps[:, a:a + rows, b:b + 64, 3 * a + b] for a in range(3) for b in range(3))
        tiles.append(torch.tanh(acc + packed["bfin"][0])[..., None])
    torch.testing.assert_close(torch.cat(tiles, dim=1),
                               gf.generator_forward_reference(packed, z),
                               rtol=1e-6, atol=1e-6)


def small_packed(seed=0):
    model = init_fn(rng.generator(seed, rng.STREAM_INIT_G),
                    ModelConfig(latent_dim=16, base_features=32), "cpu")
    return gf.pack_generator(model)


def test_plan_checks_once_and_sizes_the_scratch():
    packed = small_packed()
    assert "plan" not in packed        # built only for packed weights on the card
    packed["plan"] = plan = gf._Plan(packed)
    assert plan.widths == [32, 16, 8, 4, 4] and plan.zdim == 16
    assert list(plan.dims) == [16, 32, 16, 8, 4, 4]
    assert plan.scratch == 16 * 32 + 64 * 16 + 256 * 8 + 1024 * 4
    same, ptrs = gf._launch_args(packed)
    assert same is plan and len(ptrs) == 16
    assert ptrs[2] == packed["blocks"][0]["taps_mma"].data_ptr()
    assert ptrs[15] == packed["bfin"].data_ptr()
    packed["blocks"][1]["taps_mma"] = packed["blocks"][1]["taps_mma"][:, :, :16]
    with pytest.raises(ValueError, match="block 2 taps_mma"):
        gf._Plan(packed)


@pytest.mark.parametrize("key", ["wfin", "bfc16", "scale", "taps_mma"])
def test_launch_args_follow_a_replaced_tensor(key):
    """A tensor replaced in the packed dict is checked and its pointer read
    on the next call; the kernel never runs the tensor it replaced."""
    packed = small_packed()
    packed["plan"] = plan = gf._Plan(packed)
    where = packed["blocks"][2] if key in ("scale", "taps_mma") else packed
    where[key] = new = where[key].clone()
    again, ptrs = gf._launch_args(packed)
    assert again is not plan and packed["plan"] is again
    assert new.data_ptr() in list(ptrs)
    assert gf._launch_args(packed)[0] is again      # checked once more, not per call


def test_launch_args_refuse_taps_that_left_their_split():
    """``taps`` (the plain version's) and ``taps_mma`` (the card's) cannot
    drift apart: replacing one without the other raises."""
    packed = small_packed()
    packed["plan"] = gf._Plan(packed)
    packed["blocks"][3]["taps"] = packed["blocks"][3]["taps"] * 2
    with pytest.raises(ValueError, match="block 4 taps_mma is not the TF32 split"):
        gf._launch_args(packed)


def test_launch_args_check_a_replacement_of_the_wrong_shape():
    packed = small_packed()
    packed["plan"] = gf._Plan(packed)
    packed["wfin"] = packed["wfin"][:, :, :2].contiguous()
    with pytest.raises(ValueError, match="wfin"):
        gf._launch_args(packed)


def test_plan_refuses_widths_the_kernels_cannot_take():
    model = init_fn(rng.generator(0, rng.STREAM_INIT_G),
                    ModelConfig(latent_dim=16, base_features=36), "cpu")
    with pytest.raises(ValueError, match="% 4"):
        gf._Plan(gf.pack_generator(model))


def test_generator_forward_off_the_cpu_needs_the_plan():
    """A forward off the CPU never falls back to the plain version: without
    weights packed on the card it raises."""
    model = init_fn(rng.generator(0, rng.STREAM_INIT_G),
                    ModelConfig(latent_dim=16, base_features=32), "cpu")
    with pytest.raises(ValueError, match="not on the card"):
        gf.generator_forward(gf.pack_generator(model), torch.zeros(2, 16, device="meta"))


def test_upsample_taps_wrapper_takes_the_packed_split_on_the_cpu():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 4, 4, 8).astype(np.float32))
    taps = torch.from_numpy(rs.randn(4, 2, 2, 8, 12).astype(np.float32))
    s, o = torch.ones(12), torch.zeros(12)
    got = up.upsample_block_taps(x, taps, s, o, mma=up.mma_taps(taps))
    torch.testing.assert_close(got, up.convt_phase_reference(x, taps, s, o))
    torch.testing.assert_close(block_tf32(x, taps, s, o), got, rtol=1e-5, atol=1e-5)
