"""Kernel B3: the eval-mode generator upsample block.

ConvTranspose(4, 2, 1) + per-channel affine (folded eval BatchNorm) +
optional ReLU, NHWC. Port of ``siggan_tpu/ops/pallas/upsample.py``
(``pack_w9``, ``fold_bn_affine``, ``upsample_block``). The card runs the
hand-written CUDA kernel in ``csrc/convt_phase.cuh`` (library
``csrc/upsample.cu``) on the tensor cores in 3xTF32: every product is
``a_lo b_hi + a_hi b_lo + a_hi b_hi`` with hi / lo the TF32 parts of each
operand (``tf32_split``), summed in f32. A CPU tensor takes
``upsample_block_reference``, the plain PyTorch version in f32.

``upsample_block`` keeps the JAX signature (``w9`` from ``pack_w9``);
``upsample_block_taps`` takes the per-phase 2x2 taps
(``generator_fwd.pack_block_taps``) and, where the caller has them, their
TF32 split in the kernel's layout (``mma_taps``, which
``generator_fwd.pack_generator`` keeps as ``taps_mma``); otherwise it makes
the split itself. Both count their launches on the card in ``LAUNCHES``;
the generator forward adds its own three block launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from siggan_tpu_torch.ops.kernels import build

LAUNCHES = build.LaunchCounter()
_SIGNATURES = {"siggan_upsample_block":
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}
KC, NT = 8, 32                  # the kernel's input-channel chunk and output-channel tile
_TF32_HALF = 1 << 12            # half a unit of TF32's last mantissa bit
_TF32_MASK = -(1 << 13)         # clears f32's 13 mantissa bits TF32 drops


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties away from zero), as f32: the
    rounding of ``cvt.rna.tf32.f32``, by integer arithmetic on the words."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + _TF32_HALF) & _TF32_MASK).view(torch.float32)


def tf32_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo), both TF32 values: hi = TF32(t), lo = TF32(t - hi).
    hi + lo is within 2^-22 |t| of t."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def mma_taps(taps: torch.Tensor) -> torch.Tensor:
    """(4, 2, 2, Cin, Cout) taps -> (16, ceil(Cin/8), Cout padded to 32, 16),
    the kernel's operand layout (``csrc/convt_phase.cuh``).

    Row (pt, kc, co) holds input channels 8 kc .. 8 kc + 7 of output channel
    co at phase-tap pt = 4 p + 2 a + b, split by ``tf32_split``: floats
    4t .. 4t + 3 are hi(2t), hi(2t + 1), lo(2t), lo(2t + 1). Channels past
    Cin and Cout are zero.
    """
    cin, cout = taps.shape[-2:]
    kc, cop = -(-cin // KC), -(-cout // NT) * NT
    parts = []
    for part in tf32_split(taps.reshape(16, cin, cout)):
        z = part.new_zeros((16, kc * KC, cop))
        z[:, :cin, :cout] = part
        # (pt, kc, t, u, co) -> (pt, kc, co, t, u): channel 8 kc + 2 t + u
        parts.append(z.reshape(16, kc, 4, 2, cop).permute(0, 1, 4, 2, 3))
    return torch.stack(parts, dim=4).reshape(16, kc, cop, 16).contiguous()


def pack_w9(w: torch.Tensor) -> torch.Tensor:
    """(4, 4, Cin, Cout) HWIO ConvT weight -> (4, 9*Cin, Cout).

    Matrix p = 2*di + dj holds output phase (di, dj); row block
    t = 3*(a+1) + (b+1) holds input offset (a, b) in {-1, 0, 1}^2. Phase
    (di, dj) uses the flipped kernel's entry wf[di+2a', dj+2b'] at input
    offset (di-1+a', dj-1+b'); the other 5 of 9 row blocks are zero.
    """
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (4, 4):
        raise ValueError(f"expected a (4, 4, Cin, Cout) kernel, got {tuple(w.shape)}")
    wf = torch.flip(w, dims=(0, 1))
    w9 = w.new_zeros((9, cin, 4, cout))
    for di in range(2):
        for dj in range(2):
            for ap in range(2):
                for bp in range(2):
                    t = 3 * (di + ap) + (dj + bp)
                    w9[t, :, 2 * di + dj, :] = wf[di + 2 * ap, dj + 2 * bp]
    return w9.permute(2, 0, 1, 3).reshape(4, 9 * cin, cout)


def taps_from_w9(w9: torch.Tensor) -> torch.Tensor:
    """(4, 9*Cin, Cout) -> (4, 2, 2, Cin, Cout): the non-zero 2x2 taps of
    each phase (the ``pack_block_taps`` view of the same weights)."""
    _, k9, cout = w9.shape
    v = w9.reshape(4, 3, 3, k9 // 9, cout)
    return torch.stack([v[2 * di + dj, di:di + 2, dj:dj + 2]
                        for di in range(2) for dj in range(2)])


def fold_bn_affine(bn_params: Dict[str, torch.Tensor],
                   bn_state: Dict[str, torch.Tensor], eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN -> (scale, offset) for the kernel epilogue."""
    s = torch.rsqrt(bn_state["var"] + eps) * bn_params["scale"]
    return s, bn_params["offset"] - bn_state["mean"] * s


def convt_phase_reference(x: torch.Tensor, taps: torch.Tensor,
                          scale: torch.Tensor, offset: torch.Tensor,
                          relu: bool = True) -> torch.Tensor:
    """Plain PyTorch: per-phase 2x2 tap matmuls, affine, ReLU, and the
    depth-to-space interleave. x (N, H, W, Cin) -> (N, 2H, 2W, Cout)."""
    n, h, w, _ = x.shape
    cout = taps.shape[-1]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    out = x.new_empty((n, h, 2, w, 2, cout))
    for di in range(2):
        for dj in range(2):
            p = 2 * di + dj
            acc = None
            for a in range(2):
                for b in range(2):
                    m = xp[:, di + a:di + a + h, dj + b:dj + b + w, :] @ taps[p, a, b]
                    acc = m if acc is None else acc + m
            y = acc * scale + offset
            out[:, :, di, :, dj, :] = torch.relu(y) if relu else y
    return out.reshape(n, 2 * h, 2 * w, cout)


def upsample_block_reference(x: torch.Tensor, w9: torch.Tensor,
                             scale: torch.Tensor, offset: torch.Tensor,
                             relu: bool = True) -> torch.Tensor:
    """The plain version of ``upsample_block``."""
    return convt_phase_reference(x, taps_from_w9(w9), scale, offset, relu)


def _launch(x: torch.Tensor, taps: torch.Tensor, scale: torch.Tensor,
            offset: torch.Tensor, relu: bool,
            mma: Optional[torch.Tensor] = None) -> torch.Tensor:
    n, h, w, cin = x.shape
    cout = taps.shape[-1]
    if cout % 4:
        raise ValueError(f"the kernel needs Cout % 4 == 0, got Cout={cout}")
    f32, dev = torch.float32, x.device
    if dev.type != "cuda":
        raise ValueError(f"the upsample kernel needs a CUDA tensor, got {dev}")
    build.require("x", x, f32, dev)
    if mma is None:
        build.require("taps", taps, f32, dev, (4, 2, 2, cin, cout))
        mma = mma_taps(taps)
    build.require("taps_mma", mma, f32, dev, (16, -(-cin // KC), -(-cout // NT) * NT, 16))
    build.require("scale", scale, f32, dev, (cout,))
    build.require("offset", offset, f32, dev, (cout,))
    lib = build.load("upsample", _SIGNATURES)
    out = torch.empty((n, 2 * h, 2 * w, cout), device=dev, dtype=f32)
    build.call(lib, lib.siggan_upsample_block,
               (x.data_ptr(), mma.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                out.data_ptr(), n, h, w, cin, cout, int(relu), build.stream_ptr(dev)),
               dev, "upsample block kernel")
    LAUNCHES.add()
    return out


def upsample_block_taps(x: torch.Tensor, taps: torch.Tensor,
                        scale: torch.Tensor, offset: torch.Tensor,
                        relu: bool = True, mma: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """x (N, H, W, Cin), taps (4, 2, 2, Cin, Cout), scale/offset (Cout,)
    -> (N, 2H, 2W, Cout). ``mma``: ``mma_taps(taps)``, made here when not
    given. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return convt_phase_reference(x, taps, scale, offset, relu)
    return _launch(x, taps, scale, offset, relu, mma)


def upsample_block(x: torch.Tensor, w9: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """x (N, H, W, Cin), w9 (4, 9*Cin, Cout) from ``pack_w9``,
    scale/offset (Cout,) -> (N, 2H, 2W, Cout). The kernel skips the
    structural zeros of ``w9`` and reads only each phase's 2x2 taps."""
    if x.device.type == "cpu":
        return upsample_block_reference(x, w9, scale, offset, relu)
    return _launch(x, taps_from_w9(w9).contiguous(), scale, offset, relu)
