"""Space-to-depth packed training I/O and the packed generator tail.

Port of the JAX package's ``ops/packed.py`` (the canonical math only).
Train-time images travel in 2x2 space-to-depth form (N, H/2, W/2, 4) and
the generator's small-channel tail (every block with Cout <= 64 plus the
final conv) runs in that form, with the canonical kernels re-indexed
exactly into packed-space kernels. Channel order is planar everywhere:
packed index = (2*p_row + p_col)*C + c.

 * tail entry (normal in, packed out): conv2d(x, Kout, s1, p1) ==
   s2d_mc(conv_transpose2d(x, w, s2, p1)), Kout[a, b, ci, q*Co+co] =
   w[u, v, ci, co] with u = 3 - 2a + q_row (columns alike), zero where u
   leaves [0, 4);
 * interior (packed in and out): the packed form of ConvT(4,2,1) is again a
   ConvT(4,2,1), Kboth[A, B, p*Ci+ci, q*Co+co] = w[u, v, ci, co] with
   u = 2A + q_row - 2p_row - 1;
 * final Conv(3,1,1) (packed in and out): Kfin[a, b, p*Ci+ci, q*Co+co] =
   w[du+1, dv+1, ci, co] with du = 2(a-1) - q_row + p_row, zero where
   |du| > 1;
 * D's first Conv(4,2,1) on pixels == Conv(3,1,1) on the packed image:
   K2[a, b, 2py+px, o] = w[2a+py-1, 2b+px-1, 0, o].

The public functions keep the JAX package's HWIO layouts so they compare
like with like. The JAX package's XLA-only rewrites of these graphs
(custom VJPs, the 4x4 image packing, the constant-index gather) are proven
equal to the canonical graph there; the port computes the canonical graph
and lets autograd take the backward. The one-launch pack of every tail
kernel (TPU kernel B1 and its backward B1') is ``ops/kernels/pack_tail.py``,
whose plain version is built from the functions here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) -> (N, H/2, W/2, 4); channel order (2*py + px)."""
    n, h, w, c = x.shape
    if c != 1 or h % 2 or w % 2:
        raise ValueError(f"space_to_depth expects (N, even, even, 1), got {tuple(x.shape)}")
    return space_to_depth_mc(x)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(N, H/2, W/2, 4) -> (N, H, W, 1). Inverse of space_to_depth."""
    if x.shape[-1] != 4:
        raise ValueError(f"depth_to_space expects 4 channels, got {tuple(x.shape)}")
    return depth_to_space_mc(x)


def space_to_depth_mc(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C); channel order (2*p_row+p_col)*C + c."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth_mc expects even H, W, got {tuple(x.shape)}")
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space_mc(x: torch.Tensor) -> torch.Tensor:
    """Inverse of space_to_depth_mc."""
    n, h2, w2, c4 = x.shape
    if c4 % 4:
        raise ValueError(f"depth_to_space_mc expects 4k channels, got {tuple(x.shape)}")
    x = x.reshape(n, h2, w2, 2, 2, c4 // 4)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h2, 2 * w2, c4 // 4)


def _pad_hw(w: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad the two leading (spatial) axes of an HWIO kernel."""
    return F.pad(w, (0, 0, 0, 0, lo, hi, lo, hi))


def _phase_block(wp: torch.Tensor, r0: int, c0: int, kk: int) -> torch.Tensor:
    """Stride-2 spatial slice of a zero-padded kernel: rows r0, r0+2, ...;
    structural zeros fall out of the padding."""
    return wp[r0:r0 + 2 * kk:2, c0:c0 + 2 * kk:2]


def _check(w: torch.Tensor, k: int) -> None:
    if tuple(w.shape[:2]) != (k, k):
        raise ValueError(f"expected a ({k},{k},Ci,Co) kernel, got {tuple(w.shape)}")


def pack_convt_kernel_out_mc(w: torch.Tensor) -> torch.Tensor:
    """(4,4,Ci,Co) -> (3,3,Ci,4Co): conv2d(x, out, s1, p1) ==
    space_to_depth_mc(conv_transpose2d(x, w, s2, p1))."""
    _check(w, 4)
    wp = _pad_hw(torch.flip(w, dims=(0, 1)), 2, 2)   # u = 3+q-2a -> rev 2a-q
    return torch.cat([_phase_block(wp, 2 - qr, 2 - qc, 3)
                      for qr in (0, 1) for qc in (0, 1)], dim=3)


def pack_convt_kernel_both_mc(w: torch.Tensor) -> torch.Tensor:
    """(4,4,Ci,Co) -> (4,4,4Ci,4Co): conv_transpose2d(X, out, s2, p1) ==
    s2d_mc(conv_transpose2d(d2s_mc(X), w, s2, p1)) for packed X."""
    _check(w, 4)
    wp = _pad_hw(w, 4, 4)
    return torch.cat([
        torch.cat([_phase_block(wp, 3 + qr - 2 * pr, 3 + qc - 2 * pc, 4)
                   for qr in (0, 1) for qc in (0, 1)], dim=3)
        for pr in (0, 1) for pc in (0, 1)], dim=2)


def pack_conv3_kernel_both_mc(w: torch.Tensor) -> torch.Tensor:
    """(3,3,Ci,Co) -> (3,3,4Ci,4Co): conv2d(X, out, s1, p1) ==
    s2d_mc(conv2d(d2s_mc(X), w, s1, p1)) for packed X."""
    _check(w, 3)
    wp = _pad_hw(w, 3, 3)
    return torch.cat([
        torch.cat([_phase_block(wp, 2 + pr - qr, 2 + pc - qc, 3)
                   for qr in (0, 1) for qc in (0, 1)], dim=3)
        for pr in (0, 1) for pc in (0, 1)], dim=2)


def pack_first_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(4, 4, 1, Co) -> (3, 3, 4, Co) with conv(space_to_depth(x), out, s1,
    p1) == conv(x, w, s2, p1)."""
    if tuple(w.shape[:3]) != (4, 4, 1):
        raise ValueError(f"expected a (4,4,1,Co) first kernel, got {tuple(w.shape)}")
    zero = w.new_zeros(w.shape[-1:])
    taps = []
    for a in range(3):
        for b in range(3):
            for py in (0, 1):
                for px in (0, 1):
                    u, v = 2 * a + py - 1, 2 * b + px - 1
                    taps.append(w[u, v, 0] if 0 <= u < 4 and 0 <= v < 4 else zero)
    return torch.stack(taps).reshape(3, 3, 4, w.shape[-1])


def conv3_mc_as_matmul_ihwo(h: torch.Tensor, w: torch.Tensor,
                            b: Optional[torch.Tensor] = None,
                            compute_dtype=None) -> torch.Tensor:
    """conv2d(h, w, b, stride=1, padding=1) as one K-dense matmul to
    kh*kw*Q merged taps plus a 9-shift stencil sum in f32.

    h: (N, R, S, K) NHWC; w: (K, kh, kw, Q) -- the layout in which the
    matmul operand ``w.reshape(K, kh*kw*Q)`` is a view, and the one the
    packed-tail kernel writes. Under a compute dtype the tap tensor is
    rounded to it once, as in the JAX function.
    """
    k, kh, kw, q = w.shape
    if h.shape[-1] != k:
        raise ValueError(f"channel mismatch: {tuple(h.shape)} vs {tuple(w.shape)}")
    if compute_dtype is not None:
        dt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
        h, w = h.to(dt), w.to(dt)
    else:
        h, w = h.float(), w.float()
    n, r, s, _ = h.shape
    y = h @ w.reshape(k, kh * kw * q)
    yp = F.pad(y, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    out = None
    for dr in range(kh):
        for dc in range(kw):
            m0 = (dr * kw + dc) * q
            sl = yp[:, dr:dr + r, dc:dc + s, m0:m0 + q].float()
            out = sl if out is None else out + sl
    if b is not None:
        out = out + b.float()
    return out.to(y.dtype)


def conv3_mc_as_matmul(h: torch.Tensor, wp: torch.Tensor,
                       b: Optional[torch.Tensor] = None,
                       compute_dtype=None) -> torch.Tensor:
    """The JAX signature: ``wp`` a packed-mc 3x3 kernel (kh, kw, K, Q) HWIO."""
    return conv3_mc_as_matmul_ihwo(h, wp.permute(2, 0, 1, 3), b, compute_dtype)
