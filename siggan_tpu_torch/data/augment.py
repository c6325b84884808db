"""Device-side training augmentation: one batched affine warp.

Port of the JAX package's ``data/augment.py``: rotation (+-5 deg) and scale
(0.9-1.1), and an optional horizontal flip, compose into one inverse affine
map per image and one bilinear resample, run on the device over the batch.
Flips mirror the image first (an exact copy), so the warp's transform stays
near the identity and the banded two-pass form applies: each output row
(column) reads at most 2*band+1 source rows (columns). Out-of-image samples
blend to the fill value +1 (white) through the weight-sum deficit. Inputs
are in [-1, 1].

``dtype``: storage dtype of the interpolation weights and the sampled
pixels (bf16 under the default config); sums stay f32, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _tri(d: torch.Tensor) -> torch.Tensor:
    """Bilinear (triangle) interpolation kernel."""
    return torch.clamp(1.0 - d.abs(), min=0.0)


def _dt(dtype, like: torch.Tensor) -> torch.dtype:
    if dtype is None:
        return like.dtype
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _coeffs(mats: torch.Tensor, h: int, w: int):
    """Raw-coordinate affine: sx = A j + B i + C ; sy = D j + E i + F."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    A, B = mats[:, 0, 0], mats[:, 0, 1]
    C = mats[:, 0, 2] + cx - mats[:, 0, 0] * cx - mats[:, 0, 1] * cy
    D, E = mats[:, 1, 0], mats[:, 1, 1]
    F_ = mats[:, 1, 2] + cy - mats[:, 1, 0] * cx - mats[:, 1, 1] * cy
    return A, B, C, D, E, F_


def _affine_warp_twopass(imgs: torch.Tensor, mats: torch.Tensor, fill: float,
                         dtype=None) -> torch.Tensor:
    """Inverse-map bilinear affine warp as two dense contractions
    (Catmull-Smith). imgs (N, H, W, C); mats (N, 2, 3) about the center."""
    n, h, w, c = imgs.shape
    wdt = _dt(dtype, imgs)
    A, B, C, D, E, F_ = _coeffs(mats, h, w)
    ii = torch.arange(h, dtype=torch.float32, device=imgs.device)
    jj = torch.arange(w, dtype=torch.float32, device=imgs.device)
    alpha = E - D * B / A
    beta = (D / A)[:, None] * jj[None, :] + (F_ - D * C / A)[:, None]
    sy = alpha[:, None, None] * ii[None, :, None] + beta[:, None, :]          # (N,H,W)
    wv = _tri(sy[:, :, None, :] - ii[None, None, :, None]).to(wdt)         # (N,H,y,x)
    tmp = torch.einsum("niyx,nyxc->nixc", wv.float(), imgs.to(wdt).float())
    vsum = wv.float().sum(dim=2)
    tmp = tmp + (1.0 - vsum)[..., None] * fill
    sx = (A[:, None, None] * jj[None, None, :] + B[:, None, None] * ii[None, :, None]
          + C[:, None, None])                                              # (N,H,j)
    wh = _tri(sx[:, :, None, :] - jj[None, None, :, None]).to(wdt)         # (N,H,x,j)
    out = torch.einsum("nixj,nixc->nijc", wh.float(), tmp.to(wdt).float())
    hsum = wh.float().sum(dim=2)
    return (out + (1.0 - hsum)[..., None] * fill).to(imgs.dtype)


def _affine_warp_banded(imgs: torch.Tensor, mats: torch.Tensor, fill: float,
                        band_v: int, band_h: int, dtype=None) -> torch.Tensor:
    """The two-pass warp over the triangle kernel's narrow support: 2*band+1
    shifted slice-multiply taps per pass instead of dense weight tensors.
    Flips must be applied to the image first (see ``augment_apply``)."""
    n, h, w, c = imgs.shape
    wdt = _dt(dtype, imgs)
    A, B, C, D, E, F_ = _coeffs(mats, h, w)
    ii = torch.arange(h, dtype=torch.float32, device=imgs.device)
    jj = torch.arange(w, dtype=torch.float32, device=imgs.device)

    alpha = E - D * B / A
    beta = (D / A)[:, None] * jj[None, :] + (F_ - D * C / A)[:, None]
    sy = alpha[:, None, None] * ii[None, :, None] + beta[:, None, :]          # (N,H,W)
    src = imgs.to(wdt)                                                     # (N,H,W,C)
    srcp = F.pad(src, (0, 0, 0, 0, band_v, band_v))
    acc = torch.zeros((n, h, w, c), dtype=torch.float32, device=imgs.device)
    wsum = torch.zeros_like(sy)
    for d in range(-band_v, band_v + 1):
        wgt = _tri(sy - (ii[None, :, None] + d))
        srow = srcp[:, d + band_v:d + band_v + h]
        rmask = ((ii + d >= 0) & (ii + d < h)).float()
        acc = acc + (wgt[..., None].to(wdt) * srow).float()
        wsum = wsum + wgt * rmask[None, :, None]
    tmp = acc + ((1.0 - wsum) * fill)[..., None]

    sx = (A[:, None, None] * jj[None, None, :] + B[:, None, None] * ii[None, :, None]
          + C[:, None, None])
    tmpp = F.pad(tmp.to(wdt), (0, 0, band_h, band_h))
    acc2 = torch.zeros_like(tmp)
    wsum2 = torch.zeros_like(sx)
    for d in range(-band_h, band_h + 1):
        wgt = _tri(sx - (jj[None, None, :] + d))
        scol = tmpp[:, :, d + band_h:d + band_h + w]
        cmask = ((jj + d >= 0) & (jj + d < w)).float()
        acc2 = acc2 + (wgt[..., None].to(wdt) * scol).float()
        wsum2 = wsum2 + wgt * cmask[None, None, :]
    return (acc2 + ((1.0 - wsum2) * fill)[..., None]).to(imgs.dtype)


def _band_radii(h: int, w: int, rotation_degrees: float,
                scale_lo: float, scale_hi: float) -> Tuple[int, int]:
    """Band radii bounding |sy - i| / |sx - j| + 1 over the transform family
    (rotation in +-deg, scale in [lo, hi], no flip, centered)."""
    th = math.radians(rotation_degrees)
    a_dev = max(abs(1.0 / scale_hi - 1.0), abs(1.0 / (scale_lo * math.cos(th)) - 1.0))
    rv = a_dev * (h - 1) / 2 + math.tan(th) * (w - 1) / 2
    A_dev = max(abs(math.cos(th) / scale_hi - 1.0), abs(1.0 / scale_lo - 1.0))
    rh = A_dev * (w - 1) / 2 + (math.sin(th) / scale_lo) * (h - 1) / 2
    return int(math.ceil(rv)) + 1, int(math.ceil(rh)) + 1


def augment_params(gen: torch.Generator, n: int, *, rotation_degrees: float = 5.0,
                   scale_lo: float = 0.9, scale_hi: float = 1.1, hflip: bool = False,
                   device=None):
    """Per-image transform parameters for n images, drawn from ``gen`` on
    ``device``: (theta radians, scale, flip bool or None)."""
    theta = ((torch.rand(n, generator=gen, device=device) * 2 - 1)
             * rotation_degrees * (math.pi / 180.0))
    scale = scale_lo + torch.rand(n, generator=gen, device=device) * (scale_hi - scale_lo)
    flip = (torch.rand(n, generator=gen, device=device) < 0.5) if hflip else None
    return theta, scale, flip


def augment_apply(batch: torch.Tensor, theta: torch.Tensor, scale: torch.Tensor,
                  flip: Optional[torch.Tensor], *, rotation_degrees: float = 5.0,
                  scale_lo: float = 0.9, scale_hi: float = 1.1,
                  dtype=None) -> torch.Tensor:
    """Warp a batch (N, H, W, C) with pre-drawn per-image parameters. The
    rotation/scale bounds select the banded path and must match the bounds
    the parameters were drawn with."""
    h, w = batch.shape[1:3]
    if flip is not None:
        batch = torch.where(flip[:, None, None, None], torch.flip(batch, dims=(2,)), batch)
    cos, sin = torch.cos(theta), torch.sin(theta)
    inv_s = 1.0 / scale
    zero = torch.zeros_like(cos)
    mats = torch.stack([torch.stack([cos * inv_s, -sin * inv_s, zero], -1),
                        torch.stack([sin * inv_s, cos * inv_s, zero], -1)], dim=1)
    band_v, band_h = _band_radii(h, w, rotation_degrees, scale_lo, scale_hi)
    if max(band_v, band_h) <= min(h, w) // 4:
        return _affine_warp_banded(batch, mats, 1.0, band_v, band_h, dtype=dtype)
    return _affine_warp_twopass(batch, mats, 1.0, dtype=dtype)
