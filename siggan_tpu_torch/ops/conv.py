"""Linear and convolution forwards, NHWC activations.

The public functions keep the JAX package's layouts (HWIO kernels, ``(in,
out)`` linear weights) so they compare like with like; each converts its
weight once and calls the torch-layout form the generator module stores
(``*_oihw``, ``*_iohw``, ``linear_oi``). The convolutions are cuDNN's (on the
card) or PyTorch's CPU kernels: the JAX package left these to XLA, so there
is no TPU kernel to port here.

``compute_dtype``: inputs and weights are cast to it and the result stays in
it, as in the JAX package; ``None`` keeps the inputs' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _cast(compute_dtype, *ts):
    if compute_dtype is None:
        return ts
    dt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    return tuple(None if t is None else t.to(dt) for t in ts)


def linear_oi(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
              *, compute_dtype=None) -> torch.Tensor:
    """x: (N, Fin), w: (Fout, Fin) as ``nn.Linear`` stores it."""
    x, w = _cast(compute_dtype, x, w)
    y = x @ w.t()
    return y if b is None else y + b.to(y.dtype)


def conv2d_oihw(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                *, stride: int = 1, padding: int = 0,
                compute_dtype=None) -> torch.Tensor:
    """x: (N, H, W, Ci) NHWC; w: (Co, Ci, kh, kw) -> (N, H', W', Co) NHWC."""
    x, w = _cast(compute_dtype, x, w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b.to(y.dtype)


def conv_transpose2d_iohw(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None, *, stride: int = 2,
                          padding: int = 1, compute_dtype=None) -> torch.Tensor:
    """x: (N, H, W, Ci) NHWC; w: (Ci, Co, kh, kw) as ``ConvTranspose2d``
    stores it -> (N, H', W', Co) NHWC."""
    x, w = _cast(compute_dtype, x, w)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b.to(y.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, compute_dtype=None) -> torch.Tensor:
    """x: (N, Fin), w: (Fin, Fout) as the JAX package stores it."""
    return linear_oi(x, w.t(), b, compute_dtype=compute_dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: int = 1, padding: int = 0, compute_dtype=None) -> torch.Tensor:
    """x: (N, H, W, Ci), w: (kh, kw, Ci, Co) HWIO; ``nn.Conv2d`` semantics."""
    return conv2d_oihw(x, w.permute(3, 2, 0, 1), b, stride=stride,
                       padding=padding, compute_dtype=compute_dtype)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *, stride: int = 2,
                     padding: int = 1, compute_dtype=None) -> torch.Tensor:
    """x: (N, H, W, Ci), w: (kh, kw, Ci, Co) HWIO stored unflipped, as the
    JAX package stores it; ``nn.ConvTranspose2d`` semantics."""
    return conv_transpose2d_iohw(x, w.permute(2, 3, 0, 1), b, stride=stride,
                                 padding=padding, compute_dtype=compute_dtype)
