"""Eval-mode BatchNorm with explicit state, channel-last.

Same semantics as the JAX package's ``ops/norm.py`` in eval mode: the
running (mean, var) fold into one per-channel affine computed in f32 and
applied in x's dtype. A 2-D ``scale``/``offset`` of shape (N, C) is a
per-sample affine (conditional BN, rows already selected by label). Train
mode, ``groups > 1`` and the packed variant belong to the training path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

EPS = 1e-5


def init_state(num_features: int, device=None) -> Dict[str, torch.Tensor]:
    return {"mean": torch.zeros((num_features,), device=device),
            "var": torch.ones((num_features,), device=device)}


def fold_affine(scale: torch.Tensor, offset: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor, eps: float = EPS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN -> (a, b) with y = x * a + b, in f32."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    return a, offset.float() - mean.float() * a


def batch_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
               state: Dict[str, torch.Tensor], *, train: bool = False,
               eps: float = EPS) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Normalize over every axis but the last with the running statistics.

    x: (N, C) or (N, H, W, C). Returns (y, state) like the JAX function; the
    state is returned unchanged.
    """
    if train:
        raise NotImplementedError("train-mode BatchNorm is not ported yet")
    a, b = fold_affine(scale, offset, state["mean"], state["var"], eps)
    if a.ndim == 2 and x.ndim == 4:
        a = a[:, None, None, :]
        b = b[:, None, None, :]
    return x * a.to(x.dtype) + b.to(x.dtype), state
