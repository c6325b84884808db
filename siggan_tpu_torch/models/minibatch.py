"""Minibatch discrimination (Salimans et al. 2016), an anti-mode-collapse
layer.

Port of the JAX package's ``models/minibatch.py``. As there, no model wires
it in: it is available and optional. Given per-sample features it appends
cross-batch L1-kernel similarity statistics, so that D can detect a
collapsed generator producing near-identical samples.
"""

from __future__ import annotations

from typing import Dict

import torch

from siggan_tpu_torch.ops import initializers as init


def init_fn(generator: torch.Generator, in_features: int, out_features: int = 100,
            kernel_dims: int = 5, device=None) -> Dict:
    """{"T": (in_features, out_features * kernel_dims) ~ N(0, 0.02),
    "out_features", "kernel_dims"}, drawn from ``generator`` (CPU)."""
    t = init.normal_w(generator, (in_features, out_features * kernel_dims))
    return {"T": t.to(device), "out_features": out_features, "kernel_dims": kernel_dims}


def apply_fn(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (N, A) -> (N, A + out_features): x, then per kernel row the sum
    over the batch of exp(-L1 distance) to every other sample."""
    b, c = params["out_features"], params["kernel_dims"]
    m = torch.matmul(x.float(), params["T"].float()).reshape(x.shape[0], b, c)
    l1 = (m[:, None] - m[None, :]).abs().sum(-1)          # (N, N, B)
    o = torch.exp(-l1).sum(1) - 1.0                        # drop the self term exp(0)
    return torch.cat([x, o.to(x.dtype)], dim=-1)
