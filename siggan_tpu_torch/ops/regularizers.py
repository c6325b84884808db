"""Dropout2d, as the JAX package's ``ops/regularizers.py::dropout2d``.

``nn.Dropout2d(0.25)`` of the reference discriminator: whole feature maps
are zeroed per (sample, channel) and the survivors scaled by 1/(1-p). The
mask is drawn from an explicit ``torch.Generator`` (uniform < keep, the
JAX ``bernoulli`` law) or injected by the caller, so a test can run the
port on the JAX package's exact masks. Spectral norm is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout2d_mask(shape, rate: float, gen: torch.Generator,
                   device=None) -> torch.Tensor:
    """Keep-mask (N, 1, 1, C) bool for an (N, H, W, C) activation."""
    n, c = shape[0], shape[-1]
    return torch.rand((n, 1, 1, c), generator=gen, device=device) < (1.0 - rate)


def dropout2d(x: torch.Tensor, rate: float, *, train: bool,
              gen: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (N, H, W, C). Drops whole channels; identity when not training."""
    if not train or rate <= 0.0:
        return x
    if mask is None:
        if gen is None:
            raise ValueError("dropout2d in train mode needs a generator or a mask")
        mask = dropout2d_mask(x.shape, rate, gen, x.device)
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
