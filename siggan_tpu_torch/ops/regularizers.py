"""Dropout2d and spectral normalization, as the JAX package's
``ops/regularizers.py``.

``dropout2d`` is ``nn.Dropout2d(0.25)`` of the reference discriminator:
whole feature maps are zeroed per (sample, channel) and the survivors scaled
by 1/(1-p). The mask is drawn from an explicit ``torch.Generator`` (uniform
< keep, the JAX ``bernoulli`` law) or injected by the caller, so a test can
run the port on the JAX package's exact masks.

``spectral_norm`` divides a weight by its largest singular value, estimated
by power iteration on the weight viewed as (out, -1); the left singular
vector ``u`` is explicit state (the discriminator keeps it as a buffer).
The port's weights are stored out-first (OIHW, ``Linear`` (out, in)), so the
view is a plain reshape; its column order differs from the JAX package's
HWIO view, which changes ``v`` (a permutation of it, never stored) but
neither ``u`` nor sigma.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SN_EPS = 1e-12


def keep_mask(u: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep-mask of uniform draws ``u``: u < 1 - rate (JAX's
    ``bernoulli`` law)."""
    return u < (1.0 - rate)


def dropout2d_mask(shape, rate: float, gen: torch.Generator,
                   device=None) -> torch.Tensor:
    """Keep-mask (N, 1, 1, C) bool for an (N, H, W, C) activation."""
    n, c = shape[0], shape[-1]
    return keep_mask(torch.rand((n, 1, 1, c), generator=gen, device=device), rate)


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


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + SN_EPS)


def sn_init(w_out_dim: int, device=None) -> torch.Tensor:
    """The power-iteration vector's start: the unit vector e_0 (f32), as
    the JAX package's ``sn_init`` (not torch's random draw)."""
    u = torch.zeros((w_out_dim,), dtype=torch.float32, device=device)
    u[0] = 1.0
    return u


def spectral_norm(w: torch.Tensor, u: torch.Tensor, *,
                  train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w / sigma in w's dtype, new u). ``w`` is stored out-first and any
    rank; ``u`` (out,) f32.

    Train mode runs one power iteration in f32 with no gradient through
    ``u`` or ``v``; eval mode computes ``v`` once from the stored ``u``.
    Either way sigma = u @ (W @ v) and the gradient reaches ``w`` through
    sigma as well as through the division."""
    mat = w.reshape(w.shape[0], -1).float()
    if train:
        with torch.no_grad():
            v = _l2norm(mat.t() @ u)
            u = _l2norm(mat @ v)
    else:
        v = _l2norm(mat.t() @ u)
    sigma = u @ (mat @ v)
    return (w.float() / sigma).to(w.dtype), u
