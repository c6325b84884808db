"""BatchNorm with explicit state, channel-last, eval and train mode.

Same semantics as the JAX package's ``ops/norm.py`` at ``groups=1``:

- train mode normalizes with the batch statistics, taken in f32 as
  E[x^2] - E[x]^2 over every axis but the last; the biased variance
  normalizes and the unbiased one enters the running estimate with
  momentum 0.1 (eps 1e-5);
- eval mode uses the running (mean, var);
- either way the normalization folds into one per-channel affine computed
  in f32 and applied in x's dtype. A 2-D ``scale``/``offset`` of shape
  (N, C) is a per-sample affine (conditional BN, rows selected by label).

``batch_norm_packed`` is the same over a 2x2 space-to-depth activation
(N, H/2, W/2, 4C) in planar channel order (``ops/packed.py``): canonical
channel c reduces over its 4 phases, the state stays (C,).

Gradients flow through the batch statistics (autograd), as through the JAX
function.

``groups > 1`` (the fused-G-forwards step, ``train/train_step.py::
fused_iteration``): the batch axis holds ``groups`` contiguous equal
sub-batches, forwards that would otherwise run one after another under the
same parameters. Each group normalizes with its own statistics (mean and
E[x^2] in f32, the unbiased variance over the group's count), applied per
row, so the (N, C) affine of conditional BN serves as it is; the running
estimate folds the groups in order, the state a loop of ``groups`` calls
leaves.

Over a mesh of several ranks (``mesh``, a ``parallel/mesh.py::DataMesh``)
the statistics are the global batch's, as GSPMD makes the JAX function's
means global: each rank sums x and x^2 per channel in f32, one all-reduce
adds the ranks' sums, and E[x^2] - E[x]^2 and the running estimate's
unbiasing use the global count, n times the mesh size (every rank holds
an equal share of the batch). With groups the (groups, 2C) sums go in
the same one all-reduce and each group's count is global. The all-reduce is
differentiable, so gradients flow through the global statistics. On one
rank (or without a mesh) the local statistics are the global ones and
nothing is reduced.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

EPS = 1e-5
MOMENTUM = 0.1


def init_state(num_features: int, device=None) -> Dict[str, torch.Tensor]:
    return {"mean": torch.zeros((num_features,), device=device),
            "var": torch.ones((num_features,), device=device)}


def fold_affine(scale: torch.Tensor, offset: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor, eps: float = EPS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN -> (a, b) with y = x * a + b, in f32."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    return a, offset.float() - mean.float() * a


def _train_stats(xf: torch.Tensor, dims, n: int, state: Dict[str, torch.Tensor],
                 momentum: float, mesh=None, groups: int = 1):
    """Train-mode (mean, biased var, new state) of ``xf`` reduced over
    ``dims`` (the batch axis among them), ``n`` values a channel. With
    ``groups > 1`` the batch axis splits into ``groups`` equal sub-batches:
    the statistics are (groups, C) and ``n`` counts one group's values."""
    if groups > 1:
        if xf.shape[0] % groups:
            raise ValueError(f"a batch of {xf.shape[0]} does not split into {groups} groups")
        xf = xf.reshape(groups, xf.shape[0] // groups, *xf.shape[1:])
        dims = tuple(d + 1 for d in dims)
        n //= groups
    if mesh is None or mesh.size == 1:
        mean = xf.mean(dim=dims)
        var = (xf * xf).mean(dim=dims) - mean * mean
    else:
        sums = mesh.all_reduce_sum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims)],
                                             dim=-1))
        n *= mesh.size
        mean, ey2 = (sums / n).chunk(2, dim=-1)
        var = ey2 - mean * mean
    unbiased = var * (n / max(n - 1, 1))
    m_run, v_run = state["mean"], state["var"]
    for i in range(groups):
        gm, gv = (mean, unbiased) if groups == 1 else (mean[i], unbiased[i])
        m_run = (1 - momentum) * m_run + momentum * gm.detach()
        v_run = (1 - momentum) * v_run + momentum * gv.detach()
    return mean, var, {"mean": m_run, "var": v_run}


def _per_row(t: torch.Tensor, rows: int) -> torch.Tensor:
    """(groups, C) group statistics -> (groups * rows, C), one row a sample."""
    return t[:, None].expand(t.shape[0], rows, t.shape[1]).reshape(-1, t.shape[1])


def batch_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
               state: Dict[str, torch.Tensor], *, train: bool = False,
               eps: float = EPS, momentum: float = MOMENTUM, groups: int = 1,
               mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Normalize over every axis but the last. x: (N, C) or (N, H, W, C).

    Returns (y, new_state) like the JAX function; in eval mode the state is
    returned unchanged, in train mode the new state is detached. ``mesh``:
    train-mode statistics over the global batch of its ranks; ``groups``:
    per-group statistics (train mode; the batch a multiple of ``groups``).
    """
    if train:
        dims = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        mean, var, new_state = _train_stats(x.float(), dims, n, state, momentum, mesh, groups)
        if groups > 1:
            mean, var = _per_row(mean, x.shape[0] // groups), _per_row(var, x.shape[0] // groups)
    else:
        mean, var, new_state = state["mean"], state["var"], state
    a, b = fold_affine(scale, offset, mean, var, eps)
    if a.ndim == 2 and x.ndim == 4:
        a = a[:, None, None, :]
        b = b[:, None, None, :]
    return x * a.to(x.dtype) + b.to(x.dtype), new_state


def batch_norm_packed(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                      state: Dict[str, torch.Tensor], *, train: bool = False,
                      eps: float = EPS, momentum: float = MOMENTUM,
                      groups: int = 1, mesh=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BatchNorm over a packed activation (N, H/2, W/2, 4C), planar order
    phase*C + c; the state and the affine stay per canonical channel.
    ``groups`` and ``mesh`` as in ``batch_norm``."""
    n_, h_, w_, c4 = x.shape
    c = c4 // 4
    if train:
        xf = x.float().reshape(n_, h_, w_, 4, c)
        mean, var, new_state = _train_stats(xf, (0, 1, 2, 3), n_ * h_ * w_ * 4,
                                            state, momentum, mesh, groups)
        if groups > 1:
            mean, var = _per_row(mean, n_ // groups), _per_row(var, n_ // groups)
    else:
        mean, var, new_state = state["mean"], state["var"], state
    a, b = fold_affine(scale, offset, mean, var, eps)
    if a.ndim == 2:
        a4 = a.repeat(1, 4)[:, None, None, :]
        b4 = b.repeat(1, 4)[:, None, None, :]
    else:
        a4, b4 = a.repeat(4), b.repeat(4)
    return x * a4.to(x.dtype) + b4.to(x.dtype), new_state
