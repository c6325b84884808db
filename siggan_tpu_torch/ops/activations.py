"""Activations with the JAX package's derivatives, and label-row lookups
with a deterministic gradient.

``leaky_relu`` is ``jax.nn.leaky_relu``: ``where(x >= 0, x, slope * x)``,
whose derivative at 0 is 1. ``F.leaky_relu``'s backward takes the slope
there, which changes the gradient wherever a pre-activation is exactly 0:
a zero-bias layer over a zero input, as in every box that DiffAugment's
cutout writes as 0. Its forward is kept: one kernel, where the ``where``
form takes three on the discriminator's largest activations.

``take_rows`` is ``table[y]`` (``jnp.take(table, y, axis=0)``) as a
one-hot product: the same values (one term per sum), and a gradient that
is a matrix product, where indexing's backward accumulates repeated labels
in an order that changes from run to run on the CPU and on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu``'s forward (one kernel, the same values as JAX's
    ``where`` form), and JAX's gradient: ``g`` where ``x >= 0``, else
    ``g * slope``."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return _LeakyReLU.apply(x, slope)


def take_rows(table: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Rows ``y`` of ``table`` (rows, ...), differentiable in ``table``."""
    one_hot = torch.nn.functional.one_hot(y, table.shape[0]).to(table.dtype)
    return (one_hot @ table.reshape(table.shape[0], -1)).reshape(y.shape + table.shape[1:])
