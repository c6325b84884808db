"""DCGAN weight initialization: conv / conv-transpose / linear weights
~ N(0, 0.02), BatchNorm scale ~ N(1, 0.02); biases and BN offsets stay 0.

Shapes are whatever the caller's layout is; draws come from an explicit
CPU ``torch.Generator``, so a seed gives the same weights on every device.
"""

from __future__ import annotations

import torch

DCGAN_STD = 0.02


def normal_w(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * DCGAN_STD


def bn_scale(gen: torch.Generator, n: int) -> torch.Tensor:
    return 1.0 + torch.randn((n,), generator=gen) * DCGAN_STD
