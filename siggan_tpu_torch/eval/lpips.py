"""LPIPS (AlexNet backbone) as an ``nn.Module``: the perceptual diversity
metric.

Port of the JAX package's ``eval/lpips.py`` (``:1-125``), NCHW inside.
Structure (richzhang/PerceptualSimilarity): the input scaling layer, the
AlexNet conv stack with features tapped after relu1..relu5, per-layer
channel unit normalization ``f * rsqrt(sum(f^2) + 1e-10)`` (JAX ``:72-73``;
not ``F.normalize``, whose eps clamps the norm instead), squared
difference, the learned 1x1 linear weights, spatial mean, sum over layers.
``diversity`` is the reference's pairwise distance over a sliding window of
10 following images (higher = more diverse samples), its pairs batched.

Weights: ``convert_torch_state_dict`` ingests torchvision's
``alexnet.features`` and the lpips ``lin{i}`` weights. The default is
``init_lpips(seed)``, the JAX law (``:42-53``: conv weights normal times
1/sqrt(k k cin), biases 0, uniform linear weights 1/C) from a seeded
``torch.Generator``; not the JAX package's draws, so its values compare only
within the port (load the JAX tree through ``bridge.lpips_from_jax`` to
compare across packages). Reports tag the backbone used.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from siggan_tpu_torch.eval.common import batched_apply

# (k, cin, cout, stride, pad, pool_after)
ALEX = [
    (11, 3, 64, 4, 2, True),
    (5, 64, 192, 1, 2, True),
    (3, 192, 384, 1, 1, False),
    (3, 384, 256, 1, 1, False),
    (3, 256, 256, 1, 1, False),
]
# torchvision alexnet.features indices of the five convs
ALEX_FEATURE_IDS = (0, 3, 6, 8, 10)

# lpips scaling layer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """``forward(x1, x2)``: (N, 3, H, W) pairs in [-1, 1] -> (N,) distances."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, k, stride=s, padding=p)
                                   for k, cin, cout, s, p, _ in ALEX)
        self.lins = nn.ParameterList(nn.Parameter(torch.full((cout,), 1.0 / cout))
                                     for _, _, cout, _, _, _ in ALEX)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = (x - self.shift) / self.scale
        feats = []
        for conv, (*_, pool) in zip(self.convs, ALEX):
            h = F.relu(conv(h))
            feats.append(h)
            if pool:
                h = F.max_pool2d(h, 3, 2)
        return feats

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for f1, f2, lin in zip(self.features(x1), self.features(x2), self.lins):
            d = torch.square(_unit_norm(f1) - _unit_norm(f2))
            total = total + (d * lin.view(1, -1, 1, 1)).sum(1).mean(dim=(1, 2))
        return total


def _unit_norm(f: torch.Tensor) -> torch.Tensor:
    return f * torch.rsqrt(torch.sum(torch.square(f), dim=1, keepdim=True) + 1e-10)


def init_lpips(seed: int = 0) -> LPIPS:
    """The fixed-seed random backbone on the CPU, in eval mode."""
    model = LPIPS()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv, (k, cin, *_) in zip(model.convs, ALEX):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * (1.0 / np.sqrt(k * k * cin)))
            conv.bias.zero_()
    return model.eval().requires_grad_(False)


def from_state_dict(sd: Mapping) -> LPIPS:
    """An ``LPIPS`` (CPU, eval mode) holding the state dict ``sd``."""
    model = LPIPS()
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return model.eval().requires_grad_(False)


def distance(model: LPIPS, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched LPIPS distance. x1, x2: (N, H, W, 3) in [-1, 1] -> (N,)."""
    return model(x1.permute(0, 3, 1, 2), x2.permute(0, 3, 1, 2))


def _to_rgb(images: np.ndarray) -> np.ndarray:
    images = np.asarray(images, np.float32)
    return np.repeat(images, 3, axis=-1) if images.shape[-1] == 1 else images


def diversity(model: LPIPS, images: np.ndarray, window: int = 10,
              batch_pairs: int = 256) -> float:
    """Mean pairwise LPIPS over a sliding window (the reference's
    ``metrics.py:103-115``): pairs (i, j) for j in (i, min(i + window, n)),
    ``batch_pairs`` pairs a call on the model's device."""
    n = len(images)
    if n < 2:
        return 0.0
    idx1, idx2 = [], []
    for i in range(n):
        for j in range(i + 1, min(i + window, n)):
            idx1.append(i)
            idx2.append(j)
    imgs = _to_rgb(images)
    dev = next(model.parameters()).device
    dists = batched_apply(lambda a, b: distance(model, a, b), imgs[np.asarray(idx1)],
                          imgs[np.asarray(idx2)], batch_size=batch_pairs, device=dev)
    return float(np.mean(dists))


def convert_torch_state_dict(alex_sd: Mapping, lin_sd: Mapping) -> Dict[str, torch.Tensor]:
    """torchvision ``alexnet.features.*`` weights + the lpips ``lin{i}``
    weights -> a state dict of ``LPIPS``."""
    sd: Dict[str, torch.Tensor] = {}
    for i, cid in enumerate(ALEX_FEATURE_IDS):
        sd[f"convs.{i}.weight"] = torch.as_tensor(alex_sd[f"features.{cid}.weight"])
        sd[f"convs.{i}.bias"] = torch.as_tensor(alex_sd[f"features.{cid}.bias"])
        sd[f"lins.{i}"] = torch.as_tensor(lin_sd[f"lin{i}.model.1.weight"]).reshape(-1)
    return sd
