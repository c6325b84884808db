"""Stroke-statistics metrics as torch reductions.

Port of the JAX package's ``eval/stroke.py:19-83``: stroke density (the
fraction of dark pixels under a threshold after mapping [-1, 1] to [0, 1])
and foreground ratio with percentiles, plus the ``MetricsTracker`` epoch
accumulator. The per-image fractions are reduced on ``device`` and reach
the host once; the summary statistics are numpy's, as in JAX.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Union

import numpy as np
import torch

from siggan_tpu_torch.core.platform import DeviceLike, resolve_device


def _dark_fractions(images, threshold: float = 0.5,
                    device: DeviceLike = "cuda") -> np.ndarray:
    """Per-image dark fraction of (N, H, W, C) images in [-1, 1] (every
    producer in the package works in that range, so the remap is
    unconditional; callers holding [0, 1] data map it themselves)."""
    x = torch.as_tensor(images).to(resolve_device(device), torch.float32)
    x = (x + 1.0) / 2.0
    if x.ndim == 4 and x.shape[-1] > 1:
        x = x.mean(dim=-1, keepdim=True)
    dark = (x < threshold).float()
    return dark.reshape(dark.shape[0], -1).mean(dim=1).cpu().numpy()


def calculate_stroke_density(images, threshold: float = 0.5,
                             device: DeviceLike = "cuda") -> Dict[str, float]:
    """``images`` in [-1, 1] (the package-wide image range)."""
    d = _dark_fractions(images, threshold, device)
    return {"mean": float(d.mean()), "std": float(d.std()),
            "min": float(d.min()), "max": float(d.max())}


def calculate_foreground_ratio(images, threshold: float = 0.5,
                               device: DeviceLike = "cuda") -> Dict[str, object]:
    """``images`` in [-1, 1] (the package-wide image range)."""
    d = _dark_fractions(images, threshold, device)
    return {
        "mean": float(d.mean()), "std": float(d.std()),
        "percentiles": {"25": float(np.percentile(d, 25)),
                        "50": float(np.percentile(d, 50)),
                        "75": float(np.percentile(d, 75))},
    }


class MetricsTracker:
    """Epoch accumulator (the reference's MetricsTracker:177-213)."""

    def __init__(self):
        self.metrics: Dict[str, List[float]] = defaultdict(list)
        self.epoch_metrics: Dict[str, List[float]] = defaultdict(list)

    def add(self, name: str, value: Union[float, torch.Tensor]) -> None:
        self.epoch_metrics[name].append(float(value))

    def get_average(self, name: str) -> float:
        vals = self.epoch_metrics.get(name, [])
        return float(np.mean(vals)) if vals else 0.0

    def get_all_averages(self) -> Dict[str, float]:
        return {n: self.get_average(n) for n in self.epoch_metrics}

    def reset(self) -> None:
        for name, vals in self.epoch_metrics.items():
            if vals:
                self.metrics[name].append(float(np.mean(vals)))
        self.epoch_metrics.clear()

    def get_history(self, name: str) -> List[float]:
        return self.metrics.get(name, [])

    def get_last(self, name: str, default: float = 0.0) -> float:
        h = self.metrics.get(name, [])
        return h[-1] if h else default
