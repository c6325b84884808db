"""Mode-collapse detection — training-pathology heuristics (a pure-Python
copy of the JAX package's ``train/collapse.py``).

Parity with ``train_vanilla_gan_signatures.py:104-165``: a sliding window of
(g_loss, D(fake)) batch statistics and three checks — D(fake) variance
near zero, G loss stuck low, D(fake) pinned at ~0.5 with low variance.
Host-side and cheap; variances use the same unbiased estimator torch does.
Also carries the loss-health heuristics the reference keeps in its UI
(``app_vanilla_gan_signatures.py:309-349``): NaN, explosion, stall.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Tuple

import math


def _var(xs) -> float:
    n = len(xs)
    if n < 2:
        return 0.0
    m = sum(xs) / n
    return sum((x - m) ** 2 for x in xs) / (n - 1)


class ModeCollapseDetector:
    def __init__(self, threshold: float = 0.1, window_size: int = 50):
        self.threshold = threshold
        self.window_size = window_size
        self.g_losses: Deque[float] = deque(maxlen=window_size)
        self.d_fake_outputs: Deque[float] = deque(maxlen=window_size)

    def update(self, g_loss: float, d_fake_mean: float) -> None:
        self.g_losses.append(float(g_loss))
        self.d_fake_outputs.append(float(d_fake_mean))

    def check_collapse(self) -> Tuple[bool, str]:
        if len(self.g_losses) < self.window_size:
            return False, "Insufficient data"
        d_fake_var = _var(self.d_fake_outputs)
        if d_fake_var < self.threshold * 0.1:
            return True, f"D(fake) variance too low: {d_fake_var:.6f}"
        g_mean = sum(self.g_losses) / len(self.g_losses)
        g_var = _var(self.g_losses)
        if g_var < self.threshold and g_mean < 0.5:
            return True, f"G_loss stuck: mean={g_mean:.4f}, var={g_var:.6f}"
        d_mean = sum(self.d_fake_outputs) / len(self.d_fake_outputs)
        if abs(d_mean - 0.5) < 0.05 and d_fake_var < self.threshold:
            return True, f"D(fake) stuck at ~0.5: mean={d_mean:.4f}"
        return False, "Training appears stable"

    def reset(self) -> None:
        self.g_losses.clear()
        self.d_fake_outputs.clear()


def check_loss_health(d_losses: List[float], g_losses: List[float]) -> Dict[str, str]:
    """NaN / explosion / collapse / stall heuristics over recent epoch losses.

    Mirrors the reference UI's ``_check_loss_health`` so any frontend (ours or
    a notebook) can reuse one implementation.
    """
    issues: Dict[str, str] = {}
    recent_d, recent_g = d_losses[-20:], g_losses[-20:]
    if any(math.isnan(x) or math.isinf(x) for x in recent_d + recent_g):
        issues["nan"] = "NaN/Inf detected in losses"
    if recent_g and max(recent_g) > 20.0:
        issues["explosion"] = f"G loss exploding (max {max(recent_g):.1f})"
    if recent_d and sum(recent_d) / len(recent_d) < 0.05:
        issues["d_collapse"] = "D loss ~0: discriminator overpowering generator"
    if len(recent_g) >= 10 and _var(recent_g[-10:]) < 1e-6:
        issues["stall"] = "G loss flat over last 10 epochs"
    return issues
