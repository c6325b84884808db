"""Synthetic signature images (numpy only).

A copy of the JAX package's ``data/synthetic.py`` generator: cursive-like
multi-stroke paths with varying slant, amplitude, loops, stroke count,
thickness and optional underline flourishes, on a white background with
dark ink, float32 (N, size, size, 1) in [-1, 1]. The same seed gives the
same images as the JAX package's ``generate_dataset``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _smooth(v: np.ndarray, k: int) -> np.ndarray:
    """Box-smooth a 1-D path (cheap spline substitute)."""
    if k <= 1:
        return v
    pad = np.pad(v, (k, k), mode="edge")
    ker = np.ones(2 * k + 1) / (2 * k + 1)
    return np.convolve(pad, ker, mode="same")[k:-k]


def _stamp(canvas: np.ndarray, px: np.ndarray, py: np.ndarray,
           ink: np.ndarray) -> None:
    """Bilinear-splat ink along a sampled path."""
    size = canvas.shape[0]
    x0 = np.floor(px).astype(np.int32)
    y0 = np.floor(py).astype(np.int32)
    fx, fy = px - x0, py - y0
    for dy in (0, 1):
        for dx in (0, 1):
            w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy) * ink
            xi = np.clip(x0 + dx, 0, size - 1)
            yi = np.clip(y0 + dy, 0, size - 1)
            np.add.at(canvas, (yi, xi), w)


def make_signature(rs: np.random.RandomState, size: int = 64) -> np.ndarray:
    """One signature image, float32 (size, size, 1) in [-1, 1]."""
    canvas = np.zeros((size, size), np.float32)
    slant = rs.uniform(-0.35, 0.35)           # per-signature shear
    baseline = size * rs.uniform(0.42, 0.58)
    amp = size * rs.uniform(0.10, 0.26)       # vertical letter amplitude
    n_strokes = rs.randint(1, 4)

    for _ in range(n_strokes):
        # A cursive-ish path: oscillating y over monotone x, plus loops.
        n_ctl = rs.randint(6, 14)
        x_start = rs.uniform(0.06, 0.25) * size
        x_end = rs.uniform(0.72, 0.94) * size
        cx = np.sort(rs.uniform(x_start, x_end, n_ctl))
        cy = baseline + rs.uniform(-1.0, 1.0, n_ctl) * amp
        # occasional ascender/descender spikes (letters like l, g, y)
        spikes = rs.rand(n_ctl) < 0.25
        cy[spikes] += rs.choice([-1.0, 1.0], spikes.sum()) * amp * rs.uniform(
            1.2, 2.0, spikes.sum())
        t = np.linspace(0.0, 1.0, n_ctl)
        tt = np.linspace(0.0, 1.0, 60 * n_ctl)
        px = _smooth(np.interp(tt, t, cx), 25)
        py = _smooth(np.interp(tt, t, cy), 25)
        # loops: superimpose a small rotating component
        if rs.rand() < 0.6:
            freq = rs.uniform(2.0, 6.0) * np.pi
            phase = rs.uniform(0, 2 * np.pi)
            r = rs.uniform(0.05, 0.16) * size
            px = px + r * np.cos(freq * tt + phase) * tt * (1 - tt) * 4
            py = py + r * np.sin(freq * tt + phase) * tt * (1 - tt) * 4
        px = px + slant * (baseline - py)      # shear
        ink = np.full(px.shape, rs.uniform(0.10, 0.22), np.float32)
        # pen pressure variation along the stroke
        ink *= 0.7 + 0.3 * np.abs(np.sin(tt * rs.uniform(4, 12)))
        # pen width: splat the nib at sub-pixel offsets for thicker lines
        width = rs.uniform(0.3, 0.8)
        for ox, oy in ((0.0, 0.0), (width, 0.0), (0.0, width)):
            _stamp(canvas, px + ox, py + oy, ink)

    # underline flourish
    if rs.rand() < 0.35:
        tt = np.linspace(0.0, 1.0, 240)
        ux = (0.15 + 0.7 * tt) * size
        uy = baseline + amp * rs.uniform(1.1, 1.6) + np.sin(
            tt * np.pi * rs.uniform(1, 2)) * rs.uniform(0.5, 2.0)
        for oy in (0.0, 0.6):
            _stamp(canvas, ux, uy + oy, np.full(ux.shape, 0.25, np.float32))

    # light blur for anti-aliased pen edges (3-tap separable)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    canvas = np.apply_along_axis(
        lambda r: np.convolve(r, k, mode="same"), 0, canvas)
    canvas = np.apply_along_axis(
        lambda r: np.convolve(r, k, mode="same"), 1, canvas)
    ink01 = np.clip(canvas, 0.0, 1.0) ** rs.uniform(0.7, 1.0)
    img = 1.0 - 2.0 * ink01                   # white bg (+1) .. black ink (-1)
    return img.astype(np.float32)[..., None]


def generate_dataset(n: int, size: int = 64, seed: int = 0) -> np.ndarray:
    """(n, size, size, 1) float32 in [-1, 1], deterministic in ``seed``;
    the first k images are the same for every n >= k."""
    rs = np.random.RandomState(seed)
    return np.stack([make_signature(rs, size) for _ in range(n)])


def save_dataset_pngs(n: int, output_dir: str | Path, size: int = 64,
                      seed: int = 0) -> Path:
    """Write ``generate_dataset(n, size, seed)`` as ``sig_{i:06d}.png``."""
    from siggan_tpu_torch.infer.export import save_pngs
    out = Path(output_dir)
    save_pngs(generate_dataset(n, size, seed), out, prefix="sig")
    return out
