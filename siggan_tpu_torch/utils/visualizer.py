"""Image conversion and grids (numpy only), and the sample-grid writer."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float (N, H, W, C) -> uint8 (N, H, W, C)."""
    x = (np.asarray(images, np.float32) + 1.0) * 127.5
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: int = 255) -> np.ndarray:
    """(N, H, W, C) uint8 -> (gh, gw, C) uint8 grid, white gutters."""
    n, h, w, c = images.shape
    nrows = (n + nrow - 1) // nrow
    grid = np.full((nrows * (h + padding) + padding,
                    nrow * (w + padding) + padding, c), pad_value, np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_sample_grid(images: np.ndarray, path: str | Path, nrow: int = 8,
                     denormalize: bool = True) -> Path:
    """A grid of samples as one PNG (the JAX package's
    ``utils/visualizer.py:55-59``), through the port's PNG encoder."""
    from siggan_tpu_torch.infer.export import contact_sheet   # export imports this module
    return contact_sheet(images, path, nrow=nrow, denormalize=denormalize)
