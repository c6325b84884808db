"""Pillow's 8-bit bilinear resize, in numpy.

The JAX package resizes grayscale images with PIL's ``Image.resize(size,
Image.BILINEAR)`` (its ``data/dataset.py::decode_image`` and
``cli/preprocess.py::load_canvas``). The port has no imaging package, so
``resize_bilinear`` reproduces Pillow's ``L``-mode resample
(``libImaging/Resample.c``) bit for bit:

- per output pixel, the triangle filter's taps over the input span
  ``center +- support`` (``support`` = 1 widened by the scale on a
  downscale), the weights in float64 normalized by their sequential sum,
  then rounded to fixed point with 22 fraction bits;
- a horizontal pass, then a vertical pass over its output, each an integer
  dot product plus half an output step, shifted down and clamped to
  [0, 255], so the intermediate image is rounded to uint8 between the passes;
- a pass whose size is unchanged is skipped, as Pillow skips it.
"""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """(xmin (out,), taps (out, ksize) int64 fixed point) of one axis;
    taps past an output's span are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize, dtype=np.int64)
    live = x[None, :] < xmax[:, None]
    arg = ((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)
    w = np.where(live, np.maximum(1.0 - np.abs(arg), 0.0), 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):          # Pillow's sequential sum, not numpy's pairwise one
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << PRECISION_BITS)
    taps = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one)).astype(np.int64)
    return xmin, taps


def _pass(img: np.ndarray, out_size: int) -> np.ndarray:
    """Resample the last axis of uint8 ``img`` to ``out_size``."""
    in_size = img.shape[-1]
    xmin, taps = _coefficients(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(taps.shape[1])[None, :], in_size - 1)
    acc = (img[..., idx].astype(np.int64) * taps).sum(axis=-1) + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W) -> uint8 (height, width), equal to PIL's
    ``Image.fromarray(img).resize((width, height), Image.BILINEAR)``."""
    a = np.asarray(img, np.uint8)
    if a.ndim != 2:
        raise ValueError(f"resize_bilinear takes one (H, W) image, got {a.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"cannot resize to {width} x {height}")
    if a.shape[1] != width:
        a = _pass(a, width)
    if a.shape[0] != height:
        a = _pass(a.T, height).T
    return np.ascontiguousarray(a)
