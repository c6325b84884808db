"""Signature preprocessing on the device, batched.

Port of the JAX package's ``data/preprocess.py``: raw scans, decoded on the
host onto a fixed white (N, H, W) canvas with each image's true (h, w),
become training images in one batched pass of tensor ops:
grayscale canvas -> Gaussian blur 3 x 3 + morphological opening (2 x 2
ellipse) -> validity (white / ink ratios) -> dark-pixel bounding box with a
margin -> crop + aspect-preserving exact box-filter resize + centred pad
(one resampler over the integral image) -> integer centre-of-mass shift with
white fill -> CLAHE (clip 2.0, 8 x 8 tiles) or Gaussian adaptive
binarization -> [-1, 1]. Every per-image scalar (the bounding box, the
scale, ``new_w``/``new_h``, the centre-of-mass shift) stays a tensor, so a
batch runs without a host sync per image.

Numerics: f32 as in JAX, with two exceptions, both more exact than JAX's
f32 and the same on every device: the integral image (and the box sums
read from it) is float64, since its values reach 255 * 512 * 512 = 6.7e7,
past f32's 2^24, where JAX's f32 cumsum rounds; and the centre of mass is
summed in float64. The per-image scalars and sample positions follow JAX's
f32 arithmetic op for op, every division by a device tensor (a CUDA
division by a host scalar multiplies by its reciprocal). CLAHE's
histograms, clipped CDFs and lookup tables are exact integers or
multiples of 1/256, equal in both packages. JAX's deviations from cv2
stay (edge-replicate borders, one-pass CLAHE redistribution, the opening
in place of the contour-area filter).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

TARGET_SIZE = 64
MARGIN = 5
BINARY_THRESHOLD = 127
MAX_NOISE_RATIO = 0.95
MIN_INK_RATIO = 0.01
CLAHE_CLIP = 2.0
CLAHE_GRID = 8


def _f(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Small separable filters
# ---------------------------------------------------------------------------

def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    return F.pad(x[:, None], (left, right, top, bottom), mode="replicate")[:, 0]


def _sep_filter(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 2-D filter with edge-replicate borders. x: (N, H, W) f32;
    the taps summed in JAX's order."""
    n_k = k.shape[0]
    r = n_k // 2
    h, w = x.shape[1:]
    xp = _pad_edge(x, r, n_k - 1 - r, 0, 0)
    acc = xp[:, 0:h] * k[0]
    for i in range(1, n_k):
        acc = acc + xp[:, i:i + h] * k[i]
    xp = _pad_edge(acc, 0, 0, r, n_k - 1 - r)
    out = xp[:, :, 0:w] * k[0]
    for i in range(1, n_k):
        out = out + xp[:, :, i:i + w] * k[i]
    return out


def gaussian_blur3(x: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(k=3, sigma=0): the fixed [1, 2, 1] / 4 kernel."""
    return _sep_filter(x, torch.tensor([0.25, 0.5, 0.25], device=x.device))


_ELLIPSE2_OFFSETS = ((-1, 0), (0, -1), (0, 0))


def _morph2(x: torch.Tensor, reduce) -> torch.Tensor:
    """cv2 erode/dilate with the 2 x 2 ellipse element: ``reduce`` over the
    offsets {(-1, 0), (0, -1), (0, 0)} with replicate borders."""
    h, w = x.shape[1:]
    xp = _pad_edge(x, 1, 1, 1, 1)
    return reduce(torch.stack([xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                               for dy, dx in _ELLIPSE2_OFFSETS]), dim=0)


def morph_open2(x: torch.Tensor) -> torch.Tensor:
    """Opening (erode, then dilate) with cv2's 2 x 2 ellipse element."""
    return _morph2(_morph2(x, torch.amin), torch.amax)


def remove_noise(x: torch.Tensor) -> torch.Tensor:
    return morph_open2(gaussian_blur3(x))


# ---------------------------------------------------------------------------
# Validity and bounding box
# ---------------------------------------------------------------------------

def _inside(x: torch.Tensor, true_hw: torch.Tensor):
    ys = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)[None, :, None]
    xs = torch.arange(x.shape[2], device=x.device, dtype=torch.int32)[None, None, :]
    h = true_hw[:, 0, None, None].to(torch.int32)
    w = true_hw[:, 1, None, None].to(torch.int32)
    return ys, xs, (ys < h) & (xs < w)


def is_valid_signature(x: torch.Tensor, true_hw: torch.Tensor) -> torch.Tensor:
    """x: (N, H, W) canvases in [0, 255]; true_hw: (N, 2) extents -> (N,) bool."""
    _, _, inside = _inside(x, true_hw)
    total = (true_hw[:, 0].to(torch.int32) * true_hw[:, 1].to(torch.int32)).float()
    white = ((x > BINARY_THRESHOLD) & inside).float().sum(dim=(1, 2))
    white_ratio = white / total
    ink_ratio = _f(1.0, x) - white_ratio
    return (white_ratio <= _f(MAX_NOISE_RATIO, x)) & (ink_ratio >= _f(MIN_INK_RATIO, x))


def find_bbox(x: torch.Tensor, true_hw: torch.Tensor, margin: int = MARGIN) -> torch.Tensor:
    """Dark-pixel bbox with margin, clamped to the true extent: (N, 4) f32
    (x0, y0, w, h); the full extent where an image has no dark pixel."""
    ys, xs, inside = _inside(x, true_hw)
    dark = (x <= BINARY_THRESHOLD) & inside
    any_dark = dark.flatten(1).any(dim=1)
    big = torch.full((), 1 << 20, dtype=torch.int32, device=x.device)
    neg = torch.full((), -1, dtype=torch.int32, device=x.device)
    y0 = torch.where(dark, ys, big).amin(dim=(1, 2))
    y1 = torch.where(dark, ys, neg).amax(dim=(1, 2))
    x0 = torch.where(dark, xs, big).amin(dim=(1, 2))
    x1 = torch.where(dark, xs, neg).amax(dim=(1, 2))
    h = true_hw[:, 0].to(torch.int32)
    w = true_hw[:, 1].to(torch.int32)
    x0 = torch.clamp(x0 - margin, min=0)
    y0 = torch.clamp(y0 - margin, min=0)
    bw = torch.minimum(w - x0, (x1 - x0 + 1) + margin)
    bh = torch.minimum(h - y0, (y1 - y0 + 1) + margin)
    bbox = torch.stack([x0, y0, bw, bh], dim=1).float()
    full = torch.stack([torch.zeros_like(w), torch.zeros_like(h), w, h], dim=1).float()
    return torch.where(any_dark[:, None], bbox, full)


# ---------------------------------------------------------------------------
# Fused crop + aspect-resize + pad by exact integral-image box filtering
# ---------------------------------------------------------------------------

def _integral(x: torch.Tensor) -> torch.Tensor:
    """S[n, i, j] = sum of x[n, :i, :j] in float64; (N, H+1, W+1)."""
    s = torch.cumsum(torch.cumsum(x.double(), dim=1), dim=2)
    return F.pad(s, (1, 0, 1, 0))


def _sample_bilinear(S: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear taps of the (piecewise-bilinear) integral image at f32
    positions (N, P, Q); the weights in f32 as JAX computes them, the sum
    in float64."""
    hp, wp = S.shape[1], S.shape[2]
    y0 = torch.clamp(torch.floor(ys), 0, hp - 2).to(torch.int64)
    x0 = torch.clamp(torch.floor(xs), 0, wp - 2).to(torch.int64)
    fy = (torch.clamp(ys, 0, hp - 1) - y0.float()).double()
    fx = (torch.clamp(xs, 0, wp - 1) - x0.float()).double()
    n = torch.arange(S.shape[0], device=S.device)[:, None, None]
    v00, v01 = S[n, y0, x0], S[n, y0, x0 + 1]
    v10, v11 = S[n, y0 + 1, x0], S[n, y0 + 1, x0 + 1]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def crop_resize_pad(x: torch.Tensor, bbox: torch.Tensor, out_size: int = TARGET_SIZE,
                    pad_value: float = 255.0) -> torch.Tensor:
    """Resample each bbox to a centred (out_size, out_size) image (exact
    box filter, aspect kept), the rest ``pad_value``. x: (N, H, W), bbox
    (N, 4) f32 -> (N, out_size, out_size) f32."""
    bx, by, bw, bh = (bbox[:, i] for i in range(4))
    osz = _f(float(out_size), x)
    scale = torch.minimum(osz / bw, osz / bh)
    new_w = torch.clamp(torch.floor(bw * scale).to(torch.int32), min=1)
    new_h = torch.clamp(torch.floor(bh * scale).to(torch.int32), min=1)
    ox = torch.div(out_size - new_w, 2, rounding_mode="floor")
    oy = torch.div(out_size - new_h, 2, rounding_mode="floor")

    S = _integral(x)
    j = torch.arange(out_size, device=x.device, dtype=torch.int32)
    stepx = (bw / new_w.float())[:, None, None]
    stepy = (bh / new_h.float())[:, None, None]
    # Output pixel k covers the source span [b + (k - o) * step, ... + step).
    sx0 = bx[:, None, None] + (j[None, None, :] - ox[:, None, None]).float() * stepx
    sx1 = sx0 + stepx
    sy0 = by[:, None, None] + (j[None, :, None] - oy[:, None, None]).float() * stepy
    sy1 = sy0 + stepy
    shape = (x.shape[0], out_size, out_size)
    sx0, sx1, sy0, sy1 = (t.expand(shape) for t in (sx0, sx1, sy0, sy1))
    area = (sx1 - sx0) * (sy1 - sy0)
    box = (_sample_bilinear(S, sy1, sx1) - _sample_bilinear(S, sy0, sx1)
           - _sample_bilinear(S, sy1, sx0) + _sample_bilinear(S, sy0, sx0))
    out = (box / area.double()).float()
    jx, jy = j[None, None, :], j[None, :, None]
    inside = ((jx >= ox[:, None, None]) & (jx < (ox + new_w)[:, None, None])
              & (jy >= oy[:, None, None]) & (jy < (oy + new_h)[:, None, None]))
    return torch.where(inside, out, _f(pad_value, x))


# ---------------------------------------------------------------------------
# Centre-of-mass recentring
# ---------------------------------------------------------------------------

def center_signature(x: torch.Tensor) -> torch.Tensor:
    """Integer shift of each image's ink (inverted) centre of mass to the
    centre, white fill; (N, H, W)."""
    n_, h, w = x.shape
    inv = (255.0 - x.double())
    m00 = inv.sum(dim=(1, 2))
    ys = torch.arange(h, device=x.device, dtype=torch.float64)[None, :, None]
    xs = torch.arange(w, device=x.device, dtype=torch.float64)[None, None, :]
    safe = torch.where(m00 > 0, m00, torch.ones_like(m00))
    cx = torch.where(m00 > 0, (inv * xs).sum(dim=(1, 2)) / safe, torch.full_like(m00, w / 2))
    cy = torch.where(m00 > 0, (inv * ys).sum(dim=(1, 2)) / safe, torch.full_like(m00, h / 2))
    sx = w // 2 - cx.to(torch.int64)
    sy = h // 2 - cy.to(torch.int64)
    # JAX slices the white-padded (3h, 3w) image at (h - sy, w - sx),
    # its start clamped into range.
    src_y = torch.clamp(h - sy, 0, 2 * h)[:, None] + torch.arange(h, device=x.device)[None] - h
    src_x = torch.clamp(w - sx, 0, 2 * w)[:, None] + torch.arange(w, device=x.device)[None] - w
    ok = (((src_y >= 0) & (src_y < h))[:, :, None] & ((src_x >= 0) & (src_x < w))[:, None, :])
    n = torch.arange(n_, device=x.device)[:, None, None]
    g = x[n, src_y.clamp(0, h - 1)[:, :, None], src_x.clamp(0, w - 1)[:, None, :]]
    return torch.where(ok, g, _f(255.0, x))


# ---------------------------------------------------------------------------
# CLAHE (cv2.createCLAHE(2.0, (8, 8)))
# ---------------------------------------------------------------------------

def clahe(x: torch.Tensor, clip_limit: float = CLAHE_CLIP,
          grid: int = CLAHE_GRID) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of (N, H, W) in
    [0, 255], H and W divisible by ``grid``: per-tile 256-bin histograms,
    clipped with the excess spread over all bins in one pass, LUT =
    round(cdf * 255 / npix), bilinearly blended between the four nearest
    tiles' LUTs."""
    n_, h, w = x.shape
    th, tw = h // grid, w // grid
    npix = th * tw
    xi = torch.clamp(torch.round(x), 0, 255).to(torch.int64)
    tiles = xi.reshape(n_, grid, th, grid, tw).permute(0, 1, 3, 2, 4).reshape(-1, npix)
    hist = torch.zeros(tiles.shape[0], 256, device=x.device).scatter_add_(
        1, tiles, torch.ones(tiles.shape, device=x.device))
    hist = hist.reshape(n_, grid, grid, 256)
    limit = _f(max(1.0, clip_limit * npix / 256.0), x)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / _f(256.0, x)
    cdf = torch.cumsum(hist, dim=-1)
    luts = torch.round(cdf * _f(255.0 / npix, x))          # (N, g, g, 256)

    def axis(size: int, tile: int):
        t = torch.arange(size, device=x.device, dtype=torch.float32) + 0.5
        t = t / _f(float(tile), x) - 0.5
        t0 = torch.clamp(torch.floor(t), 0, grid - 1).to(torch.int64)
        t1 = torch.clamp(t0 + 1, 0, grid - 1)
        return t0, t1, torch.clamp(t - t0.float(), 0.0, 1.0)

    ty0, ty1, fy = axis(h, th)
    tx0, tx1, fx = axis(w, tw)
    fy, fx = fy[None, :, None], fx[None, None, :]
    n = torch.arange(n_, device=x.device)[:, None, None]

    def lut_at(tyi, txi):
        return luts[n, tyi[None, :, None], txi[None, None, :], xi]

    out = (lut_at(ty0, tx0) * (1 - fy) * (1 - fx) + lut_at(ty0, tx1) * (1 - fy) * fx
           + lut_at(ty1, tx0) * fy * (1 - fx) + lut_at(ty1, tx1) * fy * fx)
    return torch.clamp(out, 0.0, 255.0)


# ---------------------------------------------------------------------------
# Binarization and normalization
# ---------------------------------------------------------------------------

def adaptive_binarize(x: torch.Tensor, block: int = 11, c: float = 2.0) -> torch.Tensor:
    """cv2.adaptiveThreshold(GAUSSIAN_C, THRESH_BINARY, 11, 2): 255 where
    the pixel > its Gaussian-weighted mean - C (sigma 2.0), else 0."""
    r = block // 2
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-(t ** 2) / _f(2 * 2.0 ** 2, x))
    k = k / torch.sum(k)
    mean = _sep_filter(x, k)
    return torch.where(x > mean - _f(c, x), _f(255.0, x), _f(0.0, x))


def threshold_binarize(x: torch.Tensor, thresh: float = BINARY_THRESHOLD) -> torch.Tensor:
    return torch.where(x > thresh, _f(255.0, x), _f(0.0, x))


def normalize_pixels(x: torch.Tensor, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    y = (x.float() / _f(255.0, x)) * (hi - lo) + lo
    return torch.clamp(y, lo, hi)


def denormalize_pixels(x: torch.Tensor, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    y = (x - lo) / _f(hi - lo, x) * 255.0
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def preprocess_batch(canvases: torch.Tensor, true_hws: torch.Tensor, *,
                     target_size: int = TARGET_SIZE, binarize: bool = False,
                     normalize: bool = True, remove_margin: bool = True,
                     center: bool = True, denoise: bool = True,
                     validate: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) canvases in [0, 255] + (N, 2) true extents (h, w) on one
    device -> ((N, t, t) images, (N,) valid), the JAX package's
    ``preprocess_batch_device`` (step order of its ``preprocess_one``)."""
    x = canvases.float()
    if denoise:
        x = remove_noise(x)
    valid = (is_valid_signature(x, true_hws) if validate
             else torch.ones(x.shape[0], dtype=torch.bool, device=x.device))
    if remove_margin:
        bbox = find_bbox(x, true_hws)
    else:
        z = torch.zeros_like(true_hws[:, 0])
        bbox = torch.stack([z, z, true_hws[:, 1], true_hws[:, 0]], dim=1).float()
    x = crop_resize_pad(x, bbox, target_size)
    if center:
        x = center_signature(x)
    x = adaptive_binarize(x) if binarize else clahe(x)
    if normalize:
        x = normalize_pixels(x)
    return x, valid


def preprocess_one(canvas: torch.Tensor, true_hw: torch.Tensor, **flags
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (H, W) canvas and its (2,) extent -> ((t, t) image, valid)."""
    img, valid = preprocess_batch(canvas[None], true_hw[None], **flags)
    return img[0], valid[0]
