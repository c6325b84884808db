"""DiffAugment: differentiable augmentation of every discriminator input.

Port of the JAX package's ``ops/diffaug.py`` (Zhao et al. 2020): the same
policy transforms reals and fakes right before each D forward, the one
inside the G step too, so the generator's gradient flows through it.

The work is split as ``data/augment.py`` splits it: ``draw`` makes each
image's parameters from a ``torch.Generator`` (brightness and contrast for
``color``, the grid shifts ``tr``, ``tc`` for ``translation``, the box
offsets ``oy``, ``ox`` for ``cutout``), and ``apply`` is the differentiable
transform that takes them. The train step draws outside the step (a CUDA
graph of it reads the draws from buffers), and tests inject the JAX
package's draws.

The geometry is the JAX package's. Spatial policies act on the 2x2 grid
(rows = H/2, cols = W/2 canonical pixel pairs) in both layouts, so the
parameters do not depend on the layout and packed(T(x)) == T(packed(x)):
shifts of up to ``max(int(rows*0.125), 1)`` grid units, padded with +1
(white) in ``x``'s dtype; a cutout box of side ``max(int(rows*0.5), 1)``
at offsets in ``[-(side//2), rows-side+side//2]`` (it may hang off the
edges), written as 0; ``color`` shifts by b in [-0.5, 0.5) and scales by c
in [0.5, 1.5) about the image mean, taken in f32 and cast back, the rest in
``x``'s dtype.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

TRANSLATION_RATIO = 0.125
CUTOUT_RATIO = 0.5
POLICIES = ("color", "translation", "cutout")

Params = Tuple[torch.Tensor, torch.Tensor]


def policies(policy: str) -> List[str]:
    """The comma-separated policy's names, in order; raises on an unknown one."""
    names = [p.strip() for p in policy.split(",") if p.strip()]
    for name in names:
        if name not in POLICIES:
            raise ValueError(f"unknown diffaugment policy {name!r} (have {sorted(POLICIES)})")
    return names


def _budget(rows: int, cols: int, ratio: float) -> Tuple[int, int]:
    return max(int(rows * ratio), 1), max(int(cols * ratio), 1)


def draw(policy: str, n: int, image_size: int, gen: torch.Generator, device=None,
         out: Optional[Sequence[Params]] = None) -> List[Params]:
    """Per policy, in order, the (n,) parameters of ``n`` images: color
    (brightness f32, contrast f32), translation (tr, tc int64), cutout (oy,
    ox int64). ``out``, a list of the same structure, receives them in
    place."""
    rows = cols = image_size // 2       # the 2x2 grid the spatial policies act on
    params: List[Params] = []
    for j, name in enumerate(policies(policy)):
        dst = None if out is None else out[j]
        if name == "color":
            lo_hi = ((-0.5, 0.5), (0.5, 1.5))
        elif name == "translation":
            m_r, m_c = _budget(rows, cols, TRANSLATION_RATIO)
            lo_hi = ((-m_r, m_r + 1), (-m_c, m_c + 1))
        else:
            ch, cw = _budget(rows, cols, CUTOUT_RATIO)
            lo_hi = ((-(ch // 2), rows - ch + ch // 2 + 1), (-(cw // 2), cols - cw + cw // 2 + 1))
        pair = []
        for k, (lo, hi) in enumerate(lo_hi):
            if name == "color":
                t = (torch.rand((n,), generator=gen, device=device) if dst is None
                     else torch.rand((n,), generator=gen, out=dst[k]))
                t = t.mul_(hi - lo).add_(lo)
            else:
                t = (torch.randint(lo, hi, (n,), generator=gen, device=device) if dst is None
                     else torch.randint(lo, hi, (n,), generator=gen, out=dst[k]))
            pair.append(t)
        params.append(tuple(pair))
    return params


def _to_grid(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), the grid form the spatial ops act on."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // 2, w // 2, 4 * c)


def _from_grid(g: torch.Tensor, c: int) -> torch.Tensor:
    n, rows, cols, _ = g.shape
    return g.reshape(n, rows, cols, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        n, 2 * rows, 2 * cols, c)


def color(x: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor) -> torch.Tensor:
    """Per-image brightness shift and contrast scale about the image mean."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    b = brightness.to(x.dtype).reshape(shape)
    c = contrast.to(x.dtype).reshape(shape)
    mean = x.float().mean(dim=tuple(range(1, x.ndim)), keepdim=True).to(x.dtype)
    return (x - mean) * c + mean + b


def translation(x: torch.Tensor, tr: torch.Tensor, tc: torch.Tensor,
                packed: bool) -> torch.Tensor:
    """Per-image shift by (tr, tc) grid units, padded with +1."""
    gx = x if packed else _to_grid(x)
    n, rows, cols, c4 = gx.shape
    m_r, m_c = _budget(rows, cols, TRANSLATION_RATIO)
    gp = F.pad(gx, (0, 0, m_c, m_c, m_r, m_r), value=1.0)
    iy = torch.arange(rows, device=x.device)[None, :] + m_r - tr[:, None]
    gy = torch.gather(gp, 1, iy[:, :, None, None].expand(n, rows, cols + 2 * m_c, c4))
    ix = torch.arange(cols, device=x.device)[None, :] + m_c - tc[:, None]
    gt = torch.gather(gy, 2, ix[:, None, :, None].expand(n, rows, cols, c4))
    return gt if packed else _from_grid(gt, x.shape[-1])


def cutout(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, packed: bool) -> torch.Tensor:
    """Per-image square box at (oy, ox) grid units set to 0."""
    rows, cols = (x.shape[1], x.shape[2]) if packed else (x.shape[1] // 2, x.shape[2] // 2)
    ch, cw = _budget(rows, cols, CUTOUT_RATIO)
    ry = torch.arange(rows, device=x.device)[None, :]
    rx = torch.arange(cols, device=x.device)[None, :]
    in_y = (ry >= oy[:, None]) & (ry < oy[:, None] + ch)
    in_x = (rx >= ox[:, None]) & (rx < ox[:, None] + cw)
    cut = in_y[:, :, None] & in_x[:, None, :]
    if not packed:
        cut = cut.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    one, zero = torch.ones((), dtype=x.dtype, device=x.device), torch.zeros(
        (), dtype=x.dtype, device=x.device)
    return x * torch.where(cut[..., None], zero, one)


def apply(x: torch.Tensor, params: Sequence[Params], policy: str,
          packed: bool) -> torch.Tensor:
    """The comma-separated ``policy`` on a batch with its drawn ``params``
    (``draw``'s list); differentiable; identity when ``policy`` is ""."""
    names = policies(policy)
    if len(names) != len(params):
        raise ValueError(f"{len(params)} parameter sets for the policy {policy!r}")
    fns = {"color": lambda t, p: color(t, *p),
           "translation": lambda t, p: translation(t, *p, packed),
           "cutout": lambda t, p: cutout(t, *p, packed)}
    for name, p in zip(names, params):
        x = fns[name](x, p)
    return x
