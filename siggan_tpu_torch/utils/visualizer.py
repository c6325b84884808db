"""Image conversion and grids (numpy only), the sample-grid writer, and
the multi-run metric chart, drawn with numpy and encoded by the port's own
PNG encoder (no plotting or imaging package)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

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


# A 3 x 5 bitmap font for the chart's labels: each glyph five rows of three
# pixels; capitals are drawn as their small letters, unknown characters as a
# block.
_GLYPHS = {
    "0": "###,#.#,#.#,#.#,###", "1": ".#.,##.,.#.,.#.,###", "2": "###,..#,###,#..,###",
    "3": "###,..#,.##,..#,###", "4": "#.#,#.#,###,..#,..#", "5": "###,#..,###,..#,###",
    "6": "###,#..,###,#.#,###", "7": "###,..#,..#,.#.,.#.", "8": "###,#.#,###,#.#,###",
    "9": "###,#.#,###,..#,###", "a": ".#.,#.#,###,#.#,#.#", "b": "##.,#.#,##.,#.#,##.",
    "c": ".##,#..,#..,#..,.##", "d": "##.,#.#,#.#,#.#,##.", "e": "###,#..,##.,#..,###",
    "f": "###,#..,##.,#..,#..", "g": ".##,#..,#.#,#.#,.##", "h": "#.#,#.#,###,#.#,#.#",
    "i": "###,.#.,.#.,.#.,###", "j": "..#,..#,..#,#.#,.#.", "k": "#.#,#.#,##.,#.#,#.#",
    "l": "#..,#..,#..,#..,###", "m": "#.#,###,###,#.#,#.#", "n": "##.,#.#,#.#,#.#,#.#",
    "o": ".#.,#.#,#.#,#.#,.#.", "p": "##.,#.#,##.,#..,#..", "q": ".#.,#.#,#.#,##.,.##",
    "r": "##.,#.#,##.,#.#,#.#", "s": ".##,#..,.#.,..#,##.", "t": "###,.#.,.#.,.#.,.#.",
    "u": "#.#,#.#,#.#,#.#,###", "v": "#.#,#.#,#.#,#.#,.#.", "w": "#.#,#.#,###,###,#.#",
    "x": "#.#,#.#,.#.,#.#,#.#", "y": "#.#,#.#,.#.,.#.,.#.", "z": "###,..#,.#.,#..,###",
    "-": "...,...,###,...,...", "_": "...,...,...,...,###", ".": "...,...,...,...,.#.",
    ":": "...,.#.,...,.#.,...", "+": "...,.#.,###,.#.,...", " ": "...,...,...,...,...",
}
_BLOCK = "###,###,###,###,###"
# matplotlib's default colour cycle (tab10), one colour a run.
_COLOURS = np.array([(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
                     (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
                     (188, 189, 34), (23, 190, 207)], np.uint8)


def _text(img: np.ndarray, x: int, y: int, text: str, scale: int = 2,
          colour=(0, 0, 0)) -> int:
    """Draw ``text`` with its top-left corner at (x, y); returns its width."""
    for k, ch in enumerate(text):
        rows = _GLYPHS.get(ch.lower(), _BLOCK).split(",")
        x0 = x + 4 * scale * k
        for r, row in enumerate(rows):
            for c, bit in enumerate(row):
                if bit == "#":
                    img[y + r * scale:y + (r + 1) * scale,
                        x0 + c * scale:x0 + (c + 1) * scale] = colour
    return 4 * scale * len(text)


def _line(img: np.ndarray, x0: float, y0: float, x1: float, y1: float, colour,
          width: int = 2) -> None:
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    h, w = img.shape[:2]
    for dy in range(width):
        for dx in range(width):
            img[np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)] = colour


def _tick(v: float) -> str:
    return f"{v:.3g}"


def plot_run_comparison(runs: Dict[str, List[Dict]], path: str | Path,
                        key: str = "g_loss") -> Optional[Path]:
    """One metric of several runs against the epoch, as a PNG: a polyline
    a run in its own colour, the axes with the epoch and value ranges, the
    metric's name, and a legend strip of the runs' colours and names under
    the axes (the JAX package's chart, drawn without matplotlib). None when
    ``runs`` is empty."""
    if not runs:
        return None
    width, height = 880, 495
    left, right, top = 80, width - 24, 24
    legend_rows = -(-len(runs) // 3)
    bottom = height - 64 - 22 * legend_rows
    img = np.full((height, width, 3), 255, np.uint8)
    series = {name: ([m["epoch"] for m in ms if key in m], [m[key] for m in ms if key in m])
              for name, ms in runs.items()}
    xs = [x for sx, _ in series.values() for x in sx]
    ys = [y for _, sy in series.values() for y in sy]
    x_lo, x_hi = (min(xs), max(xs)) if xs else (0, 1)
    y_lo, y_hi = (min(ys), max(ys)) if ys else (0, 1)
    x_hi = x_hi if x_hi > x_lo else x_lo + 1
    pad = 0.05 * (y_hi - y_lo) if y_hi > y_lo else 0.5
    y_lo, y_hi = y_lo - pad, y_hi + pad

    def px(x, y):
        return (left + (x - x_lo) / (x_hi - x_lo) * (right - left),
                bottom - (y - y_lo) / (y_hi - y_lo) * (bottom - top))
    grid = (225, 225, 225)
    for f in (0.25, 0.5, 0.75):
        _line(img, left, top + f * (bottom - top), right, top + f * (bottom - top), grid, 1)
        _line(img, left + f * (right - left), top, left + f * (right - left), bottom, grid, 1)
    _line(img, left, top, left, bottom, (0, 0, 0))
    _line(img, left, bottom, right, bottom, (0, 0, 0))
    _line(img, left, top, right, top, (0, 0, 0), 1)
    _line(img, right, top, right, bottom, (0, 0, 0), 1)
    for i, (name, (sx, sy)) in enumerate(series.items()):
        colour = _COLOURS[i % len(_COLOURS)]
        pts = [px(x, y) for x, y in zip(sx, sy)]
        for (xa, ya), (xb, yb) in zip(pts, pts[1:]):
            _line(img, xa, ya, xb, yb, colour)
        for xa, ya in pts:
            _line(img, xa - 2, ya - 2, xa - 2, ya + 2, colour, 5)
    for v in (y_lo + pad, y_hi - pad):
        label = _tick(v)
        _text(img, left - 8 - 8 * len(label), int(px(x_lo, v)[1]) - 5, label)
    for v in (x_lo, x_hi):
        label = _tick(v)
        _text(img, int(px(v, y_lo)[0]) - 4 * len(label), bottom + 8, label)
    _text(img, (left + right) // 2 - 20, bottom + 26, "epoch")
    _text(img, 8, top, key)
    for i, name in enumerate(series):
        x = left + (i % 3) * ((right - left) // 3)
        y = bottom + 52 + 22 * (i // 3)
        img[y:y + 10, x:x + 24] = _COLOURS[i % len(_COLOURS)]
        _text(img, x + 32, y, name[:24])
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    from siggan_tpu_torch.infer.export import encode_png   # export imports this module
    path.write_bytes(encode_png(img))
    return path
