"""Image conversion and grids (numpy only), the sample-grid writer, and
the JAX package's figures (``utils/visualizer.py``): real against fake
panels, interpolation strips, loss curves, the training GIF, the progress
montage and the multi-run chart, drawn with numpy (``Chart``, a 3 x 5
bitmap font) and encoded by the port's own PNG and GIF encoders (no
plotting or imaging package)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

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
          width: int = 2, dash: int = 0) -> None:
    """A segment ``width`` px thick (to the right and down of the path),
    dashed every ``dash`` px when ``dash`` > 0."""
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    if dash:
        on = (np.arange(n) // dash) % 2 == 0
        xs, ys = xs[on], ys[on]
    h, w = img.shape[:2]
    for dy in range(width):
        for dx in range(width):
            img[np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)] = colour


def _tick(v: float) -> str:
    return f"{v:.3g}"


def _text_vertical(img: np.ndarray, x: int, y: int, text: str, scale: int = 2,
                   colour=(0, 0, 0)) -> None:
    """Draw ``text`` turned a quarter to the left (read bottom to top), its
    bounding box's top-left corner at (x, y), clipped to the image."""
    strip = np.full((5 * scale, 4 * scale * len(text), 3), 255, np.uint8)
    _text(strip, 0, 0, text, scale, colour)
    strip = np.rot90(strip)
    h, w = img.shape[:2]
    hh, ww = min(strip.shape[0], h - y), min(strip.shape[1], w - x)
    if hh > 0 and ww > 0:
        ink = (strip[:hh, :ww] != 255).any(-1)
        img[y:y + hh, x:x + ww][ink] = strip[:hh, :ww][ink]


def _write_png(img: np.ndarray, path: str | Path) -> Path:
    from siggan_tpu_torch.infer.export import encode_png   # export imports this module
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(img))
    return path


class Chart:
    """One chart panel drawn with numpy: a white (height, width, 3) image,
    an axes box with its range labels, and ``px``, the map from data to
    pixels that every mark goes through (log10 on a ``log`` axis). The
    charts of the JAX package's matplotlib figures are drawn on these at
    the figures' pixel sizes (inches x 110 dpi)."""

    def __init__(self, x_range, y_range, width: int = 880, height: int = 495, *,
                 log_x: bool = False, log_y: bool = False, title: str = "",
                 x_label: str = "", y_label: str = "", legend_rows: int = 0,
                 x_ticks: bool = True, bottom_pad: int = 0):
        self.img = np.full((height, width, 3), 255, np.uint8)
        self.log_x, self.log_y = log_x, log_y
        self.left, self.right = 80, width - 24
        self.top = 24 + (20 if title else 0)
        self.bottom = height - 48 - bottom_pad - 22 * legend_rows
        self.legend_y = self.bottom + 48 + bottom_pad
        (x_lo, x_hi), (y_lo, y_hi) = (self._range(r, log_x) for r in (x_range, y_range))
        self.x_lo, self.x_hi, self.y_lo, self.y_hi = x_lo, x_hi, y_lo, y_hi
        grid, black = (225, 225, 225), (0, 0, 0)
        l, r, t, b = self.left, self.right, self.top, self.bottom
        for f in (0.25, 0.5, 0.75):
            _line(self.img, l, t + f * (b - t), r, t + f * (b - t), grid, 1)
            _line(self.img, l + f * (r - l), t, l + f * (r - l), b, grid, 1)
        _line(self.img, l, t, l, b, black)
        _line(self.img, l, b, r, b, black)
        _line(self.img, l, t, r, t, black, 1)
        _line(self.img, r, t, r, b, black, 1)
        for v in (y_lo, y_hi):
            label = _tick(10 ** v if log_y else v)
            _text(self.img, l - 8 - 8 * len(label), int(self._row(v)) - 5, label)
        if x_ticks:
            for v in (x_lo, x_hi):
                label = _tick(10 ** v if log_x else v)
                _text(self.img, int(self._col(v)) - 4 * len(label), b + 8, label)
        if x_label:
            _text(self.img, (l + r) // 2 - 4 * len(x_label), b + 26, x_label)
        if y_label:
            _text_vertical(self.img, 8, max(t, (t + b) // 2 - 4 * len(y_label)), y_label)
        if title:
            _text(self.img, (l + r) // 2 - 4 * len(title), 12, title)

    @staticmethod
    def _range(r, log: bool):
        lo, hi = (float(np.log10(v)) if log else float(v) for v in r)
        return (lo, hi) if hi > lo else (lo - 0.5, lo + 0.5)

    def _col(self, fx: float) -> float:
        return self.left + (fx - self.x_lo) / (self.x_hi - self.x_lo) * (self.right - self.left)

    def _row(self, fy: float) -> float:
        return self.bottom - (fy - self.y_lo) / (self.y_hi - self.y_lo) * (self.bottom - self.top)

    def px(self, x: float, y: float):
        """(column, row) of the data point (x, y)."""
        return (self._col(np.log10(x) if self.log_x else x),
                self._row(np.log10(y) if self.log_y else y))

    def line(self, xs, ys, colour, width: int = 2, dash: int = 0) -> None:
        """A polyline through the points (dashed every ``dash`` px if > 0)."""
        pts = [self.px(x, y) for x, y in zip(xs, ys)]
        for (xa, ya), (xb, yb) in zip(pts, pts[1:]):
            _line(self.img, xa, ya, xb, yb, colour, width, dash)

    def points(self, xs, ys, colour, size: int = 5) -> None:
        for x, y in zip(xs, ys):
            c, r = self.px(x, y)
            _line(self.img, c - size // 2, r - size // 2, c - size // 2, r + size // 2,
                  colour, size)

    def bar(self, x0: float, x1: float, y0: float, y1: float, colour,
            alpha: float = 1.0) -> None:
        """The data rectangle [x0, x1] x [y0, y1], filled (blended with
        ``alpha`` below 1)."""
        (c0, r0), (c1, r1) = self.px(x0, y0), self.px(x1, y1)
        h, w = self.img.shape[:2]
        ca, cb = sorted((int(np.rint(c0)), int(np.rint(c1))))
        ra, rb = sorted((int(np.rint(r0)), int(np.rint(r1))))
        ca, ra, cb, rb = max(ca, 0), max(ra, 0), min(cb + 1, w), min(rb + 1, h)
        if ca >= cb or ra >= rb:
            return
        box = self.img[ra:rb, ca:cb]
        box[:] = np.rint(box * (1.0 - alpha) + np.asarray(colour, np.float64) * alpha)

    def label(self, x: float, y: float, text: str, dx: int = 4, dy: int = -12,
              scale: int = 1) -> None:
        c, r = self.px(x, y)
        _text(self.img, int(c) + dx, int(r) + dy, text, scale)

    def x_names(self, xs, names) -> None:
        """Category names under the axis, turned a quarter, centred at ``xs``."""
        for x, name in zip(xs, names):
            c = int(self.px(x, 1.0 if self.log_y else 0.0)[0])
            _text_vertical(self.img, c - 5, self.bottom + 6, name[:30])

    def legend(self, names, colours) -> None:
        """Swatches and names under the axes, three a row."""
        for i, (name, colour) in enumerate(zip(names, colours)):
            x = self.left + (i % 3) * ((self.right - self.left) // 3)
            y = self.legend_y + 22 * (i // 3)
            self.img[y:y + 10, x:x + 24] = colour
            _text(self.img, x + 32, y, name[:24])


def colour(i: int):
    """The i-th colour of matplotlib's default cycle (tab10)."""
    return tuple(int(c) for c in _COLOURS[i % len(_COLOURS)])


def figure(charts: List[Chart]) -> np.ndarray:
    """Panels side by side, as one image."""
    return np.concatenate([c.img for c in charts], axis=1)


def _ranges(xs, ys, pad: float = 0.05):
    """The (x, y) ranges of a line chart: the data's, y padded by ``pad``."""
    x_lo, x_hi = (min(xs), max(xs)) if xs else (0, 1)
    y_lo, y_hi = (min(ys), max(ys)) if ys else (0, 1)
    p = pad * (y_hi - y_lo) if y_hi > y_lo else 0.5
    return (x_lo, x_hi if x_hi > x_lo else x_lo + 1), (y_lo - p, y_hi + p)


def line_chart(series: Dict[str, tuple], width: int = 880, height: int = 495,
               x_label: str = "epoch", y_label: str = "", title: str = "") -> Chart:
    """{name: (xs, ys)} as one polyline a series in the cycle's colours,
    with a legend strip."""
    xs = [x for sx, _ in series.values() for x in sx]
    ys = [y for _, sy in series.values() for y in sy]
    chart = Chart(*_ranges(xs, ys), width, height, x_label=x_label, y_label=y_label,
                  title=title, legend_rows=-(-len(series) // 3))
    for i, (sx, sy) in enumerate(series.values()):
        chart.line(sx, sy, colour(i))
        if len(sx) == 1:
            chart.points(sx, sy, colour(i))
    chart.legend(list(series), [colour(i) for i in range(len(series))])
    return chart


def bar_chart(names: List[str], values: List[float], width: int = 990, height: int = 440,
              y_label: str = "") -> Chart:
    """One bar a name (from 0), the names under the axis."""
    top = max([0.0] + [float(v) for v in values])
    chart = Chart((-0.5, len(names) - 0.5), (0.0, top * 1.05 if top > 0 else 1.0), width,
                  height, y_label=y_label, x_ticks=False, bottom_pad=110)
    for i, v in enumerate(values):
        chart.bar(i - 0.4, i + 0.4, 0.0, float(v), colour(0))
    chart.x_names(range(len(names)), names)
    return chart


def plot_run_comparison(runs: Dict[str, List[Dict]], path: str | Path,
                        key: str = "g_loss") -> Optional[Path]:
    """One metric of several runs against the epoch, as a PNG: a polyline
    a run in its own colour, the axes with the epoch and value ranges, the
    metric's name, and a legend strip of the runs' colours and names under
    the axes (the JAX package's chart, drawn without matplotlib). None when
    ``runs`` is empty."""
    if not runs:
        return None
    series = {name: ([m["epoch"] for m in ms if key in m], [m[key] for m in ms if key in m])
              for name, ms in runs.items()}
    return _write_png(line_chart(series, y_label=key).img, path)


def save_real_vs_fake(real: np.ndarray, fake: np.ndarray, path: str | Path,
                      n: int = 8) -> Path:
    """The first ``n`` reals in a row over the first ``n`` fakes, a grey
    gap between them."""
    row_r = make_grid(to_uint8(real[:n]), nrow=n)
    row_f = make_grid(to_uint8(fake[:n]), nrow=n)
    gap = np.full((6, row_r.shape[1], row_r.shape[2]), 128, np.uint8)
    return _write_png(np.concatenate([row_r, gap, row_f], axis=0), path)


def save_interpolation_strip(frames: np.ndarray, path: str | Path) -> Path:
    """Latent interpolation frames in one row."""
    u8 = to_uint8(frames)
    return _write_png(make_grid(u8, nrow=u8.shape[0]), path)


def plot_losses(metrics: List[Dict], path: str | Path,
                keys: Sequence[str] = ("d_loss", "g_loss")) -> Optional[Path]:
    """The logger's entries of ``keys`` against the epoch (a key with no
    value is left out, an entry without it skipped); None when there are no
    entries."""
    chart = losses_chart(metrics, keys)
    return None if chart is None else _write_png(chart.img, path)


def losses_chart(metrics: List[Dict], keys: Sequence[str] = ("d_loss", "g_loss")
                 ) -> Optional[Chart]:
    if not metrics:
        return None
    series = {}
    for k in keys:
        pts = [(m["epoch"], m[k]) for m in metrics if m.get(k) is not None]
        if pts:
            series[k] = ([p[0] for p in pts], [p[1] for p in pts])
    return line_chart(series, y_label="loss")


def plot_losses_from_json(log_json: str | Path, path: str | Path) -> Optional[Path]:
    data = json.loads(Path(log_json).read_text())
    return plot_losses(data.get("metrics", []), path)


def _read_grey(path: Path) -> np.ndarray:
    from siggan_tpu_torch.data.dataset import _to_gray   # dataset imports export
    from siggan_tpu_torch.infer.export import decode_png
    return _to_gray(decode_png(Path(path).read_bytes()))


def create_training_gif(sample_dir: str | Path, path: str | Path,
                        pattern: str = "*.png", duration_ms: int = 300,
                        max_frames: int = 100) -> Optional[Path]:
    """The sample grids of ``sample_dir`` (sorted, up to ``max_frames``)
    as a looping grey GIF, ``duration_ms`` a frame; None without grids."""
    from siggan_tpu_torch.infer.export import encode_gif
    files = sorted(Path(sample_dir).glob(pattern))[:max_frames]
    if not files:
        return None
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_gif([_read_grey(f) for f in files], duration_ms))
    return path


def save_progress_montage(sample_dir: str | Path, path: str | Path,
                          max_panels: int = 8) -> Optional[Path]:
    """Evenly spaced epoch grids side by side, each under its epoch
    ("epoch 0003"), 242 x 286 px a panel; None without grids."""
    files = sorted(Path(sample_dir).glob("epoch_*.png"))
    if not files:
        return None
    if len(files) > max_panels:
        idx = np.linspace(0, len(files) - 1, max_panels).round().astype(int)
        files = [files[i] for i in idx]
    pw, ph, head = 242, 286, 24
    img = np.full((ph, pw * len(files), 3), 255, np.uint8)
    for i, f in enumerate(files):
        g = _read_grey(f)
        s = min((pw - 8) / g.shape[1], (ph - head - 8) / g.shape[0])
        h, w = max(1, int(g.shape[0] * s)), max(1, int(g.shape[1] * s))
        rows = (np.arange(h) / s).astype(int).clip(0, g.shape[0] - 1)
        cols = (np.arange(w) / s).astype(int).clip(0, g.shape[1] - 1)
        x0, y0 = i * pw + (pw - w) // 2, head + (ph - head - h) // 2
        img[y0:y0 + h, x0:x0 + w] = g[rows][:, cols][..., None]
        title = f.stem.replace("epoch_", "epoch ")
        _text(img, i * pw + (pw - 8 * len(title)) // 2, 6, title)
    return _write_png(img, path)
