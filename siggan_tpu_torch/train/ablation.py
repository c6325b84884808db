"""The ablation grid study: latent size x generator activation x spectral
norm, each configuration trained, scored and tabulated.

Port of the JAX package's ``train/ablation.py``:
 - ``AblationConfig`` with its short names (``z{latent}_{relu|lrelu}_sn{0|1}``)
   over the 3 x 2 x 2 grid;
 - ``make_ablation_train_step``, the reference ablation trainer's step,
   which differs from the main trainer on purpose: one latent batch per
   iteration; the generator runs twice on it (unpacked, so no kernel runs:
   the packed tail and kernels B1/B1' belong to the main step), once
   without gradient for D's fake batch and once, from the same BN state,
   for G's update, whose BN statistics are kept; D applies three times,
   each advancing its spectral-norm vectors (the reals, the detached fakes,
   then the fakes through the updated D for G), with three dropout masks;
 - ``AblationResult`` with the loss-variance stability score;
 - ``AblationStudyManager``: each run on the JAX package's epoch order
   (``np.random.RandomState((seed, epoch)).permutation``), FID of 256
   samples against up to 512 cached reals (``eval/fid.py``'s random-init
   InceptionV3, the reals' features extracted once), CSV / Markdown / JSON
   tables, a sample grid per run, the JAX package's five plots under its
   file names (``loss_curves.png``, ``stability.png``, ``wall_time.png``,
   and with a FID ``fid_comparison.png`` and ``params_vs_fid.png``), drawn
   with numpy (``utils/visualizer.py``), and ``plots.json``, their points.

Leaky-ReLU generators train on the module path (kernels B2 and B4 take ReLU
only). Runs are eager steps on the device, which defaults to ``cuda`` and
raises without a card.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import ModelConfig, TrainConfig
from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.core.state import TrainState, create_train_state, make_optimizers
from siggan_tpu_torch.models import generator
from siggan_tpu_torch.models.discriminator import channel_schedule as d_channels
from siggan_tpu_torch.ops.regularizers import keep_mask
from siggan_tpu_torch.train.train_step import (Metrics, Streams, _bce_mean, _dtype,
                                               make_eval_generate)
from siggan_tpu_torch.utils.visualizer import (Chart, _write_png, bar_chart, colour, figure,
                                               line_chart)


@dataclass(frozen=True)
class AblationConfig:
    latent_dim: int = 100
    g_activation: str = "relu"          # "relu" | "leaky_relu"
    use_spectral_norm: bool = False
    image_size: int = 64
    batch_size: int = 64
    epochs: int = 20
    seed: int = 42
    compute_dtype: str = "bfloat16"

    @property
    def short_name(self) -> str:
        act = "relu" if self.g_activation == "relu" else "lrelu"
        return f"z{self.latent_dim}_{act}_sn{int(self.use_spectral_norm)}"

    def to_train_config(self) -> TrainConfig:
        return TrainConfig(
            model=ModelConfig(latent_dim=self.latent_dim, image_size=self.image_size,
                              g_activation=self.g_activation,
                              use_spectral_norm=self.use_spectral_norm),
            batch_size=self.batch_size, epochs=self.epochs, seed=self.seed,
            compute_dtype=self.compute_dtype, augment=False)


@dataclass
class AblationResult:
    config: AblationConfig
    final_d_loss: float = 0.0
    final_g_loss: float = 0.0
    d_loss_variance: float = 0.0
    g_loss_variance: float = 0.0
    fid: Optional[float] = None
    wall_time_sec: float = 0.0
    g_params: int = 0
    d_params: int = 0

    def stability_score(self) -> float:
        """Lower combined loss variance = more stable."""
        return float(self.d_loss_variance + self.g_loss_variance)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["config"] = dataclasses.asdict(self.config)
        d["short_name"] = self.config.short_name
        d["stability"] = self.stability_score()
        return d


def ablation_draws(cfg: TrainConfig, st: Streams, step: int, b: int, device) -> Dict:
    """Step ``step``'s randomness: ``"z"`` (b, latent) and ``"masks"``, D's
    keep-masks for its three applications (None without dropout)."""
    widths = [co for _, co in d_channels(cfg.model)] if cfg.model.dropout > 0 else []
    masks = []
    for i in range(3):
        gen = st(rng.STREAM_DROPOUT, step, i)
        masks.append([keep_mask(torch.rand((b, 1, 1, c), generator=gen, device=device),
                                cfg.model.dropout) for c in widths] or None)
    z = torch.randn((b, cfg.model.latent_dim), generator=st(rng.STREAM_NOISE, step),
                    device=device)
    return {"z": z, "masks": masks}


def make_ablation_train_step(cfg: TrainConfig):
    """``step(state, real, draws=None) -> (state, {"d_loss", "g_loss"})``,
    the ablation trainer's step (see the module doc); ``real`` (b, H, W, 1)
    on the state's device, ``draws`` as ``ablation_draws`` makes them (a
    test injects the JAX step's). Updates ``state`` in place and advances
    ``state.step``."""
    g_tx, d_tx = make_optimizers(cfg)
    cdt = _dtype(cfg)
    streams: Dict[str, Streams] = {}

    def step(state: TrainState, real: torch.Tensor, draws: Optional[Dict] = None):
        if draws is None:
            st = streams.setdefault(str(real.device), Streams(cfg.seed, real.device))
            draws = ablation_draws(cfg, st, state.step, real.shape[0], real.device)
        z, masks = draws["z"], draws["masks"]
        g_bn = [t.clone() for t in state.g.buffers()]
        with torch.no_grad():
            fake = state.g(z, None, cdt, train=True)
        # The second forward starts from the same BN state; only its update is kept.
        torch._foreach_copy_(list(state.g.buffers()), g_bn)

        logits_r = state.d(real, train=True, compute_dtype=cdt, masks=masks[0])
        logits_f = state.d(fake, train=True, compute_dtype=cdt, masks=masks[1])
        d_loss = _bce_mean(logits_r, cfg.label_smoothing) + _bce_mean(logits_f, 0.0)
        d_params = list(state.d.parameters())
        d_tx.step(d_params, torch.autograd.grad(d_loss, d_params), state.d_opt)

        fake2 = state.g(z, None, cdt, train=True)
        logits = state.d(fake2, train=True, compute_dtype=cdt, masks=masks[2])
        g_loss = _bce_mean(logits, 1.0)
        g_params = list(state.g.parameters())
        g_tx.step(g_params, torch.autograd.grad(g_loss, g_params), state.g_opt)
        state.step += 1
        metrics: Metrics = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}
        return state, metrics

    return step


def plot_images(plots: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The images of ``save_plots``' charts from their points (plots.json):
    the D and G loss of every run against the step (1320 x 495, two
    panels), bars of stability, wall time and FID (990 x 440), and G's
    parameters against the FID with each run's name (660 x 495)."""
    hist = plots["loss_curves.png"]
    panels = [line_chart({n: (list(range(len(h[key]))), h[key]) for n, h in hist.items()},
                         660, 495, x_label="step", title=title)
              for key, title in (("d_loss", "d loss"), ("g_loss", "g loss"))]
    out = {"loss_curves.png": figure(panels),
           "stability.png": bar_chart(list(plots["stability.png"]),
                                      list(plots["stability.png"].values()),
                                      y_label="loss variance").img,
           "wall_time.png": bar_chart(list(plots["wall_time.png"]),
                                      list(plots["wall_time.png"].values()),
                                      y_label="wall time s").img}
    if "fid_comparison.png" in plots:
        fid = plots["fid_comparison.png"]
        out["fid_comparison.png"] = bar_chart(list(fid), list(fid.values()),
                                              y_label="fid").img
        pts = plots["params_vs_fid.png"]
        xs, ys = [p[0] for p in pts.values()], [p[1] for p in pts.values()]
        (x_lo, x_hi), (y_lo, y_hi) = (min(xs), max(xs)), (min(ys), max(ys))
        px, py = 0.05 * (x_hi - x_lo) or 1.0, 0.05 * (y_hi - y_lo) or 1.0
        chart = Chart((x_lo - px, x_hi + px), (y_lo - py, y_hi + py), 660, 495,
                      x_label="g params", y_label="fid")
        chart.points(xs, ys, colour(0))
        for name, (x, y) in pts.items():
            chart.label(x, y, name)
        out["params_vs_fid.png"] = chart.img
    return out


class AblationStudyManager:
    """Run the grid, score each run, write the tables, grids and plot data."""

    DEFAULT_GRID = {
        "latent_dim": [50, 100, 200],
        "g_activation": ["relu", "leaky_relu"],
        "use_spectral_norm": [False, True],
    }

    def __init__(self, images: np.ndarray, output_dir: str | Path,
                 epochs: int = 20, batch_size: int = 64, seed: int = 42,
                 compute_dtype: str = "bfloat16",
                 fid_real_cap: int = 512, fid_samples: int = 256,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.images = images
        self.out = Path(output_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.compute_dtype = compute_dtype
        self.fid_reals = images[:fid_real_cap]
        self.fid_samples = fid_samples
        self.results: List[AblationResult] = []
        self.histories: Dict[str, Dict[str, List[float]]] = {}
        self.step_ms: Dict[str, float] = {}
        self._scorer = None
        self._real_features = None

    def grid(self, overrides: Optional[Dict[str, List]] = None) -> List[AblationConfig]:
        g = dict(self.DEFAULT_GRID)
        if overrides:
            g.update(overrides)
        return [AblationConfig(latent_dim=z, g_activation=act, use_spectral_norm=sn,
                               epochs=self.epochs, batch_size=self.batch_size, seed=self.seed,
                               compute_dtype=self.compute_dtype)
                for z in g["latent_dim"] for act in g["g_activation"]
                for sn in g["use_spectral_norm"]]

    def _fid(self, fake: np.ndarray) -> float:
        """FID against the cached reals, whose features are extracted once."""
        if self._scorer is None:
            from siggan_tpu_torch.eval.fid import FIDScorer
            self._scorer = FIDScorer(device=self.device)
            self._real_features = self._scorer.features(self.fid_reals)
        return self._scorer.fid_from_features(self._real_features, fake)

    def run_one(self, acfg: AblationConfig, compute_fid: bool = True) -> AblationResult:
        cfg = acfg.to_train_config()
        state = create_train_state(cfg, self.device)
        step = make_ablation_train_step(cfg)
        n = len(self.images)
        steps_per_epoch = max(1, n // cfg.batch_size)
        images = torch.from_numpy(np.ascontiguousarray(self.images)).to(self.device)

        t0 = time.perf_counter()
        d_hist: List[float] = []
        g_hist: List[float] = []
        for epoch in range(acfg.epochs):
            order = torch.from_numpy(np.random.RandomState((cfg.seed, epoch)).permutation(n))
            order = order.to(self.device)
            ms = []
            for b in range(steps_per_epoch):
                state, m = step(state, images[order[b * cfg.batch_size:(b + 1) * cfg.batch_size]])
                ms.append(torch.stack([m["d_loss"], m["g_loss"]]))
            losses = torch.stack(ms).float().cpu().numpy()
            d_hist.append(float(np.mean(losses[:, 0])))
            g_hist.append(float(np.mean(losses[:, 1])))
        wall = time.perf_counter() - t0
        self.histories[acfg.short_name] = {"d_loss": d_hist, "g_loss": g_hist}
        self.step_ms[acfg.short_name] = 1e3 * wall / (acfg.epochs * steps_per_epoch)

        z = generator.generate_latent(rng.generator(cfg.seed + 1, rng.STREAM_NOISE),
                                      self.fid_samples, cfg.model).to(self.device)
        fake = make_eval_generate(cfg)(state, z).cpu().numpy()
        fid_val = self._fid(fake) if compute_fid else None

        from siggan_tpu_torch.utils.visualizer import save_sample_grid
        save_sample_grid(fake[:64], self.out / "samples" / f"{acfg.short_name}.png")

        half = len(g_hist) // 2
        res = AblationResult(
            config=acfg, final_d_loss=d_hist[-1], final_g_loss=g_hist[-1],
            d_loss_variance=float(np.var(d_hist[half:])),
            g_loss_variance=float(np.var(g_hist[half:])),
            fid=fid_val, wall_time_sec=wall,
            g_params=generator.param_count(state.g),
            d_params=sum(p.numel() for p in state.d.parameters()))
        self.results.append(res)
        return res

    def run_all(self, overrides: Optional[Dict[str, List]] = None,
                compute_fid: bool = True) -> List[AblationResult]:
        cfgs = self.grid(overrides)
        for i, acfg in enumerate(cfgs):
            print(f"[{i + 1}/{len(cfgs)}] {acfg.short_name}", flush=True)
            r = self.run_one(acfg, compute_fid)
            print(f"    d_loss {r.final_d_loss:.3f} g_loss {r.final_g_loss:.3f} "
                  f"fid {r.fid if r.fid is None else round(r.fid, 2)} "
                  f"({r.wall_time_sec:.1f}s, {self.step_ms[acfg.short_name]:.3f} ms/step)",
                  flush=True)
        self.save_tables()
        self.save_plots()
        return self.results

    # -- outputs ----------------------------------------------------------
    def save_tables(self) -> None:
        """results.json, results.csv and results.md, as the JAX package
        writes them."""
        rows = [r.to_dict() for r in self.results]
        (self.out / "results.json").write_text(json.dumps(rows, indent=2))
        cols = ["short_name", "final_d_loss", "final_g_loss", "stability",
                "fid", "wall_time_sec", "g_params"]
        with open(self.out / "results.csv", "w") as f:
            f.write(",".join(cols) + "\n")
            for r in rows:
                f.write(",".join(str(r.get(c, "")) for c in cols) + "\n")
        md = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
        for r in rows:
            md.append("| " + " | ".join(
                f"{r.get(c):.4f}" if isinstance(r.get(c), float)
                else str(r.get(c, "")) for c in cols) + " |")
        (self.out / "results.md").write_text("\n".join(md) + "\n")

    def save_plots(self) -> None:
        """The JAX package's five plots (loss curves, FID bars, stability
        bars, parameters against FID, wall time; the two of the FID when any
        run has one), drawn with numpy at the JAX figures' pixel sizes, and
        plots.json, their points by file name."""
        names = [r.config.short_name for r in self.results]
        has_fid = any(r.fid is not None for r in self.results)
        plots: Dict[str, Any] = {
            "loss_curves.png": self.histories,
            "stability.png": dict(zip(names, [r.stability_score() for r in self.results])),
            "wall_time.png": dict(zip(names, [r.wall_time_sec for r in self.results])),
        }
        if has_fid:
            plots["fid_comparison.png"] = dict(zip(names, [r.fid or 0 for r in self.results]))
            plots["params_vs_fid.png"] = {r.config.short_name: [r.g_params, r.fid or 0]
                                          for r in self.results}
        (self.out / "plots.json").write_text(json.dumps(plots, indent=2))
        for name, img in plot_images(plots).items():
            _write_png(img, self.out / name)
