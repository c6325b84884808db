"""The training engine on one card: epoch loop, logging, checkpoints,
sample grids, recovery.

Port of the JAX package's ``GANTrainer`` (``train/trainer.py``) without the
mesh, FID, the profiler or the streaming loader (they raise
``NotImplementedError``). The dataset, and a conditional model's labels
(``labels=``, required then), are resident on the card and every step
gathers its batch there. With an LR schedule the span ``lr_total_steps``
is filled in at construction (epochs x steps per epoch) and serialized
with the config, so a resume keeps the schedule. Steps run in windows of K = ``scan_steps``
(``choose_scan_steps``, the JAX trainer's rule) through
``make_resident_multi_step``: on the card each window replays a CUDA graph
of one step K times, on the CPU it is K eager steps. Windows are enqueued
without a host synchronization: metrics stay on the card and are pulled
once at epoch end, where the mode-collapse detector replays them and the
epoch's images/s and ms/step are logged (host clock around the epoch,
ending in that pull), with every key the step returns. The stop file is
polled before every epoch and after every window. Fixed-noise sample grids
every ``sample_interval`` epochs, epoch/latest/best checkpoints every
``checkpoint_interval``, resume, and a checkpoint on interrupt, as in the
JAX trainer; the grids of a conditional model label image i with class
i % num_classes, and with ``ema_decay > 0`` they show the EMA generator.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from siggan_tpu_torch.ckpt.manager import CheckpointManager
from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.core.state import TrainState, create_train_state
from siggan_tpu_torch.infer.export import contact_sheet
from siggan_tpu_torch.train.collapse import ModeCollapseDetector
from siggan_tpu_torch.train.train_step import (check_supported, make_eval_generate,
                                               make_resident_multi_step)
from siggan_tpu_torch.utils.logger import GANLogger


def choose_scan_steps(steps_per_epoch: int, scan_steps: int = 0) -> int:
    """K, the steps of one dispatch, by the JAX trainer's rule: an explicit
    ``scan_steps`` must divide ``steps_per_epoch``; on auto (0) K is its
    largest divisor up to 64, or the whole epoch when that divisor is under
    16 and smaller than the epoch (a prime steps_per_epoch, say), so that
    every window starts at an epoch boundary and stays within its epoch."""
    if scan_steps:
        if steps_per_epoch % scan_steps:
            raise ValueError(f"scan_steps ({scan_steps}) must divide steps_per_epoch "
                             f"({steps_per_epoch}) -- or leave scan_steps=0 for a "
                             f"valid automatic choice")
        return scan_steps
    k = max(1, min(steps_per_epoch, 64))
    while steps_per_epoch % k:
        k -= 1
    return steps_per_epoch if k < 16 and steps_per_epoch > k else k


def check_trainer_supported(cfg: TrainConfig, images: np.ndarray) -> None:
    check_supported(cfg)
    if cfg.fid_interval > 0:
        raise NotImplementedError("in-training FID is not ported yet (ROADMAP A.1)")
    if cfg.profile_dir:
        raise NotImplementedError("the trainer's profiler hook is not ported yet "
                                  "(ROADMAP A.1)")
    if cfg.mesh.num_data not in (-1, 1):
        raise NotImplementedError("multi-card training is not ported yet (ROADMAP A.9)")
    if not cfg.resident_data or images.nbytes / 2 ** 20 > cfg.resident_max_mb:
        raise NotImplementedError("the streaming loader is not ported yet (ROADMAP "
                                  "A.1): the dataset must fit resident_max_mb")


class GANTrainer:
    def __init__(self, cfg: TrainConfig, images: np.ndarray,
                 stop_file: Optional[str] = None,
                 experiment_name: Optional[str] = None,
                 device: DeviceLike = "cuda", labels: Optional[np.ndarray] = None):
        check_trainer_supported(cfg, images)
        if cfg.optim.lr_schedule != "constant" and cfg.optim.lr_total_steps == 0:
            # The schedule's span rides along in every saved config.
            cfg = cfg.replace(optim=dataclasses.replace(
                cfg.optim, lr_total_steps=cfg.epochs * (len(images) // cfg.batch_size)))
        self.cfg = cfg
        self.conditional = cfg.model.num_classes > 0
        if self.conditional and labels is None:
            raise ValueError("conditional training requires labels")
        self.device = resolve_device(device)
        self.stop_file = Path(stop_file) if stop_file else None
        self.logger = GANLogger(cfg.log_dir, experiment_name)
        self.logger.log_config(cfg.to_dict())
        self.collapse_detector = ModeCollapseDetector(
            cfg.mode_collapse_threshold, cfg.mode_collapse_window)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, cfg, authoritative=True)
        self.images_dev = torch.from_numpy(np.ascontiguousarray(images, np.float32)
                                           ).to(self.device)
        self.labels_dev = (torch.from_numpy(np.asarray(labels, np.int64)).to(self.device)
                           if self.conditional else None)
        spe = len(images) // cfg.batch_size
        self.scan_steps = choose_scan_steps(spe, cfg.scan_steps)
        self._step_fn, self.steps_per_epoch = make_resident_multi_step(
            cfg, len(images), self.scan_steps)
        self.state: TrainState = create_train_state(cfg, self.device)
        self._generate = make_eval_generate(cfg)
        self.fixed_noise = torch.randn(
            (cfg.fixed_noise_samples, cfg.model.latent_dim),
            generator=rng.generator(cfg.seed, rng.STREAM_FIXED))
        self.start_epoch = 0
        self._reported = False

    def _report_dispatch(self) -> None:
        """Print, once, how the windows run: K, and on the card the graph's
        capture time."""
        graphed = self._step_fn.graphed
        if self._reported:
            return
        if self.device.type == "cuda":
            if graphed.capture_s is None:   # the window of the eager warm-up steps
                return
            how = (f"replays of a CUDA graph of one step, captured in "
                   f"{graphed.capture_s:.3f} s after {graphed.warm} eager warm-up steps")
        else:
            how = "eager steps"
        self._reported = True
        print(f"Dispatch: {self.scan_steps} steps per call ({self.steps_per_epoch} per "
              f"epoch) as {how}", flush=True)

    def _should_stop(self) -> bool:
        return self.stop_file is not None and self.stop_file.exists()

    def _sample_grid(self, epoch: int) -> Path:
        y = (torch.arange(self.cfg.fixed_noise_samples, device=self.device)
             % self.cfg.model.num_classes if self.conditional else None)
        imgs = self._generate(self.state, self.fixed_noise.to(self.device), y)
        path = Path(self.cfg.sample_dir) / f"epoch_{epoch:04d}.png"
        return contact_sheet(imgs.cpu().numpy(), path, nrow=8)

    def _save_checkpoint(self, epoch: int, g_loss: float) -> None:
        self.ckpt.save(self.state, epoch=epoch, fixed_noise=self.fixed_noise,
                       g_loss=g_loss)

    def resume(self, which: str | int = "latest") -> bool:
        out = self.ckpt.restore(which, self.device)
        if out is None:
            return False
        self.state, extras = out
        self.fixed_noise = extras["fixed_noise"]
        self.start_epoch = extras["epoch"] + 1
        print(f"Resumed from epoch {extras['epoch']} (step {self.state.step})", flush=True)
        return True

    def train(self, epochs: Optional[int] = None) -> Dict:
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        stopped = False
        epoch = self.start_epoch
        try:
            if self.start_epoch == 0:
                self._sample_grid(0)
            for epoch in range(self.start_epoch, epochs):
                if self._should_stop():
                    print(f"Stop file detected — stopping before epoch {epoch}", flush=True)
                    stopped = True
                    epoch -= 1   # label the final checkpoint with the last done epoch
                    break
                windows = []
                t_epoch = time.perf_counter()
                for _ in range(self.steps_per_epoch // self.scan_steps):
                    self.state, m = self._step_fn(self.state, self.images_dev, self.labels_dev)
                    windows.append(m)   # each metric stacked to (K,)
                    self._report_dispatch()
                    if self._should_stop():
                        print("Stop file detected — stopping mid-epoch", flush=True)
                        stopped = True
                        break
                # One device-to-host transfer per epoch; it waits for the card.
                keys = list(windows[0])
                stacked = torch.stack([torch.cat([m[k] for m in windows])
                                       for k in keys]).cpu().numpy()
                dt = time.perf_counter() - t_epoch
                n_steps = stacked.shape[1]
                cols = dict(zip(keys, stacked))
                for g, dfm in zip(cols["g_loss"], cols["d_fake_mean"]):
                    self.collapse_detector.update(float(g), float(dfm))
                avgs = {k: float(np.mean(v)) for k, v in cols.items()}
                avgs["images_per_sec"] = cfg.batch_size * n_steps / dt
                avgs["ms_per_step"] = dt / n_steps * 1000.0
                self.logger.log_metrics(epoch, avgs)
                collapsed, reason = self.collapse_detector.check_collapse()
                if collapsed:
                    print(f"WARNING: possible mode collapse — {reason}", flush=True)
                if cfg.sample_interval > 0 and (epoch + 1) % cfg.sample_interval == 0:
                    self._sample_grid(epoch + 1)
                if (cfg.checkpoint_interval > 0
                        and (epoch + 1) % cfg.checkpoint_interval == 0) or stopped:
                    self._save_checkpoint(epoch, avgs["g_loss"])
                if stopped:
                    break
            else:
                epoch = epochs - 1
            # Final checkpoint + grid, unless no epoch ran.
            if epoch >= self.start_epoch:
                last = self.logger.metrics[-1].get("g_loss", float("inf")) \
                    if self.logger.metrics else float("inf")
                self._save_checkpoint(epoch, last)
                self._sample_grid(epoch + 1)
        except KeyboardInterrupt:
            print("Interrupted — saving checkpoint", flush=True)
            self._save_checkpoint(epoch, float("inf"))
        finally:
            self.logger.save_to_csv()
            self.logger.save_to_json()
        return self.logger.get_summary()
