"""The training engine: epoch loop, logging, checkpoints, sample grids,
recovery, on one card or data-parallel over several.

Port of the JAX package's ``GANTrainer`` (``train/trainer.py``). A
conditional model needs its labels (``labels=``). Two routes, chosen as the
JAX trainer chooses them:

- resident (the set fits ``resident_max_mb`` and ``resident_data``): the
  dataset and its labels live on the card and every step gathers its batch
  there. Steps run in windows of K = ``scan_steps`` (``choose_scan_steps``,
  the JAX trainer's rule) through ``make_resident_multi_step``: on the card
  each window replays a CUDA graph of one step K times, on the CPU it is K
  eager steps. The stop file is polled after every window.
- streaming (otherwise): the set stays in host memory and
  ``data/loader.py::BatchLoader`` copies each batch to the card ahead of
  the step (the epoch's order keyed by its index, the JAX loader's). One
  dispatch per batch through ``make_stream_step``: on the card a CUDA
  graph of ``make_train_step(cfg)`` (augmentation drawn per step), on the
  CPU the eager step. The stop file is polled after every batch.

With an LR schedule the span ``lr_total_steps``
is filled in at construction (epochs x steps per epoch) and serialized
with the config, so a resume keeps the schedule. Dispatches are enqueued
without a host synchronization: metrics stay on the card and are pulled
once at epoch end, where the mode-collapse detector replays them and the
epoch's images/s and ms/step are logged (host clock around the epoch,
ending in that pull), with every key the step returns. The stop file is
also polled before every epoch. With ``profile_dir`` the epoch
``start_epoch + 1`` (the first after the warm-up and the capture) is
traced with ``torch.profiler`` (CPU and, on the card, CUDA activities) and
written there as a Chrome trace, ``epoch_{E:04d}.pt.trace.json``, as the JAX
trainer traces that epoch with ``jax.profiler``. Fixed-noise sample grids
every ``sample_interval`` epochs, epoch/latest/best checkpoints every
``checkpoint_interval``, resume, and a checkpoint on interrupt, as in the
JAX trainer; the grids of a conditional model label image i with class
i % num_classes, and with ``ema_decay > 0`` they show the EMA generator.

Data parallelism (``cfg.mesh``, ``parallel/mesh.py``): in a job of several
ranks, one process per card, ``make_mesh`` gives the data axis and each rank
trains its rows of every global batch of ``batch_size`` (which the ranks
must divide); without a process group the trainer runs alone, as before.
Every rank holds the whole set -- resident on each card, or in each host
process for streaming -- and walks the same global order, so a rank's
gather needs no collective. This differs from the JAX package's sharded
residency (each device holds its shard of the set) and gives the same
batches. Steps per epoch, K and the LR span count the global set and batch.
Rank 0's state is broadcast to the others at the start (and after a
resume, which every rank reads from the same files). Only rank 0 writes
logs, sample grids, checkpoints, the profiler trace and the in-training
FID (the JAX trainer's process 0); the others wait at a barrier after each
checkpoint. The stop file is polled on rank 0 and its decision broadcast,
so every rank stops after the same window; on an interrupt every rank
leaves its loop, and rank 0 saves.

In-training FID (JAX ``train/trainer.py:164-206``), every ``fid_interval``
epochs: ``fid_samples`` fakes from fixed eval noise (``STREAM_EVAL``;
labels i % num_classes for a conditional model) through
``make_eval_generate`` (the EMA generator when tracked) against a fixed
real subset, ``RandomState(seed).permutation(N)[:fid_samples]``, the JAX
trainer's images. The random-init scorer is built on first use and the
real features are extracted once. The FID is computed after the epoch's
timed window (so ``ms_per_step`` stays the step's), on the stream the
graphed windows replay on, outside any capture; it is logged as ``fid``
and passed to the checkpoint, whose ``best`` then follows the lowest FID.
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
from siggan_tpu_torch.data.loader import BatchLoader
from siggan_tpu_torch.infer.export import contact_sheet
from siggan_tpu_torch.parallel.mesh import make_mesh
from siggan_tpu_torch.train.collapse import ModeCollapseDetector
from siggan_tpu_torch.train.train_step import (check_supported, make_eval_generate,
                                               make_resident_multi_step, make_stream_step,
                                               state_tensors)
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
    """Raise for a configuration the trainer does not take: what the step
    refuses, and a global batch that an explicit ``num_data`` does not
    divide (the launched ranks are checked by ``make_mesh``)."""
    check_supported(cfg)
    n = cfg.mesh.num_data
    if n > 0 and cfg.batch_size % n:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by data-axis size {n}")


def is_resident(cfg: TrainConfig, images: np.ndarray) -> bool:
    """The JAX trainer's choice: the set lives on the card when
    ``resident_data`` and it fits ``resident_max_mb``, else it streams."""
    return cfg.resident_data and images.nbytes / 2 ** 20 <= cfg.resident_max_mb


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
        self.mesh = make_mesh(cfg.mesh, self.device)
        if self.mesh is not None:
            self.mesh.local_batch_size(cfg.batch_size)
        self.main = self.mesh is None or self.mesh.is_main
        self.stop_file = Path(stop_file) if stop_file else None
        self.logger = GANLogger(cfg.log_dir, experiment_name, write=self.main)
        self.logger.log_config(cfg.to_dict())
        self.collapse_detector = ModeCollapseDetector(
            cfg.mode_collapse_threshold, cfg.mode_collapse_window)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, cfg, authoritative=True,
                                      write=self.main)
        images = np.ascontiguousarray(images, np.float32)
        self.resident = is_resident(cfg, images)
        if self.resident:
            self.images_dev = torch.from_numpy(images).to(self.device)
            self.labels_dev = (torch.from_numpy(np.asarray(labels, np.int64)).to(self.device)
                               if self.conditional else None)
            spe = len(images) // cfg.batch_size
            self.scan_steps = choose_scan_steps(spe, cfg.scan_steps)
            self._step_fn, self.steps_per_epoch = make_resident_multi_step(
                cfg, len(images), self.scan_steps, self.mesh)
            self.loader = None
        else:
            self.loader = BatchLoader(
                images, cfg.batch_size, seed=cfg.seed, prefetch=cfg.prefetch,
                labels=np.asarray(labels, np.int64) if self.conditional else None,
                mesh=self.mesh, device=self.device)
            self.steps_per_epoch = len(self.loader)
            self.scan_steps = 1
            self._step_fn = make_stream_step(cfg, self.mesh)
        self.state: TrainState = create_train_state(cfg, self.device)
        self._replicate()
        self._generate = make_eval_generate(cfg)
        self.fixed_noise = torch.randn(
            (cfg.fixed_noise_samples, cfg.model.latent_dim),
            generator=rng.generator(cfg.seed, rng.STREAM_FIXED))
        self.start_epoch = 0
        self._reported = False
        # Quality-tracked best: a fixed real subset and fixed eval noise so
        # that the epochs' FIDs compare; the scorer is built on first use.
        self._fid_scorer = None
        self._last_fid: Optional[tuple] = None   # (epoch, fid)
        if cfg.fid_interval > 0 and self.main:
            if cfg.checkpoint_interval % cfg.fid_interval != 0:
                print(f"WARNING: fid_interval={cfg.fid_interval} does not "
                      f"divide checkpoint_interval={cfg.checkpoint_interval}; "
                      "checkpoints saved without a FID can never become "
                      "'best' once a FID-best exists", flush=True)
            sel = np.random.RandomState(cfg.seed).permutation(len(images))[:cfg.fid_samples]
            self._fid_real = np.asarray(images[sel], np.float32)
            self._fid_noise = torch.randn(
                (cfg.fid_samples, cfg.model.latent_dim),
                generator=rng.generator(cfg.seed, rng.STREAM_EVAL)).to(self.device)
            self._fid_labels = (torch.arange(cfg.fid_samples, device=self.device)
                                % cfg.model.num_classes if self.conditional else None)

    def _replicate(self) -> None:
        """Every rank takes rank 0's state (a no-op without a mesh)."""
        if self.mesh is not None:
            self.mesh.replicate(state_tensors(self.state))

    def _report_dispatch(self) -> None:
        """Print, once, how the windows run: K, and on the card the graph's
        capture time."""
        graphed = self._step_fn.graphed
        if self._reported or not self.main:
            return
        if self.device.type == "cuda":
            if graphed.capture_s is None:   # the window of the eager warm-up steps
                return
            how = (f"replays of a CUDA graph of one step, captured in "
                   f"{graphed.capture_s:.3f} s after {graphed.warm} eager warm-up steps")
        else:
            how = "eager steps"
        self._reported = True
        route = ("resident" if self.resident else
                 f"streaming, {self.cfg.prefetch} batches copied ahead")
        if self.mesh is not None:
            route += (f"; {self.mesh.size} ranks of {self.mesh.local_batch_size(self.cfg.batch_size)}"
                      f" rows each")
        print(f"Dispatch: {self.scan_steps} steps per call ({self.steps_per_epoch} per "
              f"epoch) as {how} ({route})", flush=True)

    def _dispatches(self, epoch: int):
        """The epoch's step arguments after the state: per window the
        resident set, or per batch the loader's batch (and labels)."""
        if self.loader is None:
            for _ in range(self.steps_per_epoch // self.scan_steps):
                yield self.images_dev, self.labels_dev
            return
        for batch in self.loader.epoch(epoch):
            yield batch if isinstance(batch, tuple) else (batch,)

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof, epoch: int) -> None:
        prof.stop()
        out = Path(self.cfg.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"epoch_{epoch:04d}.pt.trace.json"))
        print(f"Profiler trace written to {self.cfg.profile_dir}", flush=True)

    def _should_stop(self) -> bool:
        """Whether the stop file exists, as rank 0 sees it, on every rank."""
        stop = self.main and self.stop_file is not None and self.stop_file.exists()
        return stop if self.mesh is None else self.mesh.decide(stop)

    def _sample_grid(self, epoch: int) -> Optional[Path]:
        if not self.main:
            return None
        y = (torch.arange(self.cfg.fixed_noise_samples, device=self.device)
             % self.cfg.model.num_classes if self.conditional else None)
        imgs = self._generate(self.state, self.fixed_noise.to(self.device), y)
        path = Path(self.cfg.sample_dir) / f"epoch_{epoch:04d}.png"
        return contact_sheet(imgs.cpu().numpy(), path, nrow=8)

    def _compute_fid(self) -> float:
        if self._fid_scorer is None:
            from siggan_tpu_torch.eval.fid import FIDScorer
            # 256-image feature chunks, as the JAX trainer; the real subset
            # is fixed for the run, so its features are extracted once.
            self._fid_scorer = FIDScorer(batch_size=min(256, self.cfg.fid_samples),
                                         device=self.device)
            self._fid_real_feats = self._fid_scorer.features(self._fid_real)
        fakes = []
        for s in range(0, self.cfg.fid_samples, 256):
            y = self._fid_labels[s:s + 256] if self.conditional else None
            fakes.append(self._generate(self.state, self._fid_noise[s:s + 256], y))
        return self._fid_scorer.fid_from_features(self._fid_real_feats, torch.cat(fakes))

    def _save_checkpoint(self, epoch: int, g_loss: float, sync: bool = True) -> None:
        """Rank 0 saves; with ``sync`` the ranks then meet at a barrier."""
        # A FID goes with the checkpoint only when it scored this epoch's state.
        fid = self._last_fid[1] if (
            self._last_fid is not None and self._last_fid[0] == epoch) else None
        self.ckpt.save(self.state, epoch=epoch, fixed_noise=self.fixed_noise,
                       g_loss=g_loss, fid=fid)
        if sync and self.mesh is not None:
            self.mesh.barrier()

    def resume(self, which: str | int = "latest") -> bool:
        if self.mesh is not None:
            self.mesh.barrier()
        out = self.ckpt.restore(which, self.device)
        if out is None:
            return False
        self.state, extras = out
        self._replicate()
        self.fixed_noise = extras["fixed_noise"]
        self.start_epoch = extras["epoch"] + 1
        if self.main:
            print(f"Resumed from epoch {extras['epoch']} (step {self.state.step})",
                  flush=True)
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
                    if self.main:
                        print(f"Stop file detected — stopping before epoch {epoch}",
                              flush=True)
                    stopped = True
                    epoch -= 1   # label the final checkpoint with the last done epoch
                    break
                profiler = (self._start_profiler() if cfg.profile_dir and self.main
                            and epoch == self.start_epoch + 1 else None)
                windows = []
                t_epoch = time.perf_counter()
                for batch in self._dispatches(epoch):
                    self.state, m = self._step_fn(self.state, *batch)
                    windows.append(m)   # each metric stacked to (K,)
                    self._report_dispatch()
                    if self._should_stop():
                        if self.main:
                            print("Stop file detected — stopping mid-epoch", flush=True)
                        stopped = True
                        break
                # One device-to-host transfer per epoch; it waits for the card.
                keys = list(windows[0])
                stacked = torch.stack([torch.cat([m[k] for m in windows])
                                       for k in keys]).cpu().numpy()
                if profiler is not None:
                    self._stop_profiler(profiler, epoch)
                dt = time.perf_counter() - t_epoch
                n_steps = stacked.shape[1]
                cols = dict(zip(keys, stacked))
                for g, dfm in zip(cols["g_loss"], cols["d_fake_mean"]):
                    self.collapse_detector.update(float(g), float(dfm))
                avgs = {k: float(np.mean(v)) for k, v in cols.items()}
                avgs["images_per_sec"] = cfg.batch_size * n_steps / dt
                avgs["ms_per_step"] = dt / n_steps * 1000.0
                if cfg.fid_interval > 0 and (epoch + 1) % cfg.fid_interval == 0 and self.main:
                    t_fid = time.perf_counter()
                    self._last_fid = (epoch, self._compute_fid())
                    avgs["fid"] = self._last_fid[1]
                    print(f"FID epoch {epoch}: {avgs['fid']:.4f} in "
                          f"{time.perf_counter() - t_fid:.2f} s", flush=True)
                self.logger.log_metrics(epoch, avgs)
                collapsed, reason = self.collapse_detector.check_collapse()
                if collapsed and self.main:
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
            # No barrier: another rank may have been interrupted inside a
            # collective. Every rank leaves; rank 0 saves the replicated state.
            if self.main:
                print("Interrupted — saving checkpoint", flush=True)
            self._save_checkpoint(epoch, float("inf"), sync=False)
        finally:
            self.logger.save_to_csv()
            self.logger.save_to_json()
        return self.logger.get_summary()
