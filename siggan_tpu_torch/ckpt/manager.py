"""The port's checkpoints.

A generator checkpoint is a directory holding

  config.json     the ``TrainConfig`` sidecar, the JAX package's schema
  generator.npz   the generator in JAX layouts, keyed by tree path
                  (``fc/w``, ``blocks/0/w``, ``bn/blocks/0/mean``, ...)

and is what ``load_generator`` / ``cli.serve`` read. A JAX-side export
writes the same two files from ``(g_params, g_bn)`` with ``bridge.flatten``.

``CheckpointManager`` keeps full train-state checkpoints as the JAX
package's manager does: one directory per saved epoch (``epoch_NNNN``,
itself a generator checkpoint, plus ``discriminator.npz`` (D's weights,
with the class embedding and the aux head of a conditional model, and,
under ``state/``, its spectral-norm vectors), ``optimizer.npz`` (the two
Adam states, moments as f32, with the LR each last applied),
``generator_ema.npz`` when the run tracks a generator EMA (the shadow, in
``generator.npz``'s layout), ``fixed_noise.npy`` and ``state.json`` (step,
epoch, best G loss)), the run's ``config.json``, and an ``index.json``
mapping the ``latest`` and ``best`` aliases to epochs. ``best`` follows the
JAX package's rule (``ckpt/manager.py:101-157``): the lowest G loss until
a FID is recorded (``save(..., fid=)``, the trainer's in-training FID),
then the lowest FID, kept as ``best_fid`` in ``index.json``.
``load_generator`` on such a run directory loads the epoch ``which`` names
(``"latest"``, ``"best"`` or an epoch number), and serves the EMA weights
(``generator_ema.npz``) when the run has them and its config keeps EMA on,
as the JAX package's ``load_generator`` returns the shadow;
``generator.npz`` always holds the raw weights. The resume rules are the
JAX package's: a shadow missing from the checkpoint starts as a copy of
the restored weights, and one present while ``ema_decay == 0`` is dropped.

The epoch layout is written in one place, ``write_epoch``, from JAX-layout
trees of numpy arrays; ``CheckpointManager.save`` converts its train state
to those trees and calls it, and so does ``scripts/import_jax_run.py``,
which turns a JAX package run (Orbax directories, read with JAX where it is
installed) into a run of this layout that the port serves and resumes.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from siggan_tpu_torch import bridge
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.models.generator import Generator

SIDECAR = "config.json"
WEIGHTS = "generator.npz"
EMA_WEIGHTS = "generator_ema.npz"
D_WEIGHTS = "discriminator.npz"
D_STATE = "state/"
OPTIMIZER = "optimizer.npz"
NOISE = "fixed_noise.npy"
STATE = "state.json"
INDEX = "index.json"


def save_generator(directory: str | Path, model: Generator,
                   cfg: TrainConfig) -> Path:
    """Write ``config.json`` and ``generator.npz``; returns the directory."""
    if cfg.model != model.cfg:
        raise ValueError("cfg.model differs from the generator's own config")
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / SIDECAR).write_text(cfg.to_json())
    np.savez(d / WEIGHTS, **bridge.flatten(*bridge.to_jax(model)))
    return d


def load_config(directory: str | Path) -> TrainConfig:
    return TrainConfig.from_json((Path(directory) / SIDECAR).read_text())


def _generator_dir(directory: str | Path, which: str | int = "latest") -> Path:
    """``directory`` itself (a generator checkpoint, which holds one
    generator: its ``latest``), or the epoch ``which`` names in a run
    directory: ``"latest"``, ``"best"`` or an epoch number."""
    d = Path(directory)
    if (d / WEIGHTS).exists() or not (d / INDEX).exists():
        if which != "latest":
            raise FileNotFoundError(f"{d} is not a run directory: no epoch {which!r}")
        return d
    idx = json.loads((d / INDEX).read_text())
    epoch = which if isinstance(which, int) else idx.get(which)
    if epoch is None or epoch not in idx.get("epochs", []):
        raise FileNotFoundError(f"no checkpoint under {d} ({which})")
    return d / f"epoch_{epoch:04d}"


def _load_npz(path: Path) -> Dict[str, np.ndarray]:
    if not path.exists():
        raise FileNotFoundError(f"no {path.name} under {path.parent}")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def load_arrays(directory: str | Path, which: str | int = "latest") -> Dict[str, np.ndarray]:
    return _load_npz(_generator_dir(directory, which) / WEIGHTS)


def load_generator(directory: str | Path, device,
                   which: str | int = "latest") -> Tuple[Generator, TrainConfig]:
    """(Generator on ``device``, TrainConfig) from a generator checkpoint or
    from the epoch ``which`` names in a run directory: the EMA weights when
    the checkpoint has them and its config tracks EMA, else the weights."""
    d = _generator_dir(directory, which)
    cfg = load_config(d)
    ema = d / EMA_WEIGHTS
    path = ema if cfg.ema_decay > 0 and ema.exists() else d / WEIGHTS
    g_params, g_bn = bridge.unflatten(_load_npz(path))
    return bridge.from_jax(g_params, g_bn, cfg.model, device), cfg


def load_discriminator(directory: str | Path, device,
                       which: str | int = "latest") -> Tuple[torch.nn.Module, TrainConfig]:
    """(Discriminator on ``device`` in eval mode, TrainConfig) of the epoch
    ``which`` names in a run directory (its spectral-norm u's included)."""
    d = _generator_dir(directory, which)
    cfg = load_config(d)
    d_params, d_state = bridge.unflatten(_load_npz(d / D_WEIGHTS), D_STATE)
    model = bridge.d_from_jax(d_params, cfg.model, device, d_state)
    return model.eval(), cfg


def infer_architecture(arrays: Dict[str, np.ndarray]) -> Dict[str, int]:
    """(latent_dim, image_size, base_features) from the weight shapes, as
    the JAX package's ``infer_architecture`` reads a bare tree."""
    fc_in, n_fc = arrays["fc/w"].shape
    c0 = n_fc // 16
    n_blocks = len({k.split("/")[1] for k in arrays if k.startswith("blocks/")})
    image_size = 4 * (2 ** n_blocks)
    return {"latent_dim": int(fc_in), "image_size": int(image_size),
            "base_features": int(c0 if image_size == 64 else c0 // 2)}


def _opt_arrays(prefix: str, tree: Dict) -> Dict[str, np.ndarray]:
    out = {f"{prefix}/count": np.asarray(tree["count"], np.int32),
           f"{prefix}/lr": np.asarray(tree["lr"], np.float32)}
    for k in ("m", "v"):
        for path, a in bridge.flatten(tree[k], {}).items():
            out[f"{prefix}/{k}/{path}"] = a
    return out


Trees = Tuple[Dict, Dict]


def write_epoch(path: str | Path, cfg_json: str, *, epoch: int, step: int,
                best_g_loss: float, g: Trees, d: Trees, g_opt: Dict, d_opt: Dict,
                fixed_noise: np.ndarray, g_ema: Optional[Trees] = None) -> Path:
    """Write one epoch directory of the run layout from JAX-layout trees of
    numpy arrays, replacing what ``path`` held: ``g`` = (g_params, g_bn),
    ``d`` = (d_params, d_state), ``g_ema`` = (params, bn) of the shadow or
    None, each Adam state {count, m, v, lr} with m and v shaped like its
    model's parameter tree (any float dtype, bf16 included; stored as f32)
    and ``lr`` the learning rate its last update applied (0 before the
    first); ``cfg_json`` the ``TrainConfig`` sidecar."""
    path = Path(path)
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    (path / SIDECAR).write_text(cfg_json)
    np.savez(path / WEIGHTS, **bridge.flatten(*g))
    if g_ema is not None:
        np.savez(path / EMA_WEIGHTS, **bridge.flatten(*g_ema))
    np.savez(path / D_WEIGHTS, **bridge.flatten(*d, D_STATE))
    np.savez(path / OPTIMIZER, **_opt_arrays("g", g_opt), **_opt_arrays("d", d_opt))
    np.save(path / NOISE, np.asarray(fixed_noise, np.float32))
    (path / STATE).write_text(json.dumps({
        "step": int(step), "epoch": int(epoch), "best_g_loss": float(best_g_loss)}))
    return path


def write_index(directory: str | Path, idx: Dict[str, Any]) -> None:
    """A run's ``index.json``: ``epochs``, ``latest``, ``best`` and the
    ``best_g_loss`` / ``best_fid`` the aliases were chosen by."""
    (Path(directory) / INDEX).write_text(json.dumps(idx, indent=2))


def _opt_state(opt: Dict, model) -> Dict:
    return {**bridge.opt_to_jax(opt, model), "lr": opt["lr"].detach().cpu().numpy()}


def _opt_tree(prefix: str, arrays: Dict[str, np.ndarray]) -> Dict:
    tree: Dict[str, Any] = {"count": arrays[f"{prefix}/count"]}
    for k in ("m", "v"):
        head = f"{prefix}/{k}/"
        tree[k] = bridge.unflatten({p[len(head):]: a for p, a in arrays.items()
                                    if p.startswith(head)})[0]
    return tree


class CheckpointManager:
    """Epoch checkpoints of a ``TrainState`` with ``latest``/``best``
    aliases. ``authoritative=True`` (the trainer's manager) makes ``cfg``
    the run's sidecar, replacing one a previous run left behind.

    In a data-parallel run the state is replicated, so rank 0 alone writes
    (``write=True`` there, False on the other ranks, whose ``save`` writes
    nothing and returns None) and every rank restores from the same files;
    the trainer puts a barrier after each save, as the JAX manager syncs
    its processes around one."""

    def __init__(self, directory: str | Path, cfg: TrainConfig,
                 *, authoritative: bool = False, write: bool = True):
        self.dir = Path(directory).absolute()
        self.cfg = cfg
        self.write = write
        if not write:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        sidecar = self.dir / SIDECAR
        if not sidecar.exists():
            sidecar.write_text(cfg.to_json())
        elif authoritative and sidecar.read_text() != cfg.to_json():
            print(f"WARNING: {self.dir} holds a config sidecar from a previous "
                  "run that differs from the current config; overwriting it. "
                  "Checkpoints already there were saved under the old config "
                  "-- use a fresh checkpoint_dir per recipe.", flush=True)
            sidecar.write_text(cfg.to_json())

    def _read_index(self) -> Dict[str, Any]:
        p = self.dir / INDEX
        return json.loads(p.read_text()) if p.exists() else {"epochs": []}

    def _epoch_dir(self, epoch: int) -> Path:
        return self.dir / f"epoch_{epoch:04d}"

    def save(self, state, *, epoch: int, fixed_noise: torch.Tensor,
             g_loss: Optional[float] = None, fid: Optional[float] = None
             ) -> Optional[Path]:
        """Save ``state`` as epoch ``epoch``; updates ``latest`` and ``best``.

        ``best``: once any ``fid`` has been recorded, the lowest FID wins,
        and an epoch saved without one never becomes ``best`` (criteria do
        not mix); before that, the lowest G loss (the reference's rule).
        ``best_fid`` lives in ``index.json`` only; ``state.json`` records
        the lower of the index's ``best_g_loss`` and this save's G loss,
        whichever criterion picks ``best`` (as the JAX manager stamps its
        checkpoints)."""
        if not self.write:
            return None
        idx = self._read_index()
        best = idx.get("best_g_loss")
        if fid is not None:
            best_fid = idx.get("best_fid")
            is_best = best_fid is None or fid < best_fid
        elif "best_fid" in idx:
            is_best = False
            print(f"WARNING: checkpoint epoch {epoch} saved without a FID "
                  "into a FID-tracked index — it cannot become 'best' "
                  "(align fid_interval with checkpoint_interval)", flush=True)
        else:
            is_best = g_loss is not None and (best is None or g_loss < best)
        cands = [x for x in (best, g_loss) if x is not None]
        if self.cfg.model != state.g.cfg:
            raise ValueError("cfg.model differs from the generator's own config")
        path = write_epoch(
            self._epoch_dir(epoch), self.cfg.to_json(), epoch=epoch, step=state.step,
            best_g_loss=float(min(cands)) if cands else float("inf"),
            g=bridge.to_jax(state.g), d=bridge.d_to_jax(state.d),
            g_opt=_opt_state(state.g_opt, state.g), d_opt=_opt_state(state.d_opt, state.d),
            fixed_noise=fixed_noise.detach().float().cpu().numpy(),
            g_ema=None if state.g_ema is None else bridge.to_jax(state.g_ema))
        if epoch not in idx["epochs"]:
            idx["epochs"].append(epoch)
        idx["latest"] = epoch
        if is_best:
            idx["best"] = epoch
            if fid is not None:
                idx["best_fid"] = float(fid)
            else:
                idx["best_g_loss"] = float(g_loss)
        write_index(self.dir, idx)
        return path

    def available(self) -> Dict[str, Any]:
        """The index: the saved ``epochs`` and the ``latest`` / ``best``
        aliases (with ``best_g_loss``, and ``best_fid`` once a FID was
        recorded)."""
        return self._read_index()

    def resolve(self, which: str | int = "latest") -> Optional[Path]:
        idx = self._read_index()
        epoch = which if isinstance(which, int) else idx.get(which)
        if epoch is None or epoch not in idx.get("epochs", []):
            return None
        return self._epoch_dir(epoch)

    def restore(self, which: str | int = "latest", device="cuda"):
        """(TrainState, extras) with extras {epoch, fixed_noise,
        best_g_loss}; None when nothing is saved."""
        from siggan_tpu_torch.core.state import copy_generator, create_train_state, new_lr
        path = self.resolve(which)
        if path is None:
            return None
        state = create_train_state(self.cfg, device)
        g_params, g_bn = bridge.unflatten(_load_npz(path / WEIGHTS))
        loaded = bridge.from_jax(g_params, g_bn, self.cfg.model, state.g.fc.weight.device)
        state.g.load_state_dict(loaded.state_dict())
        d_params, d_state = bridge.unflatten(_load_npz(path / D_WEIGHTS), D_STATE)
        bridge.load_params(state.d, d_params)
        bridge.load_d_state(state.d, d_state)
        opt = _load_npz(path / OPTIMIZER)
        mdt = getattr(torch, self.cfg.optim.moment_dtype)
        state.g_opt = bridge.opt_from_jax(_opt_tree("g", opt), state.g, mdt)
        state.d_opt = bridge.opt_from_jax(_opt_tree("d", opt), state.d, mdt)
        for key, o in (("g", state.g_opt), ("d", state.d_opt)):
            if f"{key}/lr" in opt:
                o["lr"] = new_lr(o["count"].device, float(opt[f"{key}/lr"]))
        # EMA: the checkpoint's shadow when the config tracks one (a copy of
        # the restored weights when the checkpoint has none); dropped at
        # ema_decay == 0.
        if self.cfg.ema_decay > 0:
            if (path / EMA_WEIGHTS).exists():
                e_params, e_bn = bridge.unflatten(_load_npz(path / EMA_WEIGHTS))
                state.g_ema = bridge.ema_from_jax({"params": e_params, "bn": e_bn},
                                                  self.cfg.model, state.g.fc.weight.device)
            else:
                state.g_ema = copy_generator(state.g)
        meta = json.loads((path / STATE).read_text())
        state.step = int(meta["step"])
        extras = {"epoch": int(meta["epoch"]), "best_g_loss": float(meta["best_g_loss"]),
                  "fixed_noise": torch.from_numpy(np.load(path / NOISE))}
        return state, extras
