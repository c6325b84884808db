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
mapping the ``latest`` and ``best`` (lowest G loss) aliases to epochs.
``load_generator`` on such a run directory loads the epoch ``which`` names
(``"latest"``, ``"best"`` or an epoch number), and serves the EMA weights
(``generator_ema.npz``) when the run has them and its config keeps EMA on,
as the JAX package's ``load_generator`` returns the shadow;
``generator.npz`` always holds the raw weights. The resume rules are the
JAX package's: a shadow missing from the checkpoint starts as a copy of
the restored weights, and one present while ``ema_decay == 0`` is dropped.
Orbax directories of the JAX package cannot be read without JAX (ROADMAP
A.2).
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


def infer_architecture(arrays: Dict[str, np.ndarray]) -> Dict[str, int]:
    """(latent_dim, image_size, base_features) from the weight shapes, as
    the JAX package's ``infer_architecture`` reads a bare tree."""
    fc_in, n_fc = arrays["fc/w"].shape
    c0 = n_fc // 16
    n_blocks = len({k.split("/")[1] for k in arrays if k.startswith("blocks/")})
    image_size = 4 * (2 ** n_blocks)
    return {"latent_dim": int(fc_in), "image_size": int(image_size),
            "base_features": int(c0 if image_size == 64 else c0 // 2)}


def _opt_arrays(prefix: str, opt: Dict, model) -> Dict[str, np.ndarray]:
    tree = bridge.opt_to_jax(opt, model)
    out = {f"{prefix}/count": np.asarray(tree["count"]),
           f"{prefix}/lr": opt["lr"].detach().cpu().numpy()}
    for k in ("m", "v"):
        for path, a in bridge.flatten(tree[k], {}).items():
            out[f"{prefix}/{k}/{path}"] = a
    return out


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
    the run's sidecar, replacing one a previous run left behind."""

    def __init__(self, directory: str | Path, cfg: TrainConfig,
                 *, authoritative: bool = False):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
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
             g_loss: Optional[float] = None) -> Path:
        """Save ``state`` as epoch ``epoch``; updates ``latest`` and, on a
        new lowest G loss, ``best``."""
        idx = self._read_index()
        best = idx.get("best_g_loss")
        is_best = g_loss is not None and (best is None or g_loss < best)
        cands = [x for x in (best, g_loss) if x is not None]
        path = self._epoch_dir(epoch)
        if path.exists():
            shutil.rmtree(path)
        save_generator(path, state.g, self.cfg)
        if state.g_ema is not None:
            np.savez(path / EMA_WEIGHTS, **bridge.flatten(*bridge.to_jax(state.g_ema)))
        np.savez(path / D_WEIGHTS, **bridge.flatten(*bridge.d_to_jax(state.d), D_STATE))
        np.savez(path / OPTIMIZER, **_opt_arrays("g", state.g_opt, state.g),
                 **_opt_arrays("d", state.d_opt, state.d))
        np.save(path / NOISE, fixed_noise.detach().float().cpu().numpy())
        (path / STATE).write_text(json.dumps({
            "step": int(state.step), "epoch": int(epoch),
            "best_g_loss": float(min(cands)) if cands else float("inf")}))
        if epoch not in idx["epochs"]:
            idx["epochs"].append(epoch)
        idx["latest"] = epoch
        if is_best:
            idx["best"] = epoch
            idx["best_g_loss"] = float(g_loss)
        (self.dir / INDEX).write_text(json.dumps(idx, indent=2))
        return path

    def available(self) -> Dict[str, Any]:
        """The index: the saved ``epochs`` and the ``latest`` / ``best``
        aliases (with ``best_g_loss``)."""
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
