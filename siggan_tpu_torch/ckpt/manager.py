"""The port's generator checkpoint: a directory holding

  config.json     the ``TrainConfig`` sidecar, the JAX package's schema
  generator.npz   the generator in JAX layouts, keyed by tree path
                  (``fc/w``, ``blocks/0/w``, ``bn/blocks/0/mean``, ...)

The JAX package's Orbax directories cannot be read without JAX; a JAX-side
export writes the same two files from ``(g_params, g_bn)`` with
``bridge.flatten``. Loading goes through the bridge.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from siggan_tpu_torch import bridge
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.models.generator import Generator

SIDECAR = "config.json"
WEIGHTS = "generator.npz"


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


def load_arrays(directory: str | Path) -> Dict[str, np.ndarray]:
    path = Path(directory) / WEIGHTS
    if not path.exists():
        raise FileNotFoundError(f"no {WEIGHTS} under {directory}")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def load_generator(directory: str | Path, device) -> Tuple[Generator, TrainConfig]:
    """(Generator on ``device``, TrainConfig) from a port checkpoint."""
    cfg = load_config(directory)
    g_params, g_bn = bridge.unflatten(load_arrays(directory))
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
