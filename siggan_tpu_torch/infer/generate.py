"""Seeded batched generation: the inference engine behind the CLI and API.

Port of the JAX package's ``infer/generate.py``. Each batch draws its labels
and latents from its own generator, derived from (seed, ``STREAM_EVAL``,
batch index), so a seed gives the same images whatever ``n`` is asked for
(but not the JAX package's images: its threefry bits differ).

For 64 px unconditional ReLU models with ``use_pallas`` set, every batch
goes through the hand-written generator kernel (``ops/kernels/
generator_fwd.py``); otherwise the ``Generator`` module runs (cuDNN on the
card) in ``compute_dtype``. The kernel takes any batch size.
``score_with_discriminator`` gives a discriminator's D(x) probabilities,
the quality filter of the JAX package's session.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.eval.common import full_f32
from siggan_tpu_torch.models.discriminator import Discriminator
from siggan_tpu_torch.models.generator import Generator, generate_latent
from siggan_tpu_torch.ops.kernels.generator_fwd import (
    generator_forward, kernel_supported, pack_generator)
from siggan_tpu_torch.utils.visualizer import to_uint8


class GeneratorSession:
    """A loaded generator ready for repeated batched sampling."""

    def __init__(self, model: Generator, *, compute_dtype: Optional[str] = "bfloat16",
                 use_pallas: bool = False, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.compute_dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.uses_kernel = use_pallas and kernel_supported(self.cfg)
        self._packed = pack_generator(self.model) if self.uses_kernel else None

    def _fwd(self, z: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.inference_mode():
            if self.uses_kernel:
                return generator_forward(self._packed, z)
            return self.model(z, y, self.compute_dtype).float()

    def sample(self, n: int, *, seed: int = 42, noise_scale: float = 1.0,
               batch_size: int = 64,
               progress: Optional[Callable[[int, int], None]] = None,
               class_id: Optional[int] = None) -> np.ndarray:
        """Generate n images, (n, H, W, C) float32 in [-1, 1].

        ``class_id``: for conditional checkpoints, generate this class; None
        draws a uniform class per image (or runs unconditionally).
        """
        conditional = self.cfg.num_classes > 0
        if class_id is not None:
            if not conditional:
                raise ValueError(
                    "class_id given but this checkpoint is unconditional "
                    "(num_classes == 0) — it would be silently ignored")
            if not 0 <= class_id < self.cfg.num_classes:
                raise ValueError(
                    f"class_id {class_id} out of range for "
                    f"num_classes={self.cfg.num_classes}")
        outs = []
        done = 0
        for bidx in range(-(-n // batch_size)):
            take = min(batch_size, n - done)
            g = rng.generator(seed, rng.STREAM_EVAL, bidx)
            y = None
            if conditional:
                if class_id is not None:
                    y = torch.full((batch_size,), class_id, dtype=torch.long)
                else:
                    y = torch.randint(0, self.cfg.num_classes, (batch_size,),
                                      generator=g)
                y = y[:take].to(self.device)
            z = generate_latent(g, batch_size, self.cfg, noise_scale)
            outs.append(self._fwd(z[:take].to(self.device), y))
            done += take
            if progress is not None:
                progress(done, n)
        return torch.cat(outs).cpu().numpy()

    def sample_uint8(self, n: int, **kw) -> np.ndarray:
        return to_uint8(self.sample(n, **kw))

    def interpolate(self, *, seed: int = 0, steps: int = 10,
                    z1: Optional[np.ndarray] = None,
                    z2: Optional[np.ndarray] = None,
                    class_id: Optional[int] = None) -> np.ndarray:
        """Linear interpolation between two latents -> (steps, H, W, C).

        Conditional checkpoints walk within one class (``class_id``,
        default 0)."""
        if z1 is None or z2 is None:
            g = rng.generator(seed, rng.STREAM_EVAL)
            z1 = generate_latent(g, 1, self.cfg)[0]
            z2 = generate_latent(g, 1, self.cfg)[0]
        z1 = torch.as_tensor(np.asarray(z1, np.float32))
        z2 = torch.as_tensor(np.asarray(z2, np.float32))
        alphas = torch.linspace(0.0, 1.0, steps)[:, None]
        zs = ((1 - alphas) * z1[None] + alphas * z2[None]).to(self.device)
        if self.cfg.num_classes > 0:
            cid = 0 if class_id is None else class_id
            if not 0 <= cid < self.cfg.num_classes:
                raise ValueError(f"class_id {cid} out of range for "
                                 f"num_classes={self.cfg.num_classes}")
            y = torch.full((steps,), cid, dtype=torch.long, device=self.device)
            return self._fwd(zs, y).cpu().numpy()
        if class_id is not None:
            raise ValueError("class_id given but this checkpoint is "
                             "unconditional (num_classes == 0)")
        return self._fwd(zs).cpu().numpy()

    def score_with_discriminator(self, images: np.ndarray, discriminator: Discriminator,
                                 y: Optional[np.ndarray] = None) -> np.ndarray:
        """D(x) probabilities (N,) of (N, H, W, C) images in [-1, 1] for
        quality filtering (JAX ``infer/generate.py:143-159``): the
        discriminator in eval mode (no dropout, spectral norm from its
        stored u's) in f32 with TF32 off, on the discriminator's own
        device.

        Conditional checkpoints (projection D) need the labels the images
        were generated with: callers must pass ``y``."""
        if discriminator.cfg.num_classes > 0 and y is None:
            raise ValueError(
                "conditional discriminator scoring requires labels y — "
                "generate with an explicit class_id to use the quality "
                "filter on a conditional checkpoint")
        dev = next(discriminator.parameters()).device
        x = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
        labels = None if y is None else torch.as_tensor(np.asarray(y), dtype=torch.long).to(dev)
        with torch.inference_mode(), full_f32():
            logits = discriminator(x, train=False, y=labels)
        return torch.sigmoid(logits)[:, 0].cpu().numpy()


def load_session(checkpoint_dir: str, which: str | int = "latest",
                 device: DeviceLike = "cuda") -> GeneratorSession:
    """A session on ``device`` for a port checkpoint (``ckpt/manager.py``):
    a generator checkpoint, or the epoch ``which`` names in a run directory
    (``"latest"``, ``"best"`` or an epoch number); the EMA weights when the
    run tracks them (``load_generator``)."""
    from siggan_tpu_torch.ckpt.manager import load_generator
    dev = resolve_device(device)
    model, cfg = load_generator(checkpoint_dir, dev, which)
    return GeneratorSession(model, compute_dtype=cfg.compute_dtype,
                            use_pallas=cfg.use_pallas, device=dev)
