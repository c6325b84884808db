"""The adversarial train step: n_critic discriminator updates, then one
generator update.

Port of the JAX package's ``train/train_step.py`` default branch
(``d_step``, ``g_step``, ``make_train_step``, ``make_resident_train_step``,
``make_eval_generate``). The same semantics:

 - one-sided label smoothing: reals 0.9, fakes 0.0, G targets 1.0; BCE from
   logits, losses and statistics in f32, convs in ``cfg.compute_dtype``;
 - fresh noise for every D step and for the G step; G runs in train mode
   (without gradients) inside the D step, and that BN update is kept, so the
   G step starts from it -- two running-stat updates per step, in order;
 - one D forward over the concatenated [real; fake] batch in the D step,
   the real half cast to the fakes' dtype; dropout masks drawn block by
   block over that 2b batch;
 - with ``packed_io`` (1-channel images) the generator emits
   ``space_to_depth(image)`` through the packed tail (kernels B1/B1') and D
   folds the unpacking into its first conv; in the D step, where G runs
   without gradient, the whole tail runs in kernel B2 when
   ``generator.fused_tail_supported(cfg.model)`` (else the module path);
 - with spectral norm, D's power-iteration vectors advance in the D step's
   D forward and again in the G step's, in that order.

Randomness: each draw comes from a generator on the training device,
re-keyed per (stream, step, sub-step) from ``core/rng.derive_seed``; the
step counter is a host integer, so no draw needs a host round trip. A step
also takes ``draws``, a bundle of injected randomness -- ``"z"``: one
latent batch per sub-step (n_critic D steps, then the G step); ``"masks"``:
per sub-step, one keep-mask per D block; ``"augment"``: (theta, scale,
flip) for the in-step augment -- so a test can run it on the JAX package's
exact randomness.

Not ported yet (raise ``NotImplementedError``): ``share_fakes``,
``fuse_g_forwards`` (BN groups), ``diffaugment``, conditional models, EMA,
LR schedules, the multi-step dispatch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.core.state import Adam, TrainState, make_optimizers
from siggan_tpu_torch.core.state import check_supported as check_optim
from siggan_tpu_torch.data.augment import augment_apply, augment_params
from siggan_tpu_torch.models.discriminator import check_supported as check_model
from siggan_tpu_torch.models.generator import fused_tail_supported
from siggan_tpu_torch.ops.packed import space_to_depth

Metrics = Dict[str, torch.Tensor]

# Metric keys every step emits (the trainer stays within this contract).
STEP_METRIC_KEYS = ("d_loss", "g_loss", "d_real_mean", "d_fake_mean",
                    "d_acc_real", "d_acc_fake", "d_on_g_mean", "d_accuracy")


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not train yet."""
    check_model(cfg.model)
    check_optim(cfg)
    for flag in ("share_fakes", "fuse_g_forwards", "diffaugment"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP A.1)")


def _dtype(cfg: TrainConfig) -> Optional[torch.dtype]:
    return getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None


def _packed(cfg: TrainConfig) -> bool:
    return (cfg.packed_io and cfg.model.image_channels == 1
            and cfg.model.image_size % 2 == 0)


def _bce_mean(logits: torch.Tensor, label: float) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy against a constant label, mean."""
    return torch.mean(-label * F.logsigmoid(logits)
                      - (1.0 - label) * F.logsigmoid(-logits))


class Streams:
    """The step's random streams: one generator per stream on ``device``,
    re-keyed per (stream, counters) before every use."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)
        self._gens: Dict[int, torch.Generator] = {}

    def __call__(self, tag: int, *counters: int) -> torch.Generator:
        gen = self._gens.get(tag)
        if gen is None:
            gen = self._gens[tag] = torch.Generator(device=self.device)
        return rng.reseed(gen, self.seed, tag, *counters)


def d_step(state: TrainState, real: torch.Tensor, z: torch.Tensor, cfg: TrainConfig,
           d_tx: Adam, *, gen: Optional[torch.Generator] = None,
           masks: Optional[List[torch.Tensor]] = None,
           real_packed: bool = False) -> Metrics:
    """One discriminator update on ``real`` and G(z); updates ``state`` in
    place (D, its moments and spectral-norm vectors, and G's BN running
    statistics)."""
    cdt, packed = _dtype(cfg), _packed(cfg)
    b = real.shape[0]
    with torch.no_grad():
        fake = state.g(z, None, cdt, train=True, packed_output=packed,
                       fused_tail=packed and fused_tail_supported(cfg.model))
    if packed and not real_packed:
        real = space_to_depth(real)
    both = torch.cat([real.to(fake.dtype), fake], dim=0)
    logits = state.d(both, train=True, compute_dtype=cdt, packed_input=packed,
                     gen=gen, masks=masks)
    logits_r, logits_f = logits[:b], logits[b:]
    loss = _bce_mean(logits_r, cfg.label_smoothing) + _bce_mean(logits_f, 0.0)
    params = list(state.d.parameters())
    d_tx.step(params, torch.autograd.grad(loss, params), state.d_opt)
    with torch.no_grad():
        p_real, p_fake = torch.sigmoid(logits_r), torch.sigmoid(logits_f)
        m = {"d_loss": loss.detach(), "d_real_mean": p_real.mean(),
             "d_fake_mean": p_fake.mean(),
             "d_acc_real": (p_real > 0.5).float().mean(),
             "d_acc_fake": (p_fake < 0.5).float().mean()}
        m["d_accuracy"] = 0.5 * (m["d_acc_real"] + m["d_acc_fake"])
    return m


def g_step(state: TrainState, z: torch.Tensor, cfg: TrainConfig, g_tx: Adam, *,
           gen: Optional[torch.Generator] = None,
           masks: Optional[List[torch.Tensor]] = None) -> Metrics:
    """One generator update (non-saturating loss through a train-mode D)."""
    cdt, packed = _dtype(cfg), _packed(cfg)
    fake = state.g(z, None, cdt, train=True, packed_output=packed)
    logits = state.d(fake, train=True, compute_dtype=cdt, packed_input=packed,
                     gen=gen, masks=masks)
    loss = _bce_mean(logits, 1.0)
    params = list(state.g.parameters())
    g_tx.step(params, torch.autograd.grad(loss, params), state.g_opt)
    with torch.no_grad():
        return {"g_loss": loss.detach(), "d_on_g_mean": torch.sigmoid(logits).mean()}


def make_train_step(cfg: TrainConfig, real_pre_packed: bool = False):
    """``train_step(state, real, draws=None) -> (state, metrics)``.

    ``real`` (b, H, W, 1) in [-1, 1] on the state's device, or, with
    ``real_pre_packed``, already augmented, cast and packed. The state is
    updated in place and returned with ``step`` advanced by one."""
    check_supported(cfg)
    if real_pre_packed and cfg.augment:
        raise ValueError("real_pre_packed implies augmentation was applied "
                         "already -- build with cfg.replace(augment=False)")
    g_tx, d_tx = make_optimizers(cfg)
    streams: Dict[str, Streams] = {}

    def train_step(state: TrainState, real: torch.Tensor,
                   draws: Optional[Dict] = None):
        draws = draws or {}
        dev = real.device
        st = streams.get(str(dev))
        if st is None:
            st = streams[str(dev)] = Streams(cfg.seed, dev)
        b, step = real.shape[0], state.step
        if cfg.augment:
            params = draws.get("augment") or augment_params(
                st(rng.STREAM_AUGMENT, step), b, hflip=cfg.hflip, device=dev)
            real = augment_apply(real, *params, dtype=_dtype(cfg))
        zs = draws.get("z")
        masks = draws.get("masks")

        def latent(i):
            if zs is not None:
                return zs[i]
            return torch.randn((b, cfg.model.latent_dim),
                               generator=st(rng.STREAM_NOISE, step, i), device=dev)

        def dropout(i):
            if masks is not None:
                return {"masks": masks[i]}
            return {"gen": st(rng.STREAM_DROPOUT, step, i)}

        metrics: Metrics = {}
        for i in range(cfg.n_critic):
            metrics = d_step(state, real, latent(i), cfg, d_tx,
                             real_packed=real_pre_packed, **dropout(i))
        metrics.update(g_step(state, latent(cfg.n_critic), cfg, g_tx,
                              **dropout(cfg.n_critic)))
        state.step += 1
        return state, metrics

    return train_step


def _warp_gathered(cfg: TrainConfig, real: torch.Tensor, theta, scale, flip,
                   idx: torch.Tensor) -> torch.Tensor:
    """Warp a gathered batch with its epoch's per-image parameters, then
    cast and pack it (per-image warps are independent, so this equals
    warping the whole set and gathering)."""
    dt = _dtype(cfg)
    real = augment_apply(real, theta[idx], scale[idx],
                         None if flip is None else flip[idx], dtype=dt)
    if dt is not None:
        real = real.to(dt)
    return space_to_depth(real) if _packed(cfg) else real


def make_resident_train_step(cfg: TrainConfig, n_images: int):
    """A train step over a device-resident dataset: ``(state, images,
    draws=None) -> (state, metrics)`` with ``images`` the whole (N, H, W, 1)
    set on the device; returns ``(step_fn, steps_per_epoch)``.

    Batch selection follows the step counter: epoch = step //
    steps_per_epoch, a per-epoch permutation on the device (each image once
    per epoch, remainder dropped), and a slice of it. With augmentation
    (``augment_bulk``, the default) the transform is keyed per epoch: the
    epoch's per-image parameters are drawn once and only the gathered batch
    is warped. Both tables are made when the epoch changes."""
    steps_per_epoch = n_images // cfg.batch_size
    if steps_per_epoch < 1:
        raise ValueError(f"dataset ({n_images}) smaller than the batch ({cfg.batch_size})")
    bulk = bool(cfg.augment and cfg.augment_bulk)
    inner = cfg.replace(augment=False) if bulk else cfg
    base_step = make_train_step(inner, real_pre_packed=bulk and _packed(cfg))
    cache: Dict[str, object] = {"epoch": None}

    def train_step(state: TrainState, images: torch.Tensor,
                   draws: Optional[Dict] = None):
        epoch, bidx = divmod(state.step, steps_per_epoch)
        if cache["epoch"] != epoch:
            st = Streams(cfg.seed, images.device)
            cache["perm"] = torch.randperm(n_images, generator=st(rng.STREAM_DATA, epoch),
                                           device=images.device)
            if bulk:
                cache["aug"] = augment_params(st(rng.STREAM_AUGMENT, epoch), n_images,
                                              hflip=cfg.hflip, device=images.device)
            cache["epoch"] = epoch
        idx = cache["perm"][bidx * cfg.batch_size:(bidx + 1) * cfg.batch_size]
        real = images[idx]
        if bulk:
            real = _warp_gathered(cfg, real, *cache["aug"], idx)
        return base_step(state, real, draws)

    return train_step, steps_per_epoch


def make_eval_generate(cfg: TrainConfig):
    """Inference-mode generation: ``(state, z) -> images`` f32 in [-1, 1]
    (the generator module in eval mode, in the compute dtype)."""
    def generate(state: TrainState, z: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return state.g(z, None, _dtype(cfg)).float()
    return generate
