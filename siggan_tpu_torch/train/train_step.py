"""The adversarial train step: n_critic discriminator updates, then one
generator update.

Port of the JAX package's ``train/train_step.py`` default branch
(``d_step``, ``g_step``, ``make_train_step``, ``make_resident_train_step``,
``make_resident_multi_step``, ``make_eval_generate``). The same semantics:

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
   D forward and again in the G step's, in that order;
 - with ``log_grad_norms`` the D and G steps also emit ``d_grad_norm`` /
   ``g_grad_norm``, the global norm of the raw gradients (before clipping);
 - conditional models (``num_classes > 0``): the real batch comes with its
   labels, each sub-step draws its fake labels (``_fake_labels``: a
   permutation of ``arange(b) % num_classes`` with
   ``class_balanced_fakes``, else uniform), G takes them and D sees
   ``[y_real; y_fake]`` (projection head); with the AC-GAN head
   (``aux_classifier`` and ``aux_weight > 0``) D adds ``aux_weight`` times
   the cross-entropy of its class logits on the reals (and on the fakes
   with ``aux_d_on_fakes``) and emits ``aux_acc_real``, and G adds it on
   its fakes;
 - ``diffaugment``: the policy (``ops/diffaug.py``) transforms the D step's
   [real; fake] batch of 2b images and, inside the gradient, the G step's
   fakes;
 - LR schedules are device values of Adam's count (``core/state.py``), and
   with ``ema_decay > 0`` the EMA shadow follows G after each G update.

Randomness: each draw comes from a generator on the training device,
re-keyed per (stream, step, sub-step) from ``core/rng.derive_seed``; the
step counter is a host integer, so no draw needs a host round trip.
``step_draws`` makes all of a step's draws up front, in the order and with
the keys the step uses them -- the augment parameters (per-step
augmentation only), one latent batch per sub-step (n_critic D steps, then
the G step), per sub-step the fake labels of a conditional model, the
uniforms of one keep-mask per D block, drawn as D would draw them, and the
DiffAugment parameters of the sub-step's images. A step also takes
``draws``, injected randomness (``"augment"``, ``"z"``, ``"masks"``: per
sub-step, one bool keep-mask per D block, ``"y"``, ``"diffaug"``), so a
test can run it on the JAX package's exact randomness.

``make_resident_multi_step`` runs K steps per call. On the CPU that is K
eager steps. On the card one step is captured as
a CUDA graph and replayed K times (``_GraphedSteps``): the window's draws
and its epoch's tables are made outside the graph, with the eager step's
keys, into buffers the graph reads, so graphed and eager steps see the same
numbers.

Not ported yet (raise ``NotImplementedError``): ``share_fakes`` and
``fuse_g_forwards`` (BN groups).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.core.state import (Adam, TrainState, ema_tensors, ema_update,
                                         eval_generator_weights, global_norm,
                                         make_optimizers)
from siggan_tpu_torch.data.augment import augment_apply, augment_params
from siggan_tpu_torch.models.discriminator import channel_schedule as d_channels
from siggan_tpu_torch.models.generator import fused_tail_supported
from siggan_tpu_torch.ops import diffaug
from siggan_tpu_torch.ops.kernels import build
from siggan_tpu_torch.ops.packed import space_to_depth
from siggan_tpu_torch.ops.regularizers import keep_mask

Metrics = Dict[str, torch.Tensor]

# Metric keys every step emits, as in the JAX package; ``log_grad_norms``
# adds d_grad_norm and g_grad_norm, the AC-GAN head aux_acc_real (the
# trainer logs every key).
STEP_METRIC_KEYS = ("d_loss", "g_loss", "d_real_mean", "d_fake_mean",
                    "d_acc_real", "d_acc_fake", "d_on_g_mean", "d_accuracy")


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not train yet
    (and ``ValueError`` for an unknown DiffAugment policy)."""
    for flag in ("share_fakes", "fuse_g_forwards"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP A.1.4)")
    diffaug.policies(cfg.diffaugment)


def _aux_on(cfg: TrainConfig) -> bool:
    return cfg.model.num_classes > 0 and cfg.model.aux_classifier and cfg.aux_weight > 0


def _dtype(cfg: TrainConfig) -> Optional[torch.dtype]:
    return getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None


def _packed(cfg: TrainConfig) -> bool:
    return (cfg.packed_io and cfg.model.image_channels == 1
            and cfg.model.image_size % 2 == 0)


def _bce_mean(logits: torch.Tensor, label: float) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy against a constant label, mean."""
    return torch.mean(-label * F.logsigmoid(logits)
                      - (1.0 - label) * F.logsigmoid(-logits))


def _ce_mean(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels in f32, mean."""
    return F.cross_entropy(logits.float(), y)


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
           real_packed: bool = False, y_real: Optional[torch.Tensor] = None,
           y_fake: Optional[torch.Tensor] = None,
           diffaug_params: Optional[Sequence[diffaug.Params]] = None) -> Metrics:
    """One discriminator update on ``real`` (labels ``y_real``) and G(z)
    (labels ``y_fake``), the pair through DiffAugment with
    ``diffaug_params`` when configured; updates ``state`` in place (D, its
    moments and spectral-norm vectors, and G's BN running statistics)."""
    cdt, packed = _dtype(cfg), _packed(cfg)
    b = real.shape[0]
    conditional = cfg.model.num_classes > 0
    with torch.no_grad():
        fake = state.g(z, y_fake, cdt, train=True, packed_output=packed,
                       fused_tail=packed and fused_tail_supported(cfg.model))
    if packed and not real_packed:
        real = space_to_depth(real)
    both = torch.cat([real.to(fake.dtype), fake], dim=0)
    if cfg.diffaugment:
        both = diffaug.apply(both, diffaug_params, cfg.diffaugment, packed)
    aux_on = _aux_on(cfg)
    out = state.d(both, train=True, compute_dtype=cdt, packed_input=packed,
                  gen=gen, masks=masks, aux=aux_on,
                  y=torch.cat([y_real, y_fake]) if conditional else None)
    logits, aux_logits = out if aux_on else (out, None)
    logits_r, logits_f = logits[:b], logits[b:]
    loss = _bce_mean(logits_r, cfg.label_smoothing) + _bce_mean(logits_f, 0.0)
    if aux_on:
        aux_loss = _ce_mean(aux_logits[:b], y_real)
        if cfg.aux_d_on_fakes:
            aux_loss = aux_loss + _ce_mean(aux_logits[b:], y_fake)
        loss = loss + cfg.aux_weight * aux_loss
    params = list(state.d.parameters())
    grads = torch.autograd.grad(loss, params)
    d_tx.step(params, grads, state.d_opt)
    with torch.no_grad():
        p_real, p_fake = torch.sigmoid(logits_r), torch.sigmoid(logits_f)
        m = {"d_loss": loss.detach(), "d_real_mean": p_real.mean(),
             "d_fake_mean": p_fake.mean(),
             "d_acc_real": (p_real > 0.5).float().mean(),
             "d_acc_fake": (p_fake < 0.5).float().mean()}
        if cfg.log_grad_norms:
            m["d_grad_norm"] = global_norm(grads)
        if aux_on:
            m["aux_acc_real"] = (aux_logits[:b].argmax(-1) == y_real).float().mean()
        m["d_accuracy"] = 0.5 * (m["d_acc_real"] + m["d_acc_fake"])
    return m


def g_step(state: TrainState, z: torch.Tensor, cfg: TrainConfig, g_tx: Adam, *,
           gen: Optional[torch.Generator] = None,
           masks: Optional[List[torch.Tensor]] = None, y: Optional[torch.Tensor] = None,
           diffaug_params: Optional[Sequence[diffaug.Params]] = None) -> Metrics:
    """One generator update (non-saturating loss through a train-mode D,
    its fakes labelled ``y`` and through DiffAugment when configured), then
    the EMA shadow's update when ``ema_decay > 0``."""
    cdt, packed = _dtype(cfg), _packed(cfg)
    aux_on = _aux_on(cfg)
    fake = state.g(z, y, cdt, train=True, packed_output=packed)
    if cfg.diffaugment:
        fake = diffaug.apply(fake, diffaug_params, cfg.diffaugment, packed)
    out = state.d(fake, train=True, compute_dtype=cdt, packed_input=packed,
                  gen=gen, masks=masks, y=y, aux=aux_on)
    logits, aux_logits = out if aux_on else (out, None)
    loss = _bce_mean(logits, 1.0)
    if aux_on:
        loss = loss + cfg.aux_weight * _ce_mean(aux_logits, y)
    params = list(state.g.parameters())
    grads = torch.autograd.grad(loss, params)
    g_tx.step(params, grads, state.g_opt)
    if cfg.ema_decay > 0:
        ema_update(state.g_ema, state.g, cfg.ema_decay)
    with torch.no_grad():
        m = {"g_loss": loss.detach(), "d_on_g_mean": torch.sigmoid(logits).mean()}
        if cfg.log_grad_norms:
            m["g_grad_norm"] = global_norm(grads)
        return m


def _fake_labels(cfg: TrainConfig, b: int, gen: torch.Generator, device,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fakes' labels of a sub-step (int64): a random permutation of
    ``arange(b) % num_classes`` with ``class_balanced_fakes`` (every class
    in every batch), else uniform draws."""
    nc = cfg.model.num_classes
    if cfg.class_balanced_fakes:
        # A permutation of arange(b) % nc is the permutation's values % nc.
        y = (torch.randperm(b, generator=gen, device=device) if out is None
             else torch.randperm(b, generator=gen, out=out))
        return y.remainder_(nc)
    if out is None:
        return torch.randint(0, nc, (b,), generator=gen, device=device)
    return torch.randint(0, nc, (b,), generator=gen, out=out)


def step_draws(cfg: TrainConfig, st: Streams, step: int, b: int, device,
               out: Optional[Dict] = None) -> Dict:
    """All the randomness of train step ``step`` at batch ``b``, from the
    streams ``st`` keyed as the step keys them: ``"augment"`` (theta, scale,
    flip) when ``cfg.augment``, ``"z"`` one latent batch per sub-step,
    ``"y"`` (conditional models) the fakes' labels per sub-step, ``"u"``
    per sub-step the uniforms of D's keep-masks, one (n, 1, 1, C) tensor per
    block in block order (n = 2b in a D step, b in the G step), drawn from
    one generator as D draws them (empty without dropout), and
    ``"diffaug"`` (with ``cfg.diffaugment``) per sub-step the DiffAugment
    parameters of its n images. ``out``, a dict of the same structure,
    receives the draws in place."""
    def fill(fn, shape, gen, dst):
        if dst is None:
            return fn(shape, generator=gen, device=device)
        return fn(shape, generator=gen, out=dst)

    def dst(key, i):
        return None if out is None else out[key][i]

    n_sub = cfg.n_critic + 1
    conditional = cfg.model.num_classes > 0
    draws: Dict = {"z": [], "u": []}
    if conditional:
        draws["y"] = []
    if cfg.diffaugment:
        draws["diffaug"] = []
    if cfg.augment:
        draws["augment"] = augment_params(st(rng.STREAM_AUGMENT, step), b,
                                          hflip=cfg.hflip, device=device)
        if out is not None:
            for d, src in zip(out["augment"], draws["augment"]):
                if src is not None:
                    d.copy_(src)
    widths = [co for _, co in d_channels(cfg.model)] if cfg.model.dropout > 0 else []
    for i in range(n_sub):
        draws["z"].append(fill(torch.randn, (b, cfg.model.latent_dim),
                               st(rng.STREAM_NOISE, step, i), dst("z", i)))
        if conditional:
            draws["y"].append(_fake_labels(cfg, b, st(rng.STREAM_NOISE, step, i, 1), device,
                                           dst("y", i)))
        gen = st(rng.STREAM_DROPOUT, step, i)
        n = 2 * b if i < cfg.n_critic else b
        draws["u"].append([fill(torch.rand, (n, 1, 1, c), gen,
                                None if out is None else out["u"][i][j])
                           for j, c in enumerate(widths)])
        if cfg.diffaugment:
            draws["diffaug"].append(diffaug.draw(
                cfg.diffaugment, n, cfg.model.image_size, st(rng.STREAM_DROPOUT, step, i, 7),
                device, dst("diffaug", i)))
    return draws


def _map_draws(fn, draws):
    """``step_draws``' structure (dicts, lists, tuples, None) with ``fn``
    applied to every tensor."""
    if isinstance(draws, dict):
        return {k: _map_draws(fn, v) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return type(draws)(_map_draws(fn, v) for v in draws)
    return None if draws is None else fn(draws)


def _draw_keys(cfg: TrainConfig) -> set:
    """The keys of a step's complete draws."""
    keys = {"z", "masks"}
    for key, on in (("augment", cfg.augment), ("y", cfg.model.num_classes > 0),
                    ("diffaug", bool(cfg.diffaugment))):
        if on:
            keys.add(key)
    return keys


def _keep_masks(cfg: TrainConfig, u: Sequence[Sequence[torch.Tensor]]):
    """Per sub-step, D's keep-masks from its uniforms (None without dropout)."""
    return [[keep_mask(t, cfg.model.dropout) for t in ui] if ui else None for ui in u]


def _run_step(cfg: TrainConfig, d_tx: Adam, g_tx: Adam, real_packed: bool,
              state: TrainState, real: torch.Tensor, draws: Dict,
              y_real: Optional[torch.Tensor] = None) -> Metrics:
    """One iteration on complete draws: the per-step augmentation (when
    ``cfg.augment``), n_critic D steps, then the G step. Reads and updates
    only device tensors (what a CUDA graph of it captures); ``state.step``
    is left to the caller."""
    if cfg.augment:
        real = augment_apply(real, *draws["augment"], dtype=_dtype(cfg))
    zs, masks = draws["z"], draws["masks"]
    ys = draws.get("y") or [None] * len(zs)
    das = draws.get("diffaug") or [None] * len(zs)
    metrics: Metrics = {}
    for i in range(cfg.n_critic):
        metrics = d_step(state, real, zs[i], cfg, d_tx, masks=masks[i],
                         real_packed=real_packed, y_real=y_real, y_fake=ys[i],
                         diffaug_params=das[i])
    n = cfg.n_critic
    metrics.update(g_step(state, zs[n], cfg, g_tx, masks=masks[n], y=ys[n],
                          diffaug_params=das[n]))
    return metrics


def make_train_step(cfg: TrainConfig, real_pre_packed: bool = False):
    """``train_step(state, real, draws=None, y_real=None) -> (state,
    metrics)``.

    ``real`` (b, H, W, 1) in [-1, 1] on the state's device, or, with
    ``real_pre_packed``, already augmented, cast and packed; ``y_real`` its
    labels, required by a conditional model. The state is updated in place
    and returned with ``step`` advanced by one. What ``draws`` does not
    inject is drawn by ``step_draws``."""
    check_supported(cfg)
    if real_pre_packed and cfg.augment:
        raise ValueError("real_pre_packed implies augmentation was applied "
                         "already -- build with cfg.replace(augment=False)")
    g_tx, d_tx = make_optimizers(cfg)
    streams: Dict[str, Streams] = {}

    conditional = cfg.model.num_classes > 0
    need = _draw_keys(cfg)

    def train_step(state: TrainState, real: torch.Tensor,
                   draws: Optional[Dict] = None, y_real: Optional[torch.Tensor] = None):
        if conditional and y_real is None:
            raise ValueError("a conditional model trains on labelled batches: pass y_real")
        draws = dict(draws or {})
        dev = real.device
        if not need <= draws.keys():
            st = streams.get(str(dev))
            if st is None:
                st = streams[str(dev)] = Streams(cfg.seed, dev)
            drawn = step_draws(cfg, st, state.step, real.shape[0], dev)
            drawn["masks"] = _keep_masks(cfg, drawn.pop("u"))
            draws = {**drawn, **draws}
        metrics = _run_step(cfg, d_tx, g_tx, real_pre_packed, state, real, draws,
                            None if y_real is None else y_real.long())
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


def _bulk(cfg: TrainConfig) -> bool:
    return bool(cfg.augment and cfg.augment_bulk)


def _inner(cfg: TrainConfig):
    """(config of the step on a gathered batch, whether that batch comes
    augmented and packed): with bulk augmentation the resident step warps
    and packs the batch itself."""
    bulk = _bulk(cfg)
    return (cfg.replace(augment=False) if bulk else cfg), bulk and _packed(cfg)


def _epoch_tables(cfg: TrainConfig, n_images: int, epoch: int, device):
    """(permutation, augment parameters or None) of ``epoch``: the order in
    which the epoch visits the resident set, and with bulk augmentation
    each image's (theta, scale, flip) for the epoch."""
    st = Streams(cfg.seed, device)
    perm = torch.randperm(n_images, generator=st(rng.STREAM_DATA, epoch), device=device)
    aug = (augment_params(st(rng.STREAM_AUGMENT, epoch), n_images, hflip=cfg.hflip,
                          device=device) if _bulk(cfg) else None)
    return perm, aug


def make_resident_train_step(cfg: TrainConfig, n_images: int):
    """A train step over a device-resident dataset: ``(state, images,
    draws=None, labels=None) -> (state, metrics)`` with ``images`` the whole
    (N, H, W, 1) set on the device and, for a conditional model, ``labels``
    its (N,) labels there, gathered with the batch; returns ``(step_fn,
    steps_per_epoch)``.

    Batch selection follows the step counter: epoch = step //
    steps_per_epoch, a per-epoch permutation on the device (each image once
    per epoch, remainder dropped), and a slice of it. With augmentation
    (``augment_bulk``, the default) the transform is keyed per epoch: the
    epoch's per-image parameters are drawn once and only the gathered batch
    is warped. Both tables are made when the epoch changes."""
    steps_per_epoch = n_images // cfg.batch_size
    if steps_per_epoch < 1:
        raise ValueError(f"dataset ({n_images}) smaller than the batch ({cfg.batch_size})")
    bulk = _bulk(cfg)
    base_step = make_train_step(*_inner(cfg))
    cache: Dict[str, object] = {"epoch": None}

    def train_step(state: TrainState, images: torch.Tensor,
                   draws: Optional[Dict] = None, labels: Optional[torch.Tensor] = None):
        epoch, bidx = divmod(state.step, steps_per_epoch)
        if cache["epoch"] != epoch:
            cache["perm"], cache["aug"] = _epoch_tables(cfg, n_images, epoch, images.device)
            cache["epoch"] = epoch
        idx = cache["perm"][bidx * cfg.batch_size:(bidx + 1) * cfg.batch_size]
        real = images[idx]
        if bulk:
            real = _warp_gathered(cfg, real, *cache["aug"], idx)
        return base_step(state, real, draws, None if labels is None else labels[idx])

    return train_step, steps_per_epoch


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of ``state`` that a step reads or writes: G's and D's
    parameters and buffers (BN running statistics, spectral-norm vectors),
    the EMA shadow's, and both optimizer states, in a fixed order."""
    out = [*state.g.parameters(), *state.g.buffers(), *state.d.parameters(),
           *state.d.buffers()]
    if state.g_ema is not None:
        out += ema_tensors(state.g_ema)
    for opt in (state.g_opt, state.d_opt):
        out += [opt["count"], opt["lr"], *opt["m"], *opt["v"]]
    return out


class _GraphedSteps:
    """K resident steps per call on the card: one step captured as a CUDA
    graph and replayed K times.

    One graph of one step, not one of K: capture time and the graph's node
    count stay those of a step whatever K is (K reaches a whole epoch when
    steps_per_epoch has no divisor in [16, 64]), and the memory is one
    step's either way. The graph reads the window's draws, its batch
    indices and the epoch's augment tables from buffers filled before the
    replays (``step_draws`` and ``epoch_tables`` with the eager step's
    keys), finds its row through a device counter it advances (and a
    conditional model's labels through the same rows), and writes its
    metrics into row ``slot`` of a (K, keys) buffer. The learning rates are
    device values of Adam's counts, so they follow the schedule on every
    replay.

    The first ``WARMUP`` steps of the run are eager steps on a side stream,
    real steps of the training: they build the kernels' plans and let
    cuDNN, cuBLAS and the autograd engine set up outside the capture. The
    graph is bound to the first state's tensors and to ``images``; a state
    whose tensors are others (a resumed or restored one) is copied into the
    bound storage, and the bound state is returned. A capture launches
    nothing, so the kernels' launch counts it records are taken back, and
    every replay adds them."""

    WARMUP = 2

    def __init__(self, cfg: TrainConfig, n_images: int, k: int, eager_step):
        self.cfg, self.n_images, self.k = cfg, n_images, k
        self.spe = n_images // cfg.batch_size
        self.inner, self.real_packed = _inner(cfg)
        self.g_tx, self.d_tx = make_optimizers(cfg)
        self.eager_step = eager_step
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.bound: Optional[TrainState] = None
        self.warm = 0
        self.capture_s: Optional[float] = None
        self.delta: List[int] = []

    def _allocate(self, state: TrainState, images: torch.Tensor,
                  labels: Optional[torch.Tensor]) -> None:
        cfg, k, b, dev = self.inner, self.k, self.cfg.batch_size, images.device
        self.bound, self.images, self.tensors = state, images, state_tensors(state)
        self.labels = labels
        self.streams = Streams(cfg.seed, dev)
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.epoch = None
        self.perm = torch.empty(self.n_images, dtype=torch.long, device=dev)
        self.rows = torch.empty((k, b), dtype=torch.long, device=dev)
        self.slot = torch.zeros(1, dtype=torch.long, device=dev)
        self.aug = None
        if _bulk(self.cfg):
            n = self.n_images
            self.aug = (torch.empty(n, device=dev), torch.empty(n, device=dev),
                        torch.empty(n, dtype=torch.bool, device=dev) if self.cfg.hflip else None)
        # One (K, ...) buffer per draw of a step, shaped by step_draws itself.
        self.draws = _map_draws(lambda t: t.new_empty((k, *t.shape)),
                                step_draws(cfg, self.streams, 0, b, dev))

    def _bind(self, state: TrainState, images: torch.Tensor,
              labels: Optional[torch.Tensor]) -> TrainState:
        if self.bound is None:
            self._allocate(state, images, labels)
            return state
        if images is not self.images or labels is not self.labels:
            raise ValueError("the train step's graph was built on other images or labels")
        now = state_tensors(state)
        if len(now) != len(self.tensors):
            raise ValueError("the state's tensors are not those of the bound state's kind")
        if all(a is b for a, b in zip(now, self.tensors)):
            return state
        if state is self.bound:
            raise RuntimeError("tensors of the state bound to the train step's graph were "
                               "replaced; pass a new TrainState to the step instead")
        with torch.no_grad():
            torch._foreach_copy_(self.tensors, now)
        self.bound.step = state.step
        return self.bound

    def _fill(self, step0: int) -> None:
        """The window's buffers: its epoch's tables (when the epoch changed),
        its K batches' rows of the permutation, and its K steps' draws."""
        b = self.cfg.batch_size
        epoch, bidx = divmod(step0, self.spe)
        if self.epoch != epoch:
            perm, aug = _epoch_tables(self.cfg, self.n_images, epoch, self.images.device)
            self.perm.copy_(perm)
            for dst, src in zip(self.aug or (), aug or ()):
                if dst is not None:
                    dst.copy_(src)
            self.epoch = epoch
        self.rows.copy_(self.perm[bidx * b:(bidx + self.k) * b].view(self.k, b))
        for s in range(self.k):
            step_draws(self.inner, self.streams, step0 + s, b, self.images.device,
                       out=_map_draws(lambda t: t[s], self.draws))
        self.slot.zero_()

    def _step(self, state: TrainState) -> Metrics:
        """The captured step: batch, draws and metrics through ``slot``."""
        idx = self.rows.index_select(0, self.slot).view(-1)
        real = self.images[idx]
        if self.aug is not None:
            real = _warp_gathered(self.cfg, real, *self.aug, idx)
        draws = _map_draws(lambda t: t.index_select(0, self.slot)[0], self.draws)
        draws["masks"] = _keep_masks(self.inner, draws.pop("u"))
        metrics = _run_step(self.inner, self.d_tx, self.g_tx, self.real_packed, state,
                            real, draws, None if self.labels is None else self.labels[idx])
        self.metrics.index_copy_(0, self.slot,
                                 torch.stack([metrics[k].float() for k in self.keys])[None])
        self.slot.add_(1)
        return metrics

    def _capture(self, state: TrainState) -> None:
        before = build.launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self._step(state)
        torch.cuda.synchronize(self.images.device)
        self.capture_s = time.perf_counter() - t0
        self.delta = [a - b for a, b in zip(build.launch_counts(), before)]
        build.add_launches(self.delta, -1)

    @contextlib.contextmanager
    def _side_stream(self):
        """Run the body on the side stream, ordered after and before the
        current stream's work (a no-op off the card)."""
        if self.stream is None:
            yield
            return
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def __call__(self, state: TrainState, images: torch.Tensor,
                 labels: Optional[torch.Tensor] = None):
        step0 = state.step
        if step0 % self.spe + self.k > self.spe:
            raise ValueError(f"a window of {self.k} steps from step {step0} crosses an "
                             f"epoch of {self.spe} steps")
        state = self._bind(state, images, labels)
        self._fill(step0)
        replays = 0
        for s in range(self.k):
            if self.graph is None and self.warm < self.WARMUP:
                # Eager warm-up step on the side stream: a real step of the run.
                with self._side_stream():
                    state, m = self.eager_step(state, images, labels=labels)
                    if self.warm == 0:
                        self.keys = list(m)
                        self.metrics = torch.zeros((self.k, len(self.keys)),
                                                   device=images.device)
                    self.metrics[s] = torch.stack([m[key].float() for key in self.keys])
                    self.slot.add_(1)
                self.warm += 1
                continue
            if self.graph is None:
                self._capture(state)
            self.graph.replay()
            replays += 1
        build.add_launches(self.delta, replays)
        state.step = step0 + self.k
        rows = self.metrics.clone()
        return state, {key: rows[:, i] for i, key in enumerate(self.keys)}


def make_resident_multi_step(cfg: TrainConfig, n_images: int, scan_steps: int):
    """K = ``scan_steps`` resident train steps per call: ``(state, images,
    labels=None) -> (state, metrics)`` (``labels`` the resident (N,) labels
    of a conditional model) with each metric stacked to shape (K,); returns
    ``(multi_step, steps_per_epoch)``. K must divide steps_per_epoch, so
    that a window started at an epoch boundary stays within its epoch.

    On CUDA tensors the steps replay a CUDA graph of one step
    (``multi_step.graphed``, a ``_GraphedSteps``), on the same batches and
    draws as K calls of ``make_resident_train_step``; the returned state is
    the one the graph is bound to. On CPU tensors it runs K eager steps of
    ``make_resident_train_step``, which is also the eager route on the card
    (for debugging)."""
    step_fn, spe = make_resident_train_step(cfg, n_images)
    if scan_steps < 1 or spe % scan_steps:
        raise ValueError(f"scan_steps ({scan_steps}) must divide steps_per_epoch ({spe})")
    graphed = _GraphedSteps(cfg, n_images, scan_steps, step_fn)

    def multi_step(state: TrainState, images: torch.Tensor,
                   labels: Optional[torch.Tensor] = None):
        if images.device.type == "cuda":
            return graphed(state, images, labels)
        ms = []
        for _ in range(scan_steps):
            state, m = step_fn(state, images, labels=labels)
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    multi_step.graphed = graphed
    return multi_step, spe


def make_eval_generate(cfg: TrainConfig):
    """Inference-mode generation: ``(state, z, y=None) -> images`` f32 in
    [-1, 1] (the generator in eval mode, in the compute dtype; the EMA
    shadow when ``ema_decay > 0``, as the JAX package samples)."""
    def generate(state: TrainState, z: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.no_grad():
            return eval_generator_weights(state)(z, y, _dtype(cfg)).float()
    return generate
