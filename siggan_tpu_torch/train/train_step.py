"""The adversarial train step: n_critic discriminator updates, then one
generator update.

Port of the JAX package's ``train/train_step.py`` (``d_step``, ``g_step``,
``fused_iteration``, ``shared_fakes_step``, ``make_train_step``, ``make_resident_train_step``,
``make_resident_multi_step``, ``make_eval_generate``; ``make_stream_step``
graphs the step the JAX streaming path jits). The same semantics:

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
numbers. ``make_stream_step`` is the streaming route's counterpart, one
step per call on a batch the loader brought: the same graph machinery with
the batch copied into a static buffer.

With ``share_fakes`` (n_critic 1) a step is ``shared_fakes_step``: one
latent batch, one generator forward for both updates. With
``fuse_g_forwards`` (and not ``share_fakes``, JAX's order) it is
``fused_iteration``: the n_critic + 1 generator forwards of the step, which
all run under the same G parameters, as one forward of (n_critic + 1) b
rows with BatchNorm statistics per group of b rows, on the same draws as
the sequential step.

Data parallelism (``mesh``, a ``parallel/mesh.py::DataMesh``): every step
function takes the mesh, and each rank is handed its rows of the global
batch (``cfg.batch_size``). The draws are made for the global batch, as the
JAX step draws them under its mesh, and each rank takes its rows of every
draw (``_shard_draws``; a D step's masks and DiffAugment parameters cover
``[real; fake]``, so a rank takes its rows of each half), which keeps one
seed's run the same on any number of ranks. Every BatchNorm of G (kernel
B2's included) takes global-batch statistics, the D and G gradients are
averaged over the ranks before Adam (one all-reduce of one flat buffer per
update; the logged grad norms are the averaged gradients'), and every
metric is the global mean. On the card the all-reduces are enqueued on the
step's stream, so ``_GraphedSteps`` captures them in its graph (NCCL; the
eager warm-up steps set up the communicator); a gloo mesh cannot be
captured, and its steps are called eagerly.
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
    """Raise ``ValueError`` for a configuration no step trains: an unknown
    DiffAugment policy, or ``share_fakes`` with ``n_critic != 1``."""
    if cfg.share_fakes and cfg.n_critic != 1:
        raise ValueError("share_fakes requires n_critic == 1 (ablation-trainer semantics)")
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


def d_step(state: TrainState, real: torch.Tensor, z: Optional[torch.Tensor],
           cfg: TrainConfig, d_tx: Adam, *, gen: Optional[torch.Generator] = None,
           masks: Optional[List[torch.Tensor]] = None,
           real_packed: bool = False, y_real: Optional[torch.Tensor] = None,
           y_fake: Optional[torch.Tensor] = None,
           diffaug_params: Optional[Sequence[diffaug.Params]] = None, mesh=None,
           fake: Optional[torch.Tensor] = None) -> Metrics:
    """One discriminator update on ``real`` (labels ``y_real``) and G(z)
    (labels ``y_fake``), the pair through DiffAugment with
    ``diffaug_params`` when configured; updates ``state`` in place (D, its
    moments and spectral-norm vectors, and G's BN running statistics). With
    ``mesh``, G's statistics are the global batch's and the gradients the
    ranks' mean; the metrics stay this rank's. ``fake``: fakes made already
    (``fused_iteration``'s detached slices, in the generator's output
    layout), which skips the G forward and its BN update (``z`` unused)."""
    cdt, packed = _dtype(cfg), _packed(cfg)
    b = real.shape[0]
    conditional = cfg.model.num_classes > 0
    if fake is None:
        with torch.no_grad():
            fake = state.g(z, y_fake, cdt, train=True, packed_output=packed,
                           fused_tail=packed and fused_tail_supported(cfg.model), mesh=mesh)
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
    grads = _mean_grads(torch.autograd.grad(loss, params), mesh)
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
           diffaug_params: Optional[Sequence[diffaug.Params]] = None, mesh=None) -> Metrics:
    """One generator update (non-saturating loss through a train-mode D,
    its fakes labelled ``y`` and through DiffAugment when configured), then
    the EMA shadow's update when ``ema_decay > 0``. ``mesh`` as in
    ``d_step``."""
    cdt, packed = _dtype(cfg), _packed(cfg)
    aux_on = _aux_on(cfg)
    fake = state.g(z, y, cdt, train=True, packed_output=packed, mesh=mesh)
    if cfg.diffaugment:
        fake = diffaug.apply(fake, diffaug_params, cfg.diffaugment, packed)
    out = state.d(fake, train=True, compute_dtype=cdt, packed_input=packed,
                  gen=gen, masks=masks, y=y, aux=aux_on)
    logits, aux_logits = out if aux_on else (out, None)
    loss = _bce_mean(logits, 1.0)
    if aux_on:
        loss = loss + cfg.aux_weight * _ce_mean(aux_logits, y)
    params = list(state.g.parameters())
    grads = _mean_grads(torch.autograd.grad(loss, params), mesh)
    g_tx.step(params, grads, state.g_opt)
    if cfg.ema_decay > 0:
        ema_update(state.g_ema, state.g, cfg.ema_decay)
    with torch.no_grad():
        m = {"g_loss": loss.detach(), "d_on_g_mean": torch.sigmoid(logits).mean()}
        if cfg.log_grad_norms:
            m["g_grad_norm"] = global_norm(grads)
        return m


def shared_fakes_step(state: TrainState, real: torch.Tensor, z: torch.Tensor,
                      cfg: TrainConfig, d_tx: Adam, g_tx: Adam, *,
                      masks: Sequence[Optional[List[torch.Tensor]]] = (None, None),
                      real_packed: bool = False, y_real: Optional[torch.Tensor] = None,
                      y_fake: Optional[torch.Tensor] = None,
                      diffaug_params: Sequence = (None, None), mesh=None) -> Metrics:
    """One D update and one G update sharing a single generator forward,
    the JAX package's ``shared_fakes_step`` (the reference's ablation
    trainer: one latent batch per iteration). G runs once in train mode
    with its graph kept (its BN statistics update once); D trains on
    ``[real; fake.detach()]`` with ``masks[0]`` and ``diffaug_params[0]``;
    then the same fakes go through the updated D with ``masks[1]`` and
    ``diffaug_params[1]``, and G's gradient flows back through the saved
    forward. Conditional models: ``y_fake`` conditions G and ``[y_real;
    y_fake]`` feeds D's heads, the G head scores the fakes with
    ``y_fake``. Updates ``state`` in place, then the EMA shadow when
    ``ema_decay > 0``. ``mesh`` as in ``d_step``."""
    cdt, packed = _dtype(cfg), _packed(cfg)
    b = real.shape[0]
    conditional = cfg.model.num_classes > 0
    aux_on = _aux_on(cfg)
    fake = state.g(z, y_fake, cdt, train=True, packed_output=packed, mesh=mesh)
    if packed and not real_packed:
        real = space_to_depth(real)
    both = torch.cat([real.to(fake.dtype), fake.detach()], dim=0)
    if cfg.diffaugment:
        both = diffaug.apply(both, diffaug_params[0], cfg.diffaugment, packed)
    out = state.d(both, train=True, compute_dtype=cdt, packed_input=packed, masks=masks[0],
                  aux=aux_on, y=torch.cat([y_real, y_fake]) if conditional else None)
    logits, aux_logits = out if aux_on else (out, None)
    logits_r, logits_f = logits[:b], logits[b:]
    d_loss = _bce_mean(logits_r, cfg.label_smoothing) + _bce_mean(logits_f, 0.0)
    if aux_on:
        aux_loss = _ce_mean(aux_logits[:b], y_real)
        if cfg.aux_d_on_fakes:
            aux_loss = aux_loss + _ce_mean(aux_logits[b:], y_fake)
        d_loss = d_loss + cfg.aux_weight * aux_loss
    d_params = list(state.d.parameters())
    d_tx.step(d_params, _mean_grads(torch.autograd.grad(d_loss, d_params), mesh),
              state.d_opt)

    fake_g = diffaug.apply(fake, diffaug_params[1], cfg.diffaugment, packed) \
        if cfg.diffaugment else fake
    out = state.d(fake_g, train=True, compute_dtype=cdt, packed_input=packed, masks=masks[1],
                  y=y_fake, aux=aux_on)
    logits_g, aux_g = out if aux_on else (out, None)
    g_loss = _bce_mean(logits_g, 1.0)
    if aux_on:
        g_loss = g_loss + cfg.aux_weight * _ce_mean(aux_g, y_fake)
    g_params = list(state.g.parameters())
    g_tx.step(g_params, _mean_grads(torch.autograd.grad(g_loss, g_params), mesh),
              state.g_opt)
    if cfg.ema_decay > 0:
        ema_update(state.g_ema, state.g, cfg.ema_decay)
    with torch.no_grad():
        p_real, p_fake = torch.sigmoid(logits_r), torch.sigmoid(logits_f)
        m = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
             "d_real_mean": p_real.mean(), "d_fake_mean": p_fake.mean(),
             "d_acc_real": (p_real > 0.5).float().mean(),
             "d_acc_fake": (p_fake < 0.5).float().mean(),
             "d_on_g_mean": torch.sigmoid(logits_g).mean()}
        m["d_accuracy"] = 0.5 * (m["d_acc_real"] + m["d_acc_fake"])
    return m


def fused_iteration(state: TrainState, real: torch.Tensor, zs: Sequence[torch.Tensor],
                    cfg: TrainConfig, d_tx: Adam, g_tx: Adam, *,
                    masks: Sequence[Optional[List[torch.Tensor]]],
                    real_packed: bool = False, y_real: Optional[torch.Tensor] = None,
                    ys: Optional[Sequence[torch.Tensor]] = None,
                    diffaug_params: Optional[Sequence] = None, mesh=None) -> Metrics:
    """n_critic D updates and one G update with every generator forward of
    the step merged into one, the JAX package's ``fused_iteration``.

    The k = n_critic + 1 forwards all run under the same G parameters (only
    D changes between sub-steps), so G runs once, in train mode with its
    graph kept, on ``cat(zs)`` (labels ``cat(ys)``) with BatchNorm
    statistics per group of b rows (``bn_groups=k``): every row is what its
    own forward gives, and the running estimates fold the groups in order.
    D step i trains on the detached rows of group i with ``masks[i]``,
    ``ys[i]`` and ``diffaug_params[i]``; the G head scores the last group
    through the updated D (``masks[n_critic]``, ...), its fakes' gradient
    is taken alone, and G's gradient is one backward of the merged forward
    with that gradient on the last group's rows and zeros on the others
    (no statistic crosses a group, so those rows add nothing). Then Adam,
    the EMA shadow when ``ema_decay > 0``, and the metrics of the
    sequential step. ``mesh`` as in ``d_step``: ``zs`` and ``ys`` are this
    rank's rows of each sub-step's draw, so each group's statistics are the
    global batch's of that sub-step."""
    cdt, packed = _dtype(cfg), _packed(cfg)
    b, k, n = real.shape[0], cfg.n_critic + 1, cfg.n_critic
    aux_on = _aux_on(cfg)
    ys, das = ys or [None] * k, diffaug_params or [None] * k
    fake_all = state.g(torch.cat(list(zs)), None if ys[0] is None else torch.cat(list(ys)),
                       cdt, train=True, packed_output=packed, mesh=mesh, bn_groups=k)
    fake_sg = fake_all.detach()
    metrics: Metrics = {}
    for i in range(n):
        metrics = d_step(state, real, None, cfg, d_tx, masks=masks[i], real_packed=real_packed,
                         y_real=y_real, y_fake=ys[i], diffaug_params=das[i], mesh=mesh,
                         fake=fake_sg[i * b:(i + 1) * b])
    fake_g = fake_all[n * b:].detach().requires_grad_(True)
    fake_d = diffaug.apply(fake_g, das[n], cfg.diffaugment, packed) \
        if cfg.diffaugment else fake_g
    out = state.d(fake_d, train=True, compute_dtype=cdt, packed_input=packed, masks=masks[n],
                  y=ys[n], aux=aux_on)
    logits, aux_logits = out if aux_on else (out, None)
    loss = _bce_mean(logits, 1.0)
    if aux_on:
        loss = loss + cfg.aux_weight * _ce_mean(aux_logits, ys[n])
    (dfake,) = torch.autograd.grad(loss, fake_g)
    cot = torch.cat([torch.zeros((n * b, *fake_all.shape[1:]), dtype=fake_all.dtype,
                                 device=fake_all.device), dfake.to(fake_all.dtype)])
    params = list(state.g.parameters())
    grads = _mean_grads(torch.autograd.grad(fake_all, params, grad_outputs=cot), mesh)
    g_tx.step(params, grads, state.g_opt)
    if cfg.ema_decay > 0:
        ema_update(state.g_ema, state.g, cfg.ema_decay)
    with torch.no_grad():
        metrics.update({"g_loss": loss.detach(), "d_on_g_mean": torch.sigmoid(logits).mean()})
        if cfg.log_grad_norms:
            metrics["g_grad_norm"] = global_norm(grads)
    return metrics


def _mean_grads(grads: Sequence[torch.Tensor], mesh) -> Sequence[torch.Tensor]:
    """The gradients averaged over ``mesh``'s ranks: one all-reduce of one
    flat buffer (the gradients themselves without a mesh)."""
    return grads if mesh is None else mesh.average(grads)


def _shard_draws(draws: Dict, mesh, b: int) -> Dict:
    """This rank's rows of a step's draws made for the global batch ``b``:
    of each draw's b rows, or of each b-row half of a D step's 2b."""
    return _map_draws(lambda t: mesh.shard_rows(t, b), draws)


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
    n_z = 1 if cfg.share_fakes else n_sub
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
        if i < n_z:
            draws["z"].append(fill(torch.randn, (b, cfg.model.latent_dim),
                                   st(rng.STREAM_NOISE, step, i), dst("z", i)))
        if conditional and i < n_z:
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
              y_real: Optional[torch.Tensor] = None, mesh=None) -> Metrics:
    """One iteration on complete draws: the per-step augmentation (when
    ``cfg.augment``), n_critic D steps, then the G step (or, with
    ``share_fakes``, the shared-fake step). Reads and updates
    only device tensors (what a CUDA graph of it captures); ``state.step``
    is left to the caller. With ``mesh``, ``real`` is this rank's rows of
    the global batch, ``draws`` are the global batch's, and the metrics
    returned are the ranks' means."""
    if mesh is not None and mesh.size > 1:
        draws = _shard_draws(draws, mesh, real.shape[0] * mesh.size)
    metrics = _iteration(cfg, d_tx, g_tx, real_packed, state, real, draws, y_real, mesh)
    if mesh is None:
        return metrics
    return mesh.all_reduce_mean(metrics, keep=("d_grad_norm", "g_grad_norm"))


def _iteration(cfg: TrainConfig, d_tx: Adam, g_tx: Adam, real_packed: bool,
               state: TrainState, real: torch.Tensor, draws: Dict,
               y_real: Optional[torch.Tensor], mesh) -> Metrics:
    if cfg.augment:
        real = augment_apply(real, *draws["augment"], dtype=_dtype(cfg))
    zs, masks = draws["z"], draws["masks"]
    ys = draws.get("y") or [None] * len(zs)
    das = draws.get("diffaug") or [None] * len(masks)
    if cfg.share_fakes:
        return shared_fakes_step(state, real, zs[0], cfg, d_tx, g_tx, masks=masks,
                                 real_packed=real_packed, y_real=y_real, y_fake=ys[0],
                                 diffaug_params=das, mesh=mesh)
    if cfg.fuse_g_forwards:
        return fused_iteration(state, real, zs, cfg, d_tx, g_tx, masks=masks,
                               real_packed=real_packed, y_real=y_real, ys=ys,
                               diffaug_params=das, mesh=mesh)
    metrics: Metrics = {}
    for i in range(cfg.n_critic):
        metrics = d_step(state, real, zs[i], cfg, d_tx, masks=masks[i],
                         real_packed=real_packed, y_real=y_real, y_fake=ys[i],
                         diffaug_params=das[i], mesh=mesh)
    n = cfg.n_critic
    metrics.update(g_step(state, zs[n], cfg, g_tx, masks=masks[n], y=ys[n],
                          diffaug_params=das[n], mesh=mesh))
    return metrics


def make_train_step(cfg: TrainConfig, real_pre_packed: bool = False, mesh=None):
    """``train_step(state, real, draws=None, y_real=None) -> (state,
    metrics)``.

    ``real`` (b, H, W, 1) in [-1, 1] on the state's device, or, with
    ``real_pre_packed``, already augmented, cast and packed; ``y_real`` its
    labels, required by a conditional model. The state is updated in place
    and returned with ``step`` advanced by one. What ``draws`` does not
    inject is drawn by ``step_draws``. With ``mesh``, ``real`` is this
    rank's rows of the global batch and ``draws``, injected or drawn, are
    the global batch's (``b`` times the mesh size)."""
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
            b = real.shape[0] * (1 if mesh is None else mesh.size)
            drawn = step_draws(cfg, st, state.step, b, dev)
            drawn["masks"] = _keep_masks(cfg, drawn.pop("u"))
            draws = {**drawn, **draws}
        metrics = _run_step(cfg, d_tx, g_tx, real_pre_packed, state, real, draws,
                            None if y_real is None else y_real.long(), mesh)
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


def make_resident_train_step(cfg: TrainConfig, n_images: int, mesh=None):
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
    is warped. Both tables are made when the epoch changes. With ``mesh``
    every rank holds the whole set and gathers its rows of each global
    batch."""
    steps_per_epoch = n_images // cfg.batch_size
    if steps_per_epoch < 1:
        raise ValueError(f"dataset ({n_images}) smaller than the batch ({cfg.batch_size})")
    bulk = _bulk(cfg)
    base_step = make_train_step(*_inner(cfg), mesh=mesh)
    mine = slice(None) if mesh is None else mesh.rows(cfg.batch_size)
    cache: Dict[str, object] = {"epoch": None}

    def train_step(state: TrainState, images: torch.Tensor,
                   draws: Optional[Dict] = None, labels: Optional[torch.Tensor] = None):
        epoch, bidx = divmod(state.step, steps_per_epoch)
        if cache["epoch"] != epoch:
            cache["perm"], cache["aug"] = _epoch_tables(cfg, n_images, epoch, images.device)
            cache["epoch"] = epoch
        idx = cache["perm"][bidx * cfg.batch_size:(bidx + 1) * cfg.batch_size][mine]
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


class _Gathered:
    """Where a resident window's batches come from: rows of the epoch's
    permutation of the set on the card, gathered inside the graph (and
    warped there with the epoch's augment tables, with bulk augmentation).
    ``fill`` writes the window's rows (and, when the epoch changed, its
    tables) into buffers the graph reads."""

    def __init__(self, cfg: TrainConfig, n_images: int, k: int, eager_step, mesh=None):
        self.cfg, self.n_images, self.k, self.eager_step = cfg, n_images, k, eager_step
        self.spe = n_images // cfg.batch_size
        self.inner, self.real_packed = _inner(cfg)
        # This rank's columns of a window's (K, B) rows of the permutation.
        self.mine = slice(None) if mesh is None else mesh.rows(cfg.batch_size)

    def allocate(self, images: torch.Tensor, labels: Optional[torch.Tensor]) -> None:
        dev, b = images.device, self.cfg.batch_size
        self.images, self.labels, self.epoch = images, labels, None
        self.perm = torch.empty(self.n_images, dtype=torch.long, device=dev)
        self.rows = torch.empty((self.k, len(range(b)[self.mine])), dtype=torch.long,
                                device=dev)
        self.aug = None
        if _bulk(self.cfg):
            n = self.n_images
            self.aug = (torch.empty(n, device=dev), torch.empty(n, device=dev),
                        torch.empty(n, dtype=torch.bool, device=dev) if self.cfg.hflip else None)

    def check(self, step0: int, images: torch.Tensor, labels: Optional[torch.Tensor],
              allocated: bool) -> None:
        if step0 % self.spe + self.k > self.spe:
            raise ValueError(f"a window of {self.k} steps from step {step0} crosses an "
                             f"epoch of {self.spe} steps")
        if allocated and (images is not self.images or labels is not self.labels):
            raise ValueError("the train step's graph was built on other images or labels")

    def fill(self, step0: int, images: torch.Tensor, labels: Optional[torch.Tensor]) -> None:
        b = self.cfg.batch_size
        epoch, bidx = divmod(step0, self.spe)
        if self.epoch != epoch:
            perm, aug = _epoch_tables(self.cfg, self.n_images, epoch, images.device)
            self.perm.copy_(perm)
            for dst, src in zip(self.aug or (), aug or ()):
                if dst is not None:
                    dst.copy_(src)
            self.epoch = epoch
        self.rows.copy_(self.perm[bidx * b:(bidx + self.k) * b].view(self.k, b)[:, self.mine])

    def batch(self, slot: torch.Tensor):
        """(real, its labels or None) of the step at row ``slot`` (captured)."""
        idx = self.rows.index_select(0, slot).reshape(-1)
        real = self.images[idx]
        if self.aug is not None:
            real = _warp_gathered(self.cfg, real, *self.aug, idx)
        return real, None if self.labels is None else self.labels[idx]

    def eager(self, state: TrainState):
        return self.eager_step(state, self.images, labels=self.labels)


class _Static:
    """Where a streamed step's batch comes from: a static buffer on the card
    (and one for its labels) that each call's batch is copied into, on the
    current stream, before the step runs."""

    def __init__(self, cfg: TrainConfig, eager_step):
        self.eager_step = eager_step
        self.inner, self.real_packed = cfg, False

    def allocate(self, batch: torch.Tensor, labels: Optional[torch.Tensor]) -> None:
        self.real = torch.empty_like(batch)
        self.labels = None if labels is None else torch.empty_like(labels)

    def check(self, step0: int, batch: torch.Tensor, labels: Optional[torch.Tensor],
              allocated: bool) -> None:
        if allocated and (batch.shape != self.real.shape
                          or (labels is None) != (self.labels is None)):
            raise ValueError(f"the train step's graph was built on batches of "
                             f"{tuple(self.real.shape)}, got {tuple(batch.shape)}")

    def fill(self, step0: int, batch: torch.Tensor, labels: Optional[torch.Tensor]) -> None:
        self.real.copy_(batch)
        if labels is not None:
            self.labels.copy_(labels)

    def batch(self, slot: torch.Tensor):
        return self.real, self.labels

    def eager(self, state: TrainState):
        return self.eager_step(state, self.real, y_real=self.labels)


class _GraphedSteps:
    """K steps per call on the card: one step captured as a CUDA graph and
    replayed K times, on the batches of a source -- ``_Gathered`` (rows of
    the resident set) or ``_Static`` (a streamed batch, K = 1).

    One graph of one step, not one of K: capture time and the graph's node
    count stay those of a step whatever K is (K reaches a whole epoch when
    steps_per_epoch has no divisor in [16, 64]), and the memory is one
    step's either way. The graph reads the window's draws and its source's
    buffers, filled before the replays (``step_draws`` with the eager
    step's keys), finds its row through a device counter it advances, and
    writes its metrics into row ``slot`` of a (K, keys) buffer. The
    learning rates are device values of Adam's counts, so they follow the
    schedule on every replay.

    The first ``WARMUP`` steps of the run are eager steps on a side stream,
    real steps of the training: they build the kernels' plans and let
    cuDNN, cuBLAS and the autograd engine set up outside the capture. The
    graph is bound to the first state's tensors and to the source's
    buffers; a state whose tensors are others (a resumed or restored one) is
    copied into the bound storage, and the bound state is returned. A
    capture launches nothing, so the kernels' launch counts it records are
    taken back, and every replay adds them. A failed capture raises.

    With ``mesh`` the step's all-reduces are captured with it (an NCCL
    mesh); the warm-up steps run them first, which sets up the
    communicator. A gloo mesh cannot be captured and raises."""

    WARMUP = 2

    def __init__(self, cfg: TrainConfig, k: int, source, mesh=None):
        self.cfg, self.k, self.source, self.mesh = cfg, k, source, mesh
        self.inner, self.real_packed = source.inner, source.real_packed
        self.g_tx, self.d_tx = make_optimizers(cfg)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.bound: Optional[TrainState] = None
        self.warm = 0
        self.capture_s: Optional[float] = None
        self.delta: List[int] = []

    def _allocate(self, state: TrainState, data: torch.Tensor,
                  labels: Optional[torch.Tensor]) -> None:
        cfg, k, b, dev = self.inner, self.k, self.cfg.batch_size, data.device
        self.bound, self.tensors = state, state_tensors(state)
        self.source.allocate(data, labels)
        self.streams = Streams(cfg.seed, dev)
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.slot = torch.zeros(1, dtype=torch.long, device=dev)
        # One (K, ...) buffer per draw of a step, shaped by step_draws itself.
        self.draws = _map_draws(lambda t: t.new_empty((k, *t.shape)),
                                step_draws(cfg, self.streams, 0, b, dev))

    def _bind(self, state: TrainState, data: torch.Tensor,
              labels: Optional[torch.Tensor]) -> TrainState:
        if self.bound is None:
            self._allocate(state, data, labels)
            return state
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

    def _fill(self, step0: int, data: torch.Tensor, labels: Optional[torch.Tensor]) -> None:
        """The window's buffers: its source's batches and its K steps' draws."""
        self.source.fill(step0, data, labels)
        for s in range(self.k):
            step_draws(self.inner, self.streams, step0 + s, self.cfg.batch_size, data.device,
                       out=_map_draws(lambda t: t[s], self.draws))
        self.slot.zero_()

    def _step(self, state: TrainState) -> Metrics:
        """The captured step: batch, draws and metrics through ``slot``."""
        real, y_real = self.source.batch(self.slot)
        draws = _map_draws(lambda t: t.index_select(0, self.slot)[0], self.draws)
        draws["masks"] = _keep_masks(self.inner, draws.pop("u"))
        metrics = _run_step(self.inner, self.d_tx, self.g_tx, self.real_packed, state,
                            real, draws, None if y_real is None else y_real.long(), self.mesh)
        self.metrics.index_copy_(0, self.slot,
                                 torch.stack([metrics[k].float() for k in self.keys])[None])
        self.slot.add_(1)
        return metrics

    def _capture(self, state: TrainState) -> None:
        if self.mesh is not None and self.mesh.backend != "nccl":
            raise ValueError(f"a {self.mesh.backend} mesh cannot be captured in a CUDA "
                             "graph: call the eager step (make_train_step) on the card")
        before = build.launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self._step(state)
        torch.cuda.synchronize(self.slot.device)
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

    def __call__(self, state: TrainState, data: torch.Tensor,
                 labels: Optional[torch.Tensor] = None):
        step0 = state.step
        self.source.check(step0, data, labels, self.bound is not None)
        state = self._bind(state, data, labels)
        self._fill(step0, data, labels)
        replays = 0
        for s in range(self.k):
            if self.graph is None and self.warm < self.WARMUP:
                # Eager warm-up step on the side stream: a real step of the run.
                with self._side_stream():
                    state, m = self.source.eager(state)
                    if self.warm == 0:
                        self.keys = list(m)
                        self.metrics = torch.zeros((self.k, len(self.keys)),
                                                   device=data.device)
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


def make_resident_multi_step(cfg: TrainConfig, n_images: int, scan_steps: int, mesh=None):
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
    (for debugging). With ``mesh`` each rank steps on its rows of every
    global batch."""
    step_fn, spe = make_resident_train_step(cfg, n_images, mesh)
    if scan_steps < 1 or spe % scan_steps:
        raise ValueError(f"scan_steps ({scan_steps}) must divide steps_per_epoch ({spe})")
    graphed = _GraphedSteps(cfg, scan_steps,
                            _Gathered(cfg, n_images, scan_steps, step_fn, mesh), mesh)

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


def make_stream_step(cfg: TrainConfig, mesh=None):
    """The streaming route's step, one dispatch per batch: ``(state, batch,
    labels=None) -> (state, metrics)`` with ``batch`` a (b, H, W, 1) batch
    from ``data/loader.py::BatchLoader`` (``labels`` its labels for a
    conditional model) and each metric of shape (1,). The step is
    ``make_train_step(cfg)``, the JAX streaming path's: augmentation drawn
    per step from the step counter's keys.

    On CUDA tensors it replays a CUDA graph of that step
    (``stream_step.graphed``, a ``_GraphedSteps`` over a ``_Static``
    source): the batch is copied into the graph's static buffer and the
    step's draws into its draw buffers, with the eager step's keys, so
    graphed and eager steps see the same numbers. On CPU tensors it is the
    eager step (also the route to debug on the card). With ``mesh`` the
    batch is this rank's rows of the global batch (``BatchLoader(mesh=)``)."""
    step_fn = make_train_step(cfg, mesh=mesh)
    graphed = _GraphedSteps(cfg, 1, _Static(cfg, step_fn), mesh)

    def stream_step(state: TrainState, batch: torch.Tensor,
                    labels: Optional[torch.Tensor] = None):
        if batch.device.type == "cuda":
            return graphed(state, batch, labels)
        state, m = step_fn(state, batch, y_real=labels)
        return state, {k: v.reshape(1) for k, v in m.items()}

    stream_step.graphed = graphed
    return stream_step


def make_eval_generate(cfg: TrainConfig):
    """Inference-mode generation: ``(state, z, y=None) -> images`` f32 in
    [-1, 1] (the generator in eval mode, in the compute dtype; the EMA
    shadow when ``ema_decay > 0``, as the JAX package samples)."""
    def generate(state: TrainState, z: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.no_grad():
            return eval_generator_weights(state)(z, y, _dtype(cfg)).float()
    return generate
