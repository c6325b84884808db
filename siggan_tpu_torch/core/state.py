"""Train state and optimizers.

Port of the JAX package's ``core/state.py`` for the default training path:
``TrainState`` holds the generator and discriminator modules (parameters
and BN running statistics), both optimizer states and the step counter;
randomness is not state -- every draw is derived from (seed, stream, step)
(``core/rng.py``), so a resumed run replays the same streams.

``Adam`` is written by hand (``torch._foreach_*``), not ``torch.optim.Adam``:
with ``moment_dtype="bfloat16"`` it is the JAX package's ``adam_low_mem``
(moments stored in bf16, all arithmetic in f32, bias correction on the
incremented count, ``u = -lr*(m/bc1)/(sqrt(v/bc2)+eps)``); with
``"float32"`` it is optax's ``adam`` (f32 moments, optax's formula).
``gradient_clip_value`` prepends optax's ``clip_by_global_norm``. The count
is an int32 tensor on the parameters' device and the bias corrections are
f32 device values computed from it, as JAX computes them, so a step reads
nothing from the host and a CUDA graph of it advances the count on every
replay; checkpoints keep the count as an integer (``bridge.opt_to_jax``).

LR schedules (``lr_schedule`` "linear" / "cosine") are optax's
``join_schedules([constant(lr), tail], [start])`` evaluated on the device
from Adam's int32 count of previous updates, as ``adam_low_mem`` calls
``lr(state["count"])`` and optax's ``scale_by_learning_rate`` reads its own
count: a Python float would be baked into a captured CUDA graph. The
discriminator's span is stretched by ``n_critic``. Each Adam state records
the learning rate its last update applied (``"lr"``, 0 before the first).

Generator EMA (``ema_decay > 0``): ``TrainState.g_ema`` is a second
``Generator`` whose parameters and BN running statistics follow
shadow = decay * shadow + (1 - decay) * current after every G update
(``ema_update``); it starts as a copy, and evaluation and serving use it
(``eval_generator_weights``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import torch

from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.models import discriminator, generator

# {"count": int32 Tensor (), "m": [Tensor], "v": [Tensor], "lr": f32 Tensor ()}
OptState = Dict[str, object]


@dataclass
class TrainState:
    step: int                      # global optimizer-step counter
    g: generator.Generator         # parameters + BN running statistics
    d: discriminator.Discriminator
    g_opt: OptState
    d_opt: OptState
    # EMA shadow of G's parameters and BN statistics; None when ema_decay == 0.
    g_ema: Optional[generator.Generator] = None


class Schedule:
    """An optax LR schedule on the device: ``join_schedules([constant(lr),
    tail], [start])`` with ``tail`` = ``linear_schedule(lr, lr * end_frac,
    span)`` or ``cosine_decay_schedule(lr, span, alpha=end_frac)``, called
    on an int32 count tensor; returns an f32 tensor. Each constant is an f32
    device tensor and every division is by one (a CUDA division by a host
    scalar multiplies by its reciprocal), so the values are optax's."""

    def __init__(self, kind: str, lr: float, start: int, span: int, end_frac: float):
        if kind not in ("linear", "cosine"):
            raise ValueError(f"unknown lr_schedule {kind!r}")
        self.kind, self.lr, self.start, self.span, self.end_frac = (
            kind, lr, start, span, end_frac)

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        def f(v):
            return torch.full((), v, dtype=torch.float32, device=count.device)
        c = count - self.start
        if self.kind == "linear":
            end = self.lr * self.end_frac
            frac = 1.0 - torch.clamp(c, 0, self.span).float() / f(float(self.span))
            tail = f(self.lr - end) * frac + f(end)
        else:
            c = torch.minimum(c.float(), f(float(self.span)))
            decay = 0.5 * (1.0 + torch.cos(f(math.pi) * c / f(float(self.span))))
            tail = f(self.lr) * (f(1.0 - self.end_frac) * decay + f(self.end_frac))
        return torch.where(count < self.start, f(self.lr), tail)


class StaircaseDecay:
    """optax's ``exponential_decay(lr, transition_steps, decay_rate,
    staircase=True)`` on the device (the verifier's torch-style StepLR):
    lr * decay_rate ** floor(count / transition_steps), in f32 from the
    int32 count; each constant an f32 device tensor, the division by one."""

    def __init__(self, lr: float, transition_steps: int, decay_rate: float):
        if transition_steps <= 0:
            raise ValueError(f"transition_steps must be positive, got {transition_steps}")
        self.lr, self.transition_steps, self.decay_rate = lr, transition_steps, decay_rate

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        def f(v):
            return torch.full((), v, dtype=torch.float32, device=count.device)
        p = torch.floor(count.float() / f(float(self.transition_steps)))
        return torch.where(count <= 0, f(self.lr), f(self.lr) * torch.pow(f(self.decay_rate), p))


LearningRate = Union[float, Schedule, StaircaseDecay]


def lr_schedule(cfg: TrainConfig, lr: float, step_mult: int = 1) -> LearningRate:
    """The configured LR: ``lr`` itself for "constant", else a ``Schedule``
    over ``lr_total_steps * step_mult`` updates (``step_mult`` stretches the
    span of a net that updates more than once per iteration: D with
    n_critic > 1)."""
    o = cfg.optim
    if o.lr_schedule == "constant":
        return lr
    total = o.lr_total_steps * step_mult
    if not total:
        raise ValueError("optim.lr_schedule requires optim.lr_total_steps > 0 "
                         "(GANTrainer fills it in automatically)")
    start = int(total * o.lr_decay_start_frac)
    return Schedule(o.lr_schedule, lr, start, max(total - start, 1), o.lr_end_frac)


class Adam:
    """Adam over a list of parameters, updated in place; ``lr`` a float, a
    ``Schedule`` or a ``StaircaseDecay`` of the count of previous updates;
    ``clip`` is the global-norm bound applied to the gradients first (None
    = off)."""

    def __init__(self, lr: LearningRate, b1: float, b2: float, eps: float = 1e-8,
                 moment_dtype: str = "bfloat16", clip: Optional[float] = None):
        if moment_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"moment_dtype must be bfloat16 or float32, got {moment_dtype!r}")
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.low_mem = moment_dtype == "bfloat16"
        self.moment_dtype = getattr(torch, moment_dtype)
        self.clip = clip

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        z = [torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device) for p in params]
        return {"count": new_count(0, params[0].device), "m": z,
                "v": [t.clone() for t in z], "lr": new_lr(params[0].device)}

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: g if |g| < c else g / |g| * c."""
        norm = global_norm(grads)
        keep = norm < self.clip
        return [torch.where(keep, g, g / norm * self.clip) for g in grads]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: OptState) -> None:
        """One update of ``params`` and ``state`` in place."""
        g32 = [g.float() for g in grads]
        if self.clip:
            g32 = self._clip(g32)
        count = state["count"]
        # The schedule reads the count of previous updates, as optax does.
        if isinstance(self.lr, (Schedule, StaircaseDecay)):
            lr = self.lr(count)
            state["lr"].copy_(lr)
        else:
            lr = self.lr
            state["lr"].fill_(lr)
        count.add_(1)
        b1, b2 = self.b1, self.b2
        # Bias corrections in f32 on the device, as the JAX package computes
        # them: 1 - b ** float(count).
        c = count.float()
        bc1, bc2 = 1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)
        m32 = [m.float() for m in state["m"]]
        v32 = [v.float() for v in state["v"]]
        if self.low_mem:
            # m = b1*m + (1-b1)*g ; v = b2*v + (1-b2)*g*g
            torch._foreach_mul_(m32, b1)
            torch._foreach_add_(m32, torch._foreach_mul(g32, 1.0 - b1))
            torch._foreach_mul_(v32, b2)
            gg = torch._foreach_mul(g32, 1.0 - b2)
            torch._foreach_mul_(gg, g32)
            torch._foreach_add_(v32, gg)
        else:
            # optax: m = (1-b1)*g + b1*m ; v = (1-b2)*g^2 + b2*v
            m_new = torch._foreach_mul(g32, 1.0 - b1)
            torch._foreach_add_(m_new, torch._foreach_mul(m32, b1))
            v_new = torch._foreach_mul(g32, g32)
            torch._foreach_mul_(v_new, 1.0 - b2)
            torch._foreach_add_(v_new, torch._foreach_mul(v32, b2))
            m32, v32 = m_new, v_new
        num = torch._foreach_div(m32, bc1)
        if self.low_mem:
            torch._foreach_mul_(num, -lr)
        den = torch._foreach_div(v32, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(num, den)
        if not self.low_mem:
            torch._foreach_mul_(num, -lr)
        torch._foreach_add_(list(params), num)
        torch._foreach_copy_(state["m"], m32)
        torch._foreach_copy_(state["v"], v32)


def new_count(n: int, device) -> torch.Tensor:
    """An Adam step count: an int32 scalar tensor on ``device``."""
    return torch.tensor(n, dtype=torch.int32, device=device)


def new_lr(device, value: float = 0.0) -> torch.Tensor:
    """An Adam state's record of its last applied LR: an f32 scalar tensor."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all entries, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def make_optimizers(cfg: TrainConfig):
    """(g_tx, d_tx): Adam(lr, (beta1, beta2)) with the configured moment
    dtype, optional global-norm clipping and LR schedule (D's span
    stretched by n_critic)."""
    o = cfg.optim

    def adam(lr, step_mult=1):
        return Adam(lr_schedule(cfg, lr, step_mult), o.beta1, o.beta2, 1e-8, o.moment_dtype,
                    o.gradient_clip_value)
    return adam(o.g_lr), adam(o.d_lr, max(cfg.n_critic, 1))


def ema_tensors(g: generator.Generator) -> List[torch.Tensor]:
    """What the EMA follows: G's parameters, then its BN running statistics."""
    return [*g.parameters(), *g.buffers()]


def copy_generator(g: generator.Generator) -> generator.Generator:
    """A copy of ``g`` that shares no tensor with it (the EMA shadow's start)."""
    shadow = copy.deepcopy(g)
    for p in shadow.parameters():
        p.requires_grad_(False)
    return shadow


@torch.no_grad()
def ema_update(g_ema: generator.Generator, g: generator.Generator, decay: float) -> None:
    """shadow = decay * shadow + (1 - decay) * current, in place, for every
    parameter and BN running statistic (the JAX package's form and
    rounding: two products, then their sum)."""
    shadow, cur = ema_tensors(g_ema), ema_tensors(g)
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, torch._foreach_mul(cur, 1.0 - decay))


def eval_generator_weights(state: TrainState) -> generator.Generator:
    """The generator to evaluate: the EMA shadow when tracked."""
    return state.g_ema if state.g_ema is not None else state.g


def set_learning_rates(cfg: TrainConfig, g_lr: Optional[float] = None,
                       d_lr: Optional[float] = None) -> TrainConfig:
    """The config with new base learning rates. Adam's moments do not depend
    on the LR, so rebuilding the step from it (``make_train_step``) and
    going on with the same state reproduces torch's in-place
    ``param_group['lr'] = x``."""
    return cfg.replace(optim=dataclasses.replace(
        cfg.optim, g_lr=cfg.optim.g_lr if g_lr is None else g_lr,
        d_lr=cfg.optim.d_lr if d_lr is None else d_lr))


def create_train_state(cfg: TrainConfig, device: DeviceLike = "cuda") -> TrainState:
    """Fresh state: DCGAN init of G and D from the (seed, STREAM_INIT_*)
    CPU generators (the same weights on every device), zero moments, and
    with ``ema_decay > 0`` the EMA shadow as a copy of G."""
    dev = resolve_device(device)
    g = generator.init_fn(rng.generator(cfg.seed, rng.STREAM_INIT_G), cfg.model, dev)
    d = discriminator.init_fn(rng.generator(cfg.seed, rng.STREAM_INIT_D), cfg.model, dev)
    g_tx, d_tx = make_optimizers(cfg)
    return TrainState(step=0, g=g, d=d, g_opt=g_tx.init(list(g.parameters())),
                      d_opt=d_tx.init(list(d.parameters())),
                      g_ema=copy_generator(g) if cfg.ema_decay > 0 else None)
