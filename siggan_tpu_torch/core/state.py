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
LR schedules and EMA are not ported yet (under a graph the LR will have to
be a device value too).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from siggan_tpu_torch.core import rng
from siggan_tpu_torch.core.config import TrainConfig
from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.models import discriminator, generator

OptState = Dict[str, object]   # {"count": int32 Tensor (), "m": [Tensor], "v": [Tensor]}


@dataclass
class TrainState:
    step: int                      # global optimizer-step counter
    g: generator.Generator         # parameters + BN running statistics
    d: discriminator.Discriminator
    g_opt: OptState
    d_opt: OptState


class Adam:
    """Adam over a list of parameters, updated in place; ``clip`` is the
    global-norm bound applied to the gradients first (None = off)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float = 1e-8,
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
                "v": [t.clone() for t in z]}

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
            torch._foreach_mul_(num, -self.lr)
        den = torch._foreach_div(v32, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(num, den)
        if not self.low_mem:
            torch._foreach_mul_(num, -self.lr)
        torch._foreach_add_(list(params), num)
        torch._foreach_copy_(state["m"], m32)
        torch._foreach_copy_(state["v"], v32)


def new_count(n: int, device) -> torch.Tensor:
    """An Adam step count: an int32 scalar tensor on ``device``."""
    return torch.tensor(n, dtype=torch.int32, device=device)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the l2 norm of all entries, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def check_supported(cfg: TrainConfig) -> None:
    if cfg.optim.lr_schedule != "constant":
        raise NotImplementedError("LR schedules are not ported yet (ROADMAP A.1)")
    if cfg.ema_decay > 0:
        raise NotImplementedError("generator EMA is not ported yet (ROADMAP A.1)")


def make_optimizers(cfg: TrainConfig):
    """(g_tx, d_tx): Adam(lr, (beta1, beta2)) with the configured moment
    dtype and optional global-norm clipping, constant LR."""
    check_supported(cfg)
    o = cfg.optim

    def adam(lr):
        return Adam(lr, o.beta1, o.beta2, 1e-8, o.moment_dtype, o.gradient_clip_value)
    return adam(o.g_lr), adam(o.d_lr)


def create_train_state(cfg: TrainConfig, device: DeviceLike = "cuda") -> TrainState:
    """Fresh state: DCGAN init of G and D from the (seed, STREAM_INIT_*)
    CPU generators (the same weights on every device), zero moments."""
    dev = resolve_device(device)
    g = generator.init_fn(rng.generator(cfg.seed, rng.STREAM_INIT_G), cfg.model, dev)
    d = discriminator.init_fn(rng.generator(cfg.seed, rng.STREAM_INIT_D), cfg.model, dev)
    g_tx, d_tx = make_optimizers(cfg)
    return TrainState(step=0, g=g, d=d, g_opt=g_tx.init(list(g.parameters())),
                      d_opt=d_tx.init(list(d.parameters())))
