"""DCGAN-style signature generator as an ``nn.Module``, eval and train mode.

Same architecture as the JAX package's ``models/generator.py``:

  z (N, latent)
   -> Linear(latent, 4*4*C0) + bias -> BatchNorm1d -> act
   -> reshape (N, 4, 4, C0)            (NHWC: fc features are in HWC order)
   -> k x [ConvT(4,2,1, no bias) -> BatchNorm -> act]
        64px:  C0=256: 256->128->64->32->32 (4x4 -> 64x64)
        128px: C0=512: 512->256->128->64->32->32
   -> Conv(3,1,1) + bias -> tanh       (32 -> image_channels)

Parameters are stored in PyTorch's layouts (``Linear`` (out, in), ConvT
(Cin, Cout, kh, kw), conv OIHW); ``bridge.py`` converts to and from the JAX
package's trees. Activations stay NHWC, as there. Conditional models
(``num_classes > 0``) route the label per ``g_conditioning``.

Train mode (``train=True``) normalizes with batch statistics and updates the
BN running estimates in place, as each JAX train-mode forward returns its
new state. ``packed_output=True`` (1-channel models) runs the small-channel
tail -- every block with Cout <= 64 and the final conv -- in 2x2
space-to-depth form and returns ``space_to_depth(image)`` (N, H/2, W/2, 4);
every packed tail kernel comes from one launch of kernel B1
(``ops/kernels/pack_tail.py``), whose backward is B1'.

``fused_tail=True`` (with ``train`` and ``packed_output``, under
``torch.no_grad()``, for a configuration ``fused_tail_supported`` admits)
is the discriminator step's route: the fc, its BN and the wide blocks run
as above, then the whole packed tail -- its convs, its BN statistics and
running-stat updates, the final conv and tanh -- runs in kernel B2
(``ops/kernels/train_tail.py``), which has no backward.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.ops import initializers as init
from siggan_tpu_torch.ops.activations import leaky_relu, take_rows
from siggan_tpu_torch.ops.conv import conv2d_oihw, conv_transpose2d_iohw, linear_oi
from siggan_tpu_torch.ops.kernels import train_tail
from siggan_tpu_torch.ops.kernels.pack_tail import pack_tail
from siggan_tpu_torch.ops.norm import batch_norm, batch_norm_packed
from siggan_tpu_torch.ops.packed import conv3_mc_as_matmul_ihwo


def channel_schedule(cfg: ModelConfig) -> Tuple[int, List[Tuple[int, int]]]:
    """(init_channels_at_4x4, [(in_ch, out_ch) per upsample block])."""
    if cfg.image_size == 64:
        c0 = cfg.base_features
        blocks = [(c0, c0 // 2), (c0 // 2, c0 // 4), (c0 // 4, c0 // 8), (c0 // 8, c0 // 8)]
    elif cfg.image_size == 128:
        c0 = cfg.base_features * 2
        blocks = [(c0, c0 // 2), (c0 // 2, c0 // 4), (c0 // 4, c0 // 8),
                  (c0 // 8, c0 // 16), (c0 // 16, c0 // 16)]
    else:
        raise ValueError(f"image_size must be 64 or 128, got {cfg.image_size}")
    return c0, blocks


def tail_start(cfg: ModelConfig) -> Optional[int]:
    """Index of the first block with Cout <= 64: where the packed tail
    starts (None if no block is that narrow)."""
    _, blocks = channel_schedule(cfg)
    return next((i for i, (_, co) in enumerate(blocks) if co <= 64), None)


def _cond_bn(cfg: ModelConfig) -> bool:
    return cfg.num_classes > 0 and cfg.g_conditioning in ("full", "bn_only")


def fused_tail_supported(cfg: ModelConfig) -> bool:
    """Whether the packed tail of this model can run in kernel B2: one image
    channel, the one-launch tail pack, a ReLU generator without
    class-conditional BN, a tail block, and every tail layer's input
    channels a multiple of the kernel's reduction chunk. A gate on the
    configuration, not on a launch."""
    start = tail_start(cfg)
    if (cfg.image_channels != 1 or not cfg.g_pack_pallas or cfg.g_activation != "relu"
            or _cond_bn(cfg) or start is None):
        return False
    _, blocks = channel_schedule(cfg)
    cins = [blocks[start][0]] + [4 * ci for ci, _ in blocks[start + 1:]] + [4 * blocks[-1][1]]
    return all(c % train_tail.CHUNK == 0 for c in cins)


def _fc_in(cfg: ModelConfig) -> int:
    extra = (cfg.num_classes
             if cfg.num_classes > 0 and cfg.g_conditioning == "concat" else 0)
    return cfg.latent_dim + extra


def _param(*shape: int, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis: ``scale``/``offset`` parameters,
    (num_classes, C) for class-conditional BN, and running ``mean``/``var``
    buffers, which a train-mode call updates."""

    def __init__(self, n: int, num_classes: int = 0, device=None):
        super().__init__()
        rows = (num_classes,) if num_classes else ()
        self.scale = _param(*rows, n, device=device)
        self.offset = _param(*rows, n, device=device)
        self.register_buffer("mean", torch.zeros(n, device=device))
        self.register_buffer("var", torch.ones(n, device=device))

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                train: bool = False, packed: bool = False) -> torch.Tensor:
        scale, offset = (self.scale, self.offset) if y is None else (
            take_rows(self.scale, y), take_rows(self.offset, y))
        fn = batch_norm_packed if packed else batch_norm
        out, state = fn(x, scale, offset, {"mean": self.mean, "var": self.var},
                        train=train)
        if train:
            with torch.no_grad():
                self.mean.copy_(state["mean"])
                self.var.copy_(state["var"])
        return out


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, num_classes: int = 0, device=None):
        super().__init__()
        self.weight = _param(cin, cout, 4, 4, device=device)  # ConvT layout
        self.bn = BatchNorm(cout, num_classes, device)


class Linear(nn.Module):
    def __init__(self, fin: int, fout: int, device=None):
        super().__init__()
        self.weight = _param(fout, fin, device=device)
        self.bias = _param(fout, device=device)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, device=None):
        super().__init__()
        self.weight = _param(cout, cin, k, k, device=device)
        self.bias = _param(cout, device=device)


class Generator(nn.Module):
    """``forward(z, y)`` -> images (N, H, W, C) in [-1, 1] in the compute
    dtype. Parameters start at zero: build one with ``init_fn`` or
    ``bridge.from_jax``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c0, blocks = channel_schedule(cfg)
        bn_classes = cfg.num_classes if _cond_bn(cfg) else 0
        self.fc = Linear(_fc_in(cfg), 16 * c0, device)
        self.fc_bn = BatchNorm(16 * c0, bn_classes, device)
        self.blocks = nn.ModuleList(
            UpBlock(ci, co, bn_classes, device) for ci, co in blocks)
        self.final = Conv(blocks[-1][1], cfg.image_channels, 3, device)
        if cfg.num_classes > 0 and cfg.g_conditioning in ("full", "embed_only"):
            self.embed = _param(cfg.num_classes, cfg.latent_dim, device=device)
        else:
            self.embed = None

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.g_activation == "leaky_relu":
            return leaky_relu(x, self.cfg.leaky_slope)
        return F.relu(x)

    def tail_entry(self) -> Optional[int]:
        """Where the packed tail starts (``tail_start`` of the config)."""
        return tail_start(self.cfg)

    def _fused_tail(self, h, tail, entry, odt) -> torch.Tensor:
        """The packed tail from the last wide block's output ``h`` in kernel
        B2, its BN running statistics updated in place."""
        bns = [blk.bn for blk in self.blocks[entry:]]
        return train_tail.tail_forward_train(
            h, tail, [(bn.scale, bn.offset) for bn in bns],
            [{"mean": bn.mean, "var": bn.var} for bn in bns], self.final.bias, odt)

    def forward(self, z: torch.Tensor, y: Optional[torch.Tensor] = None,
                compute_dtype=None, *, train: bool = False,
                packed_output: bool = False, fused_tail: bool = False) -> torch.Tensor:
        cfg = self.cfg
        if fused_tail and not (train and packed_output):
            raise ValueError("fused_tail is the train-mode packed_output route")
        if fused_tail and torch.is_grad_enabled():
            raise RuntimeError("fused_tail has no gradient: run it under torch.no_grad()")
        if fused_tail and not fused_tail_supported(cfg):
            raise NotImplementedError("the fused tail (kernel B2) takes 1-channel ReLU "
                                      "tails without class-conditional BN")
        c0 = self.fc.weight.shape[0] // 16
        y_bn = None
        if cfg.num_classes > 0:
            if y is None:
                raise ValueError("conditional generator requires labels y")
            if cfg.g_conditioning in ("full", "embed_only"):
                z = z + take_rows(self.embed, y)
            if cfg.g_conditioning == "concat":
                z = torch.cat([z, F.one_hot(y, cfg.num_classes).to(z.dtype)], dim=1)
            if cfg.g_conditioning in ("full", "bn_only"):
                y_bn = y
        entry = None
        if packed_output:
            if cfg.image_channels != 1:
                raise ValueError("packed_output requires 1-channel images")
            entry = self.tail_entry()
            if entry is None or not cfg.g_pack_pallas:
                raise NotImplementedError(
                    "packed_output is ported through the one-launch tail pack "
                    "(g_pack_pallas) with a block of Cout <= 64 only")
            odt = (getattr(torch, compute_dtype) if isinstance(compute_dtype, str)
                   else compute_dtype) or self.final.weight.dtype
            tail = pack_tail([b.weight for b in self.blocks[entry:]]
                             + [self.final.weight], odt)
        h = linear_oi(z, self.fc.weight, self.fc.bias, compute_dtype=compute_dtype)
        h = self._act(self.fc_bn(h, y_bn, train=train))
        h = h.reshape(h.shape[0], 4, 4, c0)
        for i, blk in enumerate(self.blocks):
            packed = entry is not None and i >= entry
            if fused_tail and packed:
                return self._fused_tail(h, tail, entry, odt)
            if packed and i == entry:
                h = conv2d_oihw(h, tail[0], stride=1, padding=1,
                                compute_dtype=compute_dtype)
            else:
                w = tail[i - entry] if packed else blk.weight
                h = conv_transpose2d_iohw(h, w, stride=2, padding=1,
                                          compute_dtype=compute_dtype)
            h = self._act(blk.bn(h, y_bn, train=train, packed=packed))
        if entry is not None:
            img = conv3_mc_as_matmul_ihwo(h, tail[-1], self.final.bias.expand(4),
                                          compute_dtype)
        else:
            img = conv2d_oihw(h, self.final.weight, self.final.bias, stride=1,
                              padding=1, compute_dtype=compute_dtype)
        # tanh in the compute dtype, as the JAX generator does.
        return torch.tanh(img)


def init_fn(gen: torch.Generator, cfg: ModelConfig, device=None) -> Generator:
    """A generator with the DCGAN init, drawn from ``gen`` (a CPU
    ``torch.Generator``): weights ~ N(0, 0.02), biases 0, BN scale
    ~ N(1, 0.02) (one draw shared by every class row), BN offset 0, and a
    unit-normal class embedding."""
    model = Generator(cfg, device)
    with torch.no_grad():
        model.fc.weight.copy_(init.normal_w(gen, model.fc.weight.shape))
        for bn in [model.fc_bn] + [b.bn for b in model.blocks]:
            bn.scale.copy_(init.bn_scale(gen, bn.scale.shape[-1]).expand_as(bn.scale))
        for blk in model.blocks:
            blk.weight.copy_(init.normal_w(gen, blk.weight.shape))
        model.final.weight.copy_(init.normal_w(gen, model.final.weight.shape))
        if model.embed is not None:
            model.embed.copy_(torch.randn(model.embed.shape, generator=gen))
    return model


def apply_fn(model: Generator, z: torch.Tensor, *, y: Optional[torch.Tensor] = None,
             compute_dtype=None) -> torch.Tensor:
    """Eval-mode forward: z (N, latent_dim) -> images (N, H, W, C)."""
    with torch.no_grad():
        return model(z, y, compute_dtype)


def generate_latent(gen: torch.Generator, n: int, cfg: ModelConfig,
                    scale: float = 1.0) -> torch.Tensor:
    """z ~ N(0, scale^2 I), drawn on the CPU from ``gen``."""
    return torch.randn((n, cfg.latent_dim), generator=gen) * scale


def param_count(model: Generator) -> int:
    return sum(p.numel() for p in model.parameters())
