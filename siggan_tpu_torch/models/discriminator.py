"""DCGAN-style signature discriminator as an ``nn.Module``.

Same architecture as the JAX package's ``models/discriminator.py``, with or
without spectral norm, unconditional or conditional:

  x (N, H, W, C) in [-1, 1]
   -> k x [Conv(4,2,1) + bias [+SN] -> LeakyReLU(0.2) -> Dropout2d(0.25)]
        64px:  1->64->128->256->512      (64x64 -> 4x4)
        128px: 1->64->128->256->512->512
   -> flatten in HWC order -> Linear(512*4*4, 1) [+SN]   (logits, f32)
   [-> + <class_embed[y], flat> in f32 (projection head, num_classes > 0
        and d_projection)]
   [-> aux logits = flat @ aux.w^T + aux.b in f32 (AC-GAN head,
        aux_classifier; returned when ``aux=True``)]

Conv weights are stored OIHW, the head as ``nn.Linear`` (1, 8192) whose
columns are the NHWC feature map flattened in HWC order -- the JAX head's
order, so ``bridge.py`` only transposes. ``packed_input=True`` takes the
image in 2x2 space-to-depth form and folds the unpacking into the first
conv (``ops/packed.py::pack_first_conv_kernel``). Dropout masks are drawn
from a ``torch.Generator`` block by block, or injected (one (N, 1, 1, C)
keep-mask per block).

With ``use_spectral_norm`` every conv block and the head divide their
weight by its spectral norm (``ops/regularizers.py``); each layer's
power-iteration vector is the buffer ``u`` (start e_0), which a train-mode
forward advances by one iteration in place, as each JAX train-mode forward
returns its new ``d_state``. With ``packed_input`` the canonical (O, 1, 4,
4) weight is normalized before it is packed.

The heads are normalized too, on the matrix orientation the JAX package's
``spectral_norm`` sees (its LAST axis is "out"): ``class_embed`` is stored
as there, (num_classes, 8192), and normalized through its transpose, so
its ``class_embed_u`` has length 8192; ``aux`` is stored out-first,
(num_classes, 8192) as ``nn.Linear`` (the JAX (8192, num_classes)
transposed), so its ``u`` has length num_classes, as there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from siggan_tpu_torch.core.config import ModelConfig
from siggan_tpu_torch.ops import initializers as init
from siggan_tpu_torch.ops.activations import leaky_relu, take_rows
from siggan_tpu_torch.ops.conv import conv2d_oihw, linear_oi
from siggan_tpu_torch.ops.packed import pack_first_conv_kernel
from siggan_tpu_torch.ops.regularizers import dropout2d, sn_init, spectral_norm

FINAL_FEATURES = 512 * 4 * 4


def channel_schedule(cfg: ModelConfig) -> List[Tuple[int, int]]:
    if cfg.image_size == 64:
        return [(cfg.image_channels, 64), (64, 128), (128, 256), (256, 512)]
    if cfg.image_size == 128:
        return [(cfg.image_channels, 64), (64, 128), (128, 256), (256, 512), (512, 512)]
    raise ValueError(f"input_size must be 64 or 128, got {cfg.image_size}")


class _Layer(nn.Module):
    def __init__(self, wshape, nb: int, sn: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(wshape, device=device))
        self.bias = nn.Parameter(torch.zeros(nb, device=device))
        self.register_buffer("u", sn_init(wshape[0], device) if sn else None)

    def normalized_weight(self, train: bool) -> torch.Tensor:
        """The weight, spectrally normalized when the layer has a ``u``; a
        train-mode call advances ``u`` in place."""
        if self.u is None:
            return self.weight
        w, u = spectral_norm(self.weight, self.u, train=train)
        if train:
            with torch.no_grad():
                self.u.copy_(u)
        return w


def _projection(cfg: ModelConfig) -> bool:
    return cfg.num_classes > 0 and cfg.d_projection


class Discriminator(nn.Module):
    """``forward(x, train=..., gen=... | masks=..., y=..., aux=...)`` ->
    logits (N, 1) f32, or (logits, aux_logits (N, num_classes) f32) when
    ``aux``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        sn = cfg.use_spectral_norm
        self.blocks = nn.ModuleList(_Layer((co, ci, 4, 4), co, sn, device)
                                    for ci, co in channel_schedule(cfg))
        self.fc = _Layer((1, FINAL_FEATURES), 1, sn, device)
        self.class_embed = (nn.Parameter(torch.zeros((cfg.num_classes, FINAL_FEATURES),
                                                     device=device))
                            if _projection(cfg) else None)
        self.register_buffer("class_embed_u", sn_init(FINAL_FEATURES, device)
                             if sn and _projection(cfg) else None)
        self.aux = (_Layer((cfg.num_classes, FINAL_FEATURES), cfg.num_classes, sn, device)
                    if cfg.num_classes > 0 and cfg.aux_classifier else None)

    def embed_weight(self, train: bool) -> torch.Tensor:
        """The class embedding, spectrally normalized through its transpose
        (the JAX orientation) when the model has spectral norm; a
        train-mode call advances ``class_embed_u`` in place."""
        if self.class_embed_u is None:
            return self.class_embed
        w, u = spectral_norm(self.class_embed.t(), self.class_embed_u, train=train)
        if train:
            with torch.no_grad():
                self.class_embed_u.copy_(u)
        return w.t()

    def forward(self, x: torch.Tensor, *, train: bool, compute_dtype=None,
                packed_input: bool = False, gen: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None,
                y: Optional[torch.Tensor] = None, aux: bool = False):
        cfg = self.cfg
        drop = train and cfg.dropout > 0
        if drop and gen is None and masks is None:
            raise ValueError("training discriminator forward requires a dropout "
                             "generator or masks")
        h = x
        for i, blk in enumerate(self.blocks):
            w = blk.normalized_weight(train)
            if packed_input and i == 0:
                if cfg.image_channels != 1:
                    raise ValueError("packed_input requires 1-channel images")
                wp = pack_first_conv_kernel(w.permute(2, 3, 1, 0))
                h = conv2d_oihw(h, wp.permute(3, 2, 0, 1), blk.bias, stride=1,
                                padding=1, compute_dtype=compute_dtype)
            else:
                h = conv2d_oihw(h, w, blk.bias, stride=2, padding=1,
                                compute_dtype=compute_dtype)
            h = leaky_relu(h, cfg.leaky_slope)
            if drop:
                h = dropout2d(h, cfg.dropout, train=True, gen=gen,
                              mask=None if masks is None else masks[i])
        flat = h.reshape(h.shape[0], -1)
        logits = linear_oi(flat, self.fc.normalized_weight(train), self.fc.bias,
                           compute_dtype=compute_dtype).float()
        if self.class_embed is not None:
            if y is None:
                raise ValueError("conditional discriminator requires labels y")
            emb = take_rows(self.embed_weight(train), y)
            logits = logits + torch.sum(flat.float() * emb.float(), dim=-1, keepdim=True)
        if not aux:
            return logits
        if self.aux is None:
            raise ValueError("aux=True requires the aux_classifier head")
        # The JAX head multiplies in f32 (compute_dtype=None promotes flat).
        return logits, linear_oi(flat.float(), self.aux.normalized_weight(train),
                                 self.aux.bias).float()


def init_fn(gen: torch.Generator, cfg: ModelConfig, device=None) -> Discriminator:
    """A discriminator with the DCGAN init from ``gen`` (a CPU generator):
    weights ~ N(0, 0.02) (blocks, fc, then the class embedding and the aux
    head where present), biases 0, spectral-norm vectors e_0."""
    model = Discriminator(cfg, device)
    with torch.no_grad():
        for layer in list(model.blocks) + [model.fc]:
            layer.weight.copy_(init.normal_w(gen, layer.weight.shape))
        if model.class_embed is not None:
            model.class_embed.copy_(init.normal_w(gen, model.class_embed.shape))
        if model.aux is not None:
            model.aux.weight.copy_(init.normal_w(gen, model.aux.weight.shape))
    return model
