"""Siamese signature-verification network.

Port of the JAX package's ``verify/models.py``: a CNN encoder (3 x [conv +
BatchNorm + ReLU + 2 x 2 max pool] -> fc 8192 -> 512 + ReLU -> dropout 0.5
-> fc 512 -> embedding, L2-normalized; embedding 128 by default) used as
weight-shared twins, and a classifier over |emb1 - emb2| (fc -> 64 + ReLU
-> dropout 0.3 -> fc -> 1) that returns the similarity LOGIT. Activations
are NHWC as in JAX (the convs run on channels-last views), so fc1's 8192
inputs are the pooled map flattened in (h, w, c) order and its rows need no
permutation in the bridge (``bridge.verifier_from_jax``).

In train mode each twin is its own BatchNorm batch: twin 1 normalizes with
its batch statistics and updates the running statistics, then twin 2 does
the same from the updated ones, as the JAX function threads its state. The
dropout keep-masks are drawn from a ``torch.Generator`` (uniform < keep,
JAX's ``bernoulli`` law) or given by the caller (``masks``: twin 1's and
twin 2's (N, 512), the classifier's (N, 64)), so a test can run the JAX
package's masks.

``contrastive_loss`` follows the code's label convention: label 1 (same
writer) pulls D^2, label 0 pushes max(0, margin - D)^2, margin 2.0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from siggan_tpu_torch.ops.conv import conv2d_oihw, linear_oi
from siggan_tpu_torch.ops.norm import batch_norm

EMBEDDING_DIM = 128
IMAGE_SIZE = 64

_CONVS = [  # (k, cin, cout, pad)
    (5, 1, 32, 2),
    (5, 32, 64, 2),
    (3, 64, 128, 1),
]
_FC1_IN = 128 * 8 * 8
HIDDEN = 512
CLS_HIDDEN = 64
ENC_DROPOUT, CLS_DROPOUT = 0.5, 0.3


class ConvBlock(nn.Module):
    """conv (OIHW) + BatchNorm (scale, offset; running mean, var) + ReLU +
    2 x 2 max pool, NHWC in and out."""

    def __init__(self, k: int, cin: int, cout: int, pad: int):
        super().__init__()
        self.pad = pad
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.scale = nn.Parameter(torch.ones(cout))
        self.offset = nn.Parameter(torch.zeros(cout))
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))

    def forward(self, h: torch.Tensor, train: bool) -> torch.Tensor:
        h = conv2d_oihw(h, self.weight, self.bias, padding=self.pad)
        h, st = batch_norm(h, self.scale, self.offset,
                           {"mean": self.mean, "var": self.var}, train=train)
        if train:
            with torch.no_grad():
                self.mean.copy_(st["mean"])
                self.var.copy_(st["var"])
        h = F.max_pool2d(torch.relu(h).permute(0, 3, 1, 2), 2)
        return h.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """y = x @ W^T + b with W stored (out, in)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_oi(x, self.weight, self.bias)


def _dropout(x: torch.Tensor, rate: float, mask: Optional[torch.Tensor],
             gen: Optional[torch.Generator]) -> torch.Tensor:
    keep = 1.0 - rate
    if mask is None:
        if gen is None:
            raise ValueError("dropout in train mode needs a generator or a mask")
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    k = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / k, torch.zeros((), dtype=x.dtype, device=x.device))


class Verifier(nn.Module):
    """The encoder and the pair classifier; parameters in the order
    blocks (weight, bias, scale, offset) x 3, fc1, fc2, cls1, cls2."""

    def __init__(self, embedding_dim: int = EMBEDDING_DIM):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.blocks = nn.ModuleList(ConvBlock(*c) for c in _CONVS)
        self.fc1 = Dense(_FC1_IN, HIDDEN)
        self.fc2 = Dense(HIDDEN, embedding_dim)
        self.cls1 = Dense(embedding_dim, CLS_HIDDEN)
        self.cls2 = Dense(CLS_HIDDEN, 1)

    def encode(self, x: torch.Tensor, *, train: bool = False,
               mask: Optional[torch.Tensor] = None,
               gen: Optional[torch.Generator] = None,
               return_hidden: bool = False) -> torch.Tensor:
        """x (N, 64, 64, 1) -> the L2-normalized (N, embedding_dim)
        embedding; ``return_hidden`` returns the 512-d relu(fc1)
        activations instead (the FID backbone ``verifier:<ckpt>``)."""
        h = x
        for blk in self.blocks:
            h = blk(h, train)
        h = torch.relu(self.fc1(h.reshape(h.shape[0], -1)))
        if return_hidden:
            return h
        if train:
            h = _dropout(h, ENC_DROPOUT, mask, gen)
        emb = self.fc2(h)
        return emb / (torch.linalg.vector_norm(emb, dim=1, keepdim=True) + 1e-12)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, *, train: bool = False,
                masks: Optional[Sequence[torch.Tensor]] = None,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(emb1, emb2, similarity logits (N, 1)); twin 1 runs first."""
        m1, m2, m3 = masks if masks is not None else (None, None, None)
        emb1 = self.encode(x1, train=train, mask=m1, gen=gen)
        emb2 = self.encode(x2, train=train, mask=m2, gen=gen)
        h = torch.relu(self.cls1(torch.abs(emb1 - emb2)))
        if train:
            h = _dropout(h, CLS_DROPOUT, m3, gen)
        return emb1, emb2, self.cls2(h)


def _uniform(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """torch's default Conv2d/Linear init (kaiming_uniform, a=sqrt(5)):
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / fan_in ** 0.5
    return torch.rand(shape, generator=gen) * (2 * bound) - bound


@torch.no_grad()
def init_fn(gen: torch.Generator, embedding_dim: int = EMBEDDING_DIM,
            device=None) -> Verifier:
    """A verifier with the JAX package's init law (each weight and bias
    U(+-1/sqrt(fan_in)), BN scale 1 and offset 0, running mean 0 and var 1)
    drawn from the CPU generator ``gen``: the same weights on every device,
    not the JAX package's draws."""
    model = Verifier(embedding_dim)
    for blk, (k, cin, _, _) in zip(model.blocks, _CONVS):
        blk.weight.copy_(_uniform(gen, blk.weight.shape, k * k * cin))
        blk.bias.copy_(_uniform(gen, blk.bias.shape, k * k * cin))
    for fc in (model.fc1, model.fc2, model.cls1, model.cls2):
        fin = fc.weight.shape[1]
        fc.weight.copy_(_uniform(gen, fc.weight.shape, fin))
        fc.bias.copy_(_uniform(gen, fc.bias.shape, fin))
    return model.to(device)


def contrastive_loss(emb1: torch.Tensor, emb2: torch.Tensor, labels: torch.Tensor,
                     margin: float = 2.0) -> torch.Tensor:
    d = torch.sqrt(torch.sum(torch.square(emb1 - emb2), dim=1) + 1e-12)
    loss = (labels * torch.square(d)
            + (1 - labels) * torch.square(torch.clamp(margin - d, min=0.0)))
    return torch.mean(loss)


def param_count(model: Verifier) -> int:
    return sum(p.numel() for p in model.parameters())
