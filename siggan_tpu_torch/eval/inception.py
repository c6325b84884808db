"""InceptionV3 (torchvision variant) as an ``nn.Module``: the FID feature
extractor.

Port of the JAX package's ``eval/inception.py`` (its network ``:24-228``),
NCHW. The target is ``torchvision.models.inception_v3(transform_input=
False)`` with ``fc -> Identity``, as the reference uses it: grayscale images
channel-replicated, bilinearly resized to 299 (half-pixel centres, i.e.
``align_corners=False``), fed in [-1, 1] without ImageNet normalization,
and pooled to ``FEATURE_DIM`` = 2048 features.

The module and parameter names are torchvision's state-dict keys
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``,
...), so a torchvision state dict loads as it is (``load_torchvision``:
``AuxLogits.*`` and ``fc.*`` are ignored, ``num_batches_tracked`` may be
absent); that replaces the JAX package's ``convert_torch_state_dict``
(``:242-282``).

The default backbone is ``init_inception(seed)``: the JAX law (``:62-72``:
conv weights truncated normal at +-2 sigma times the He scale
sqrt(2 / (kh kw cin)), BN scale 1, offset 0, mean 0, var 1) drawn from a
seeded ``torch.Generator``. JAX's threefry draws cannot be reproduced, so
this random-init backbone is not the JAX package's: its FIDs compare only
within the port. To compare across the two packages, load the same weights
into both (a torchvision file, or the JAX tree through
``bridge.inception_from_jax``).

Eval only: every BasicConv2d applies its BatchNorm (eps 1e-3) with the
stored running statistics whatever the module's mode. The pools follow
torchvision: 3x3 stride-2 max pools without padding (floor mode), and the
blocks' 3x3 stride-1 average pools with padding 1 that divide by 9 at the
edges too (``count_include_pad=True``, F.avg_pool2d's default; JAX
``:54-59``). Asymmetric convs take their padding as (H, W), the JAX
``(pad_h, pad_w)`` order.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

FEATURE_DIM = 2048
BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """conv (no bias) + frozen BN (eps 1e-3) + ReLU (JAX ``_bconv``)."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        y = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return F.relu(y)


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avgpool3s1p1(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avgpool3s1p1(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avgpool3s1p1(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avgpool3s1p1(x))], 1)


class InceptionV3(nn.Module):
    """(N, 3, 299, 299) in [-1, 1] -> (N, 2048) pooled features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool3s2(h)))
        h = _maxpool3s2(h)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))


def trunc_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (``jax.random.truncated_normal``'s
    law) from ``gen``."""
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=gen)


def init_inception(seed: int = 0) -> InceptionV3:
    """The fixed-seed random backbone on the CPU, in eval mode (see the
    module docstring): each conv in module order draws from one generator."""
    model = InceptionV3()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BasicConv2d):
                w = m.conv.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(trunc_normal(w.shape, gen) * (2.0 / fan_in) ** 0.5)
    return model.eval().requires_grad_(False)


def load_torchvision(model: InceptionV3, sd: Mapping) -> InceptionV3:
    """Load a torchvision ``inception_v3`` state dict (tensors or numpy
    arrays; checked by ``manifests.check_state_dict`` first) into ``model``:
    ``AuxLogits.*``, ``fc.*`` and other extra keys are ignored, and only
    the ``num_batches_tracked`` counters may be missing."""
    tensors: Dict[str, torch.Tensor] = {k: torch.as_tensor(v) for k, v in sd.items()}
    missing = model.load_state_dict(tensors, strict=False).missing_keys
    absent = [k for k in missing if not k.endswith("num_batches_tracked")]
    if absent:
        raise ValueError(f"{len(absent)} InceptionV3 weights missing (first 5: "
                         f"{absent[:5]})")
    return model.eval().requires_grad_(False)


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1|3) in [-1, 1] -> (N, 3, 299, 299): channel replication,
    then a bilinear resize with half-pixel centres and no antialiasing
    (JAX ``:230-239``; ``jax.image.resize``'s antialiasing changes nothing
    when upsampling, and its edge samples equal align_corners=False's)."""
    x = images.permute(0, 3, 1, 2)
    if x.shape[1] == 1:
        x = x.expand(-1, 3, -1, -1)
    if x.shape[2] != 299 or x.shape[3] != 299:
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=False)
    return x.contiguous()
