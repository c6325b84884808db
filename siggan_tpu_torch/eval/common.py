"""Shared eval plumbing: the chunked inference loop and full-f32 convs.

Port of the JAX package's ``eval/common.py:18-35``. ``batched_apply`` runs
a feature extractor (Inception FID features, LPIPS distances) over
arbitrary-N inputs in ``batch_size`` chunks on one device. JAX pads the
tail chunk so that one compiled shape serves every call; PyTorch compiles
nothing, and every eval network runs BatchNorm in eval mode (no batch
statistics), so the tail chunk runs at its own size and no padding is
needed. The outputs stay on the device until the end and reach the host
in one concatenation.

``full_f32`` turns TF32 off for cuDNN's convolutions and cuBLAS's matmuls
inside the eval forwards: PyTorch lets cuDNN run f32 convs in TF32 by
default, which would round every product of the 94-layer Inception stack
to 10 mantissa bits, while the JAX reference (and the port on the CPU)
computes in f32.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def full_f32():
    """TF32 off for convolutions and matmuls inside the block (restored
    after it)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before


def batched_apply(fn: Callable[..., torch.Tensor], *arrays, batch_size: int,
                  device: torch.device) -> np.ndarray:
    """``fn(*chunks)`` over aligned ``batch_size``-row chunks of N-row
    arrays (numpy or tensors), each chunk moved to ``device`` as f32, under
    ``torch.inference_mode`` and ``full_f32``; the outputs concatenated on
    the device and returned as one numpy array of N rows."""
    ts = [a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))
          for a in arrays]
    outs = []
    with torch.inference_mode(), full_f32():
        for s in range(0, len(ts[0]), batch_size):
            outs.append(fn(*(t[s:s + batch_size].to(device, torch.float32) for t in ts)))
        return torch.cat(outs).cpu().numpy()
