"""Kernel B4: the whole eval-mode 64 px generator forward.

Port of ``siggan_tpu/ops/pallas/generator_fwd.py`` (``pack_block_taps``,
``pack_generator``, ``generator_forward``). On the card ``generator_forward``
is one host call that launches, in order on the current stream, the fc
kernel (``csrc/generator_fwd.cu``), the upsample block kernel of
``csrc/convt_phase.cuh`` once per block (through
``upsample.upsample_block_taps``), and the final 3x3 conv + tanh kernel.
Intermediates live in device memory (see the source note for why the TPU
design of one kernel with every activation on chip does not carry over).

A CPU tensor takes ``generator_forward_reference``: plain PyTorch with the
same arithmetic (16 per-pixel fc matmuls with BN folded in, per-phase tap
matmuls, depth-to-space, 9-tap final conv). The kernel takes any batch size;
there is no tile padding.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from siggan_tpu_torch.models.generator import Generator
from siggan_tpu_torch.ops.kernels import build
from siggan_tpu_torch.ops.kernels.upsample import (
    convt_phase_reference, fold_bn_affine, upsample_block_taps)

LAUNCHES = build.LaunchCounter()
_SIGNATURES = {
    "siggan_gen_fc": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "siggan_gen_final": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def pack_block_taps(w: torch.Tensor) -> torch.Tensor:
    """(4, 4, Cin, Cout) HWIO ConvT weight -> (4 phases, 2, 2, Cin, Cout).

    Phase (di, dj) output y[i, j] = sum_{a', b'} x[i+di-1+a', j+dj-1+b'] @
    K[phase, a', b'] with K[phase, a', b'] = wf[di+2a', dj+2b'], wf the
    spatially flipped kernel.
    """
    wf = torch.flip(w, dims=(0, 1))
    return torch.stack([
        torch.stack([torch.stack([wf[di + 2 * a, dj + 2 * b] for b in range(2)])
                     for a in range(2)])
        for di in range(2) for dj in range(2)])


def kernel_supported(cfg) -> bool:
    """The kernel serves 64 px, unconditional, 1-channel, ReLU generators."""
    return (cfg.image_size == 64 and cfg.num_classes == 0
            and cfg.image_channels == 1 and cfg.g_activation == "relu")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def pack_generator(model: Generator) -> Dict:
    """Fold eval BN into the weights and restructure them for the kernel.

    Returns f32, contiguous tensors on the model's device: ``wfc16`` (16,
    zdim, C0) and ``bfc16`` (16, C0), the fc split per output pixel (feature
    index (a*4+b)*C0 + c); per block ``taps`` (4, 2, 2, Cin, Cout) and the
    folded ``scale``/``offset`` (Cout,); ``wfin`` (3, 3, C, 1), ``bfin`` (1,).
    """
    if not kernel_supported(model.cfg):
        raise ValueError("the generator kernel serves 64 px unconditional "
                         "1-channel ReLU models only")
    c0 = model.fc.weight.shape[0] // 16
    zdim = model.fc.weight.shape[1]
    bn = model.fc_bn
    fc_s, fc_o = fold_bn_affine({"scale": bn.scale, "offset": bn.offset},
                                {"mean": bn.mean, "var": bn.var})
    wfc = model.fc.weight.t() * fc_s[None, :]
    bfc = model.fc.bias * fc_s + fc_o
    packed = {"wfc16": _f32(wfc.reshape(zdim, 16, c0).permute(1, 0, 2)),
              "bfc16": _f32(bfc.reshape(16, c0)), "blocks": []}
    for blk in model.blocks:
        s, o = fold_bn_affine({"scale": blk.bn.scale, "offset": blk.bn.offset},
                              {"mean": blk.bn.mean, "var": blk.bn.var})
        packed["blocks"].append({
            "taps": _f32(pack_block_taps(blk.weight.permute(2, 3, 0, 1))),
            "scale": _f32(s), "offset": _f32(o)})
    packed["wfin"] = _f32(model.final.weight.permute(2, 3, 1, 0))
    packed["bfin"] = _f32(model.final.bias)
    return packed


def _final_reference(h: torch.Tensor, wfin: torch.Tensor,
                     bfin: torch.Tensor) -> torch.Tensor:
    n, s, _, _ = h.shape
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1))
    acc = None
    for a in range(3):
        for b in range(3):
            m = hp[:, a:a + s, b:b + s, :] @ wfin[a, b]
            acc = m if acc is None else acc + m
    return torch.tanh(acc + bfin[0])


def generator_forward_reference(packed: Dict, z: torch.Tensor) -> torch.Tensor:
    """The plain version of ``generator_forward``."""
    n = z.shape[0]
    c0 = packed["wfc16"].shape[-1]
    pix = torch.relu(torch.einsum("nk,pkc->npc", z, packed["wfc16"])
                     + packed["bfc16"])
    h = pix.reshape(n, 4, 4, c0)
    for blk in packed["blocks"]:
        h = convt_phase_reference(h, blk["taps"], blk["scale"], blk["offset"])
    return _final_reference(h, packed["wfin"], packed["bfin"])


def generator_forward(packed: Dict, z: torch.Tensor) -> torch.Tensor:
    """z (N, zdim) f32 -> images (N, 64, 64, 1) f32 in [-1, 1].

    CUDA tensors launch the kernels (and raise if a launch fails); CPU
    tensors take the plain version.
    """
    if z.device.type == "cpu":
        return generator_forward_reference(packed, z)
    n, zdim = z.shape
    c0 = packed["bfc16"].shape[-1]
    build.require("z", z, torch.float32, z.device)
    build.require("wfc16", packed["wfc16"], torch.float32, z.device, (16, zdim, c0))
    build.require("bfc16", packed["bfc16"], torch.float32, z.device, (16, c0))
    lib = build.load("generator_fwd", _SIGNATURES)
    h = torch.empty((n, 4, 4, c0), device=z.device, dtype=torch.float32)
    with torch.cuda.device(z.device):
        build.check(lib, lib.siggan_gen_fc(
            z.data_ptr(), packed["wfc16"].data_ptr(), packed["bfc16"].data_ptr(),
            h.data_ptr(), n, zdim, c0, build.stream_ptr(z.device)), "generator fc kernel")
        for blk in packed["blocks"]:
            h = upsample_block_taps(h, blk["taps"], blk["scale"], blk["offset"])
        _, s, _, c = h.shape
        build.require("wfin", packed["wfin"], torch.float32, z.device, (3, 3, c, 1))
        build.require("bfin", packed["bfin"], torch.float32, z.device, (1,))
        if c % 4:
            raise ValueError(f"the final conv kernel needs C % 4 == 0, got {c}")
        img = torch.empty((n, s, s, 1), device=z.device, dtype=torch.float32)
        build.check(lib, lib.siggan_gen_final(
            h.data_ptr(), packed["wfin"].data_ptr(), packed["bfin"].data_ptr(),
            img.data_ptr(), n, s, c, build.stream_ptr(z.device)), "generator final kernel")
    LAUNCHES.add()
    return img
