"""Kernel B4: the whole eval-mode 64 px generator forward.

Port of ``siggan_tpu/ops/pallas/generator_fwd.py`` (``pack_block_taps``,
``pack_generator``, ``generator_forward``). On the card ``generator_forward``
is one ctypes call, ``siggan_gen_forward`` (``csrc/generator_fwd.cu``),
which launches in order on the current stream the fc kernel, the upsample
block kernel of ``csrc/convt_phase.cuh`` (B3) for blocks 1-3, and one kernel
that runs block 4 and the final 3x3 conv + tanh with block 4's output kept
in shared memory. The blocks and the final conv run on the tensor cores in
3xTF32, the fc in f32 on the CUDA cores. Shapes and dtypes are checked once,
when ``pack_generator`` builds the packed weights on the card (``_Plan``),
and again only when a tensor of the packed dict has been replaced; a call
checks ``z`` and reads the weight pointers from the dict.

A CPU tensor takes ``generator_forward_reference``: plain PyTorch in f32
with the same arithmetic (16 per-pixel fc matmuls with BN folded in,
per-phase tap matmuls, depth-to-space, 9-tap final conv). The kernel takes
any batch size; there is no tile padding.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from siggan_tpu_torch.models.generator import Generator
from siggan_tpu_torch.ops.kernels import build
from siggan_tpu_torch.ops.kernels import upsample
from siggan_tpu_torch.ops.kernels.upsample import (
    KC, NT, convt_phase_reference, fold_bn_affine, mma_taps)

LAUNCHES = build.LaunchCounter()
_SIGNATURES = {"siggan_gen_forward": [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]}
_WEIGHTS = 16   # the tensors siggan_gen_forward reads


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
    index (a*4+b)*C0 + c); per block ``taps`` (4, 2, 2, Cin, Cout), their
    TF32 hi and lo parts in the kernel's layout ``taps_mma``
    (``upsample.mma_taps``) and the folded ``scale``/``offset`` (Cout,);
    ``wfin`` (3, 3, C, 1), ``bfin`` (1,). On the card also ``plan``, the
    kernel's checked arguments. The card reads ``taps_mma`` and the plain
    version ``taps``: a changed block is packed again, never edited in place.
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
        taps = _f32(pack_block_taps(blk.weight.permute(2, 3, 0, 1)))
        packed["blocks"].append({"taps": taps, "taps_mma": mma_taps(taps),
                                 "scale": _f32(s), "offset": _f32(o)})
    packed["wfin"] = _f32(model.final.weight.permute(2, 3, 1, 0))
    packed["bfin"] = _f32(model.final.bias)
    if packed["wfc16"].device.type == "cuda":
        packed["plan"] = _Plan(packed)
    return packed


def _plan_tensors(packed: Dict) -> List[torch.Tensor]:
    """The tensors ``siggan_gen_forward`` reads, in its order (wfc16, bfc16,
    each block's taps_mma, scale and offset, wfin, bfin), then each block's
    ``taps``, whose TF32 split ``taps_mma`` must be."""
    ts = [packed["wfc16"], packed["bfc16"]]
    for blk in packed["blocks"]:
        ts += [blk["taps_mma"], blk["scale"], blk["offset"]]
    return ts + [packed["wfin"], packed["bfin"]] + [blk["taps"] for blk in packed["blocks"]]


class _Plan:
    """What one packed generator fixes, checked once: the widths, the
    integers ``siggan_gen_forward`` takes and the scratch floats per image.
    It remembers the tensors it checked; ``_launch_args`` checks the dict
    again when one of them has been replaced."""

    def __init__(self, packed: Dict) -> None:
        dev, f32 = packed["wfc16"].device, torch.float32
        _, zdim, c0 = packed["wfc16"].shape
        build.require("wfc16", packed["wfc16"], f32, dev, (16, zdim, c0))
        build.require("bfc16", packed["bfc16"], f32, dev, (16, c0))
        widths = [c0]
        if len(packed["blocks"]) != 4:
            raise ValueError("the generator kernel runs the 64 px generator's 4 blocks")
        for b, blk in enumerate(packed["blocks"]):
            cin, cout = widths[-1], blk["taps"].shape[-1]
            if cout % 4:
                raise ValueError(f"the generator kernel needs widths % 4 == 0, "
                                 f"block {b + 1} has Cout={cout}")
            build.require(f"block {b + 1} taps", blk["taps"], f32, dev, (4, 2, 2, cin, cout))
            build.require(f"block {b + 1} taps_mma", blk["taps_mma"], f32, dev,
                          (16, -(-cin // KC), -(-cout // NT) * NT, 16))
            if not torch.equal(blk["taps_mma"], mma_taps(blk["taps"])):
                raise ValueError(f"block {b + 1} taps_mma is not the TF32 split of its "
                                 f"taps: pack the generator again (pack_generator)")
            for key in ("scale", "offset"):
                build.require(f"block {b + 1} {key}", blk[key], f32, dev, (cout,))
            widths.append(cout)
        build.require("wfin", packed["wfin"], f32, dev, (3, 3, widths[-1], 1))
        build.require("bfin", packed["bfin"], f32, dev, (1,))
        self.device, self.zdim, self.widths = dev, zdim, widths
        self.checked = _plan_tensors(packed)
        self.dims = (ctypes.c_int * 6)(zdim, *widths)
        self.scratch = sum(16 * 4 ** b * c for b, c in enumerate(widths[:4]))


def _launch_args(packed: Dict):
    """(plan, the weight pointers read from ``packed`` now). A dict whose
    tensors are not the ones its plan checked is checked again, and the new
    plan kept in it."""
    plan = packed.get("plan")
    if plan is None:
        raise ValueError("the packed generator is not on the card: pack the model "
                         "there (pack_generator) before a CUDA forward")
    tensors = _plan_tensors(packed)
    if len(tensors) != len(plan.checked) or any(
            t is not c for t, c in zip(tensors, plan.checked)):
        plan = packed["plan"] = _Plan(packed)
    ptrs = (ctypes.c_void_p * _WEIGHTS)(*[t.data_ptr() for t in tensors[:_WEIGHTS]])
    return plan, ptrs


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

    CUDA tensors launch the kernels in one host call (and raise if a launch
    fails); CPU tensors take the plain version.
    """
    if z.device.type == "cpu":
        return generator_forward_reference(packed, z)
    plan, weights = _launch_args(packed)
    n = z.shape[0]
    if (z.dtype is not torch.float32 or z.device != plan.device or z.data_ptr() & 15
            or not z.is_contiguous() or z.shape != (n, plan.zdim)):
        build.require("z", z, torch.float32, plan.device, (n, plan.zdim))
    lib = build.load("generator_fwd", _SIGNATURES)
    scratch = torch.empty(n * plan.scratch, device=plan.device, dtype=torch.float32)
    img = torch.empty((n, 64, 64, 1), device=plan.device, dtype=torch.float32)
    build.call(lib, lib.siggan_gen_forward,
               (z.data_ptr(), scratch.data_ptr(), img.data_ptr(), weights, plan.dims, n,
                build.stream_ptr(plan.device)), plan.device, "generator forward kernels")
    LAUNCHES.add()
    upsample.LAUNCHES.add(3)   # blocks 1-3 run B3's kernel
    return img
