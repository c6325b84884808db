"""Kernels B1 and B1': pack every packed generator-tail weight in one launch,
and its transpose.

Port of ``siggan_tpu/ops/packed.py::pack_tail_kernels_pallas`` (forward
``kernel`` and backward ``bwd_kernel``). ``pack_tail`` is a
``torch.autograd.Function``: on CUDA tensors the forward launches B1 and
the backward B1' (``csrc/pack_tail.cu``), each counted in its
``LaunchCounter``; on CPU tensors both take the plain PyTorch versions
below. There is no fallback from a CUDA tensor to the plain version.

Layouts. The weights come in the generator's stored layouts -- the entry
block and every interior block as ``ConvTranspose2d`` weights (Ci, Co, 4, 4)
IOHW, the final conv as (1, C, 3, 3) OIHW -- and go out in the layouts
their consumers read: the entry's packed kernel OIHW (4Co, Ci, 3, 3) for
``F.conv2d``, each interior's IOHW (4Ci, 4Co, 4, 4) for
``F.conv_transpose2d``, the final's (4C, 3, 3, 4) for
``ops/packed.py::conv3_mc_as_matmul_ihwo``. Outputs are cast to
``out_dtype``; gradients come back as f32, accumulated in f32 whatever the
cotangents' dtype, as the JAX kernel does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from siggan_tpu_torch.ops import packed as pk
from siggan_tpu_torch.ops.kernels import build

FWD_LAUNCHES = build.LaunchCounter()
BWD_LAUNCHES = build.LaunchCounter()
ENTRY, INTERIOR, FINAL = 0, 1, 2
_ARGS = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
         ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
         ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {"siggan_pack_tail_fwd": _ARGS, "siggan_pack_tail_bwd": _ARGS}


def kinds(n: int) -> List[int]:
    """Kinds of ``n`` tail weights: [entry, interior..., final]."""
    if n < 2:
        raise ValueError(f"a packed tail has an entry and a final weight, got {n}")
    return [ENTRY] + [INTERIOR] * (n - 2) + [FINAL]


def dims(w: torch.Tensor, kind: int) -> Tuple[int, int]:
    """(Ci, Co) of a canonical weight in its stored layout."""
    if kind == FINAL:
        co, ci, kh, kw = w.shape
        k = 3
    else:
        ci, co, kh, kw = w.shape
        k = 4
    if (kh, kw) != (k, k):
        raise ValueError(f"tail weight of kind {kind} has shape {tuple(w.shape)}")
    return ci, co


def packed_shape(kind: int, ci: int, co: int) -> Tuple[int, ...]:
    if kind == ENTRY:
        return (4 * co, ci, 3, 3)
    if kind == INTERIOR:
        return (4 * ci, 4 * co, 4, 4)
    return (4 * ci, 3, 3, 4 * co)


def _pack_one(w: torch.Tensor, kind: int) -> torch.Tensor:
    """One weight through the HWIO pack law of ``ops/packed.py``, in the
    consumer's layout."""
    if kind == ENTRY:
        return pk.pack_convt_kernel_out_mc(w.permute(2, 3, 0, 1)).permute(3, 2, 0, 1)
    if kind == INTERIOR:
        return pk.pack_convt_kernel_both_mc(w.permute(2, 3, 0, 1)).permute(2, 3, 0, 1)
    return pk.pack_conv3_kernel_both_mc(w.permute(2, 3, 1, 0)).permute(2, 0, 1, 3)


def pack_tail_reference(ws: Sequence[torch.Tensor],
                        out_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """The plain version of B1: cast, then place (pad / phase slices /
    planar concat), contiguous in the consumer layouts."""
    odt = out_dtype or ws[0].dtype
    return tuple(_pack_one(w.to(odt), k).contiguous() for w, k in zip(ws, kinds(len(ws))))


# The placement of each kind as (start row, start col) of every phase block
# in the zero-padded HWIO kernel, in the JAX kernel's block order (p-major,
# q-minor), with the padding (lo, hi) and the block extent.
def _starts(kind: int):
    if kind == ENTRY:
        return [(2 - qr, 2 - qc) for qr in (0, 1) for qc in (0, 1)], (2, 2), 3
    if kind == INTERIOR:
        return ([(3 + qr - 2 * pr, 3 + qc - 2 * pc) for pr in (0, 1) for pc in (0, 1)
                 for qr in (0, 1) for qc in (0, 1)], (4, 4), 4)
    return ([(2 + pr - qr, 2 + pc - qc) for pr in (0, 1) for pc in (0, 1)
             for qr in (0, 1) for qc in (0, 1)], (3, 4), 3)


def _unpack_one(dp: torch.Tensor, kind: int, ci: int, co: int) -> torch.Tensor:
    """Transpose of one placement: f32 packed cotangent in the consumer
    layout -> f32 gradient in the stored layout. Blocks are added into the
    padded kernel in the JAX kernel's order, so each element sums the same
    terms in the same order."""
    to_hwio = {ENTRY: (2, 3, 1, 0), INTERIOR: (2, 3, 0, 1), FINAL: (1, 2, 0, 3)}
    d = dp.float().permute(*to_hwio[kind])
    starts, (lo, hi), kk = _starts(kind)
    k = 3 if kind == FINAL else 4
    acc = d.new_zeros((k + lo + hi, k + lo + hi, ci, co))
    for bi, (r0, c0) in enumerate(starts):
        p, q = (0, bi) if kind == ENTRY else (bi // 4, bi % 4)
        acc[r0:r0 + 2 * kk:2, c0:c0 + 2 * kk:2] += d[:, :, p * ci:(p + 1) * ci,
                                                     q * co:(q + 1) * co]
    g = acc[lo:lo + k, lo:lo + k]
    if kind == ENTRY:
        g = torch.flip(g, dims=(0, 1))
    return g.permute(3, 2, 0, 1) if kind == FINAL else g.permute(2, 3, 0, 1)


def pack_tail_backward_reference(ws: Sequence[torch.Tensor],
                                 dps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The plain version of B1': the transpose of the placement applied to
    the cotangents, accumulated in f32."""
    return tuple(_unpack_one(d, k, *dims(w, k)).contiguous()
                 for w, d, k in zip(ws, dps, kinds(len(ws))))


def _layout(shapes: Sequence[Tuple[int, ...]], isz: int):
    """([(shape, stride, offset)], total elements) of contiguous tensors of
    ``shapes`` in one buffer, each at a 16-byte aligned offset."""
    views, total = [], 0
    for shape in shapes:
        views.append((shape, torch.empty(shape, device="meta").stride(), total))
        total += -(-math.prod(shape) * isz // 16) * 16 // isz
    return views, total


class _Plan:
    """What one weight list's shapes and the packed dtype fix, built once:
    the kinds and (Ci, Co), each packed output's (shape, stride, offset) in
    one buffer and each f32 gradient's in another (16-byte aligned), and the
    ctypes integer arrays of the call."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], out_dtype: torch.dtype) -> None:
        ks = kinds(len(shapes))
        cis, cos = zip(*(dims(torch.empty(s, device="meta"), k) for s, k in zip(shapes, ks)))
        self.shapes = [packed_shape(k, ci, co) for k, ci, co in zip(ks, cis, cos)]
        isz = torch.empty((), dtype=out_dtype).element_size()
        self.views, self.total = _layout(self.shapes, isz)
        self.offsets = [isz * off for _, _, off in self.views]   # in bytes
        self.grad_views, self.grad_total = _layout([tuple(s) for s in shapes], 4)
        self.grad_offsets = [4 * off for _, _, off in self.grad_views]
        self.ptrs = ctypes.c_void_p * len(ks)
        ints = ctypes.c_int * len(ks)
        self.args = (len(ks), ints(*ks), ints(*cis), ints(*cos))


_plans: Dict[Tuple, _Plan] = {}


def _plan(ws: Sequence[torch.Tensor], out_dtype: torch.dtype) -> _Plan:
    key = (out_dtype, *[w.shape for w in ws])
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _Plan([tuple(w.shape) for w in ws], out_dtype)
    return plan


def _launch(entry: str, plan: _Plan, in_ptrs: List[int], out_ptrs: List[int], bf16: bool,
            device: torch.device) -> None:
    lib = build.load("pack_tail", _SIGNATURES)
    args = (*plan.args, plan.ptrs(*in_ptrs), plan.ptrs(*out_ptrs), int(bf16),
            build.stream_ptr(device))
    build.call(lib, getattr(lib, entry), args, device, "pack tail kernel")


def pack_tail_launch(ws: Sequence[torch.Tensor],
                     out_dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """B1 on the card: f32 canonical weights -> packed weights in
    ``out_dtype`` (bf16 or f32), one launch. The outputs are views of one
    buffer. Nothing that holds data is cached: the weights' pointers are
    read on every call (the optimizer updates them in place, and a later
    call may pass other tensors)."""
    if out_dtype is not torch.bfloat16 and out_dtype is not torch.float32:
        raise TypeError(f"the pack kernel writes bf16 or f32, not {out_dtype}")
    dev = ws[0].device
    if dev.type != "cuda":
        raise ValueError(f"the pack kernel needs CUDA tensors, got {dev}")
    plan = _plan(ws, out_dtype)
    ptrs = []
    for i, w in enumerate(ws):   # one combined test each; require names a failure
        p = w.data_ptr()
        if p & 15 or w.dtype is not torch.float32 or w.device != dev or not w.is_contiguous():
            build.require(f"tail weight {i}", w, torch.float32, dev)
        ptrs.append(p)
    buf = torch.empty(plan.total, device=dev, dtype=out_dtype)
    base = buf.data_ptr()
    _launch("siggan_pack_tail_fwd", plan, ptrs, [base + o for o in plan.offsets],
            out_dtype is torch.bfloat16, dev)
    FWD_LAUNCHES.add()
    return tuple([buf.as_strided(*v) for v in plan.views])


def pack_tail_backward_launch(ws: Sequence[torch.Tensor],
                              dps: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """B1' on the card: packed cotangents (bf16 or f32, one dtype) -> f32
    canonical gradients in the stored layouts, one launch. The gradients
    are views of one buffer; the cotangents' pointers are read on every
    call."""
    dev = ws[0].device
    if dev.type != "cuda":
        raise ValueError(f"the pack kernel needs CUDA tensors, got {dev}")
    dt = dps[0].dtype
    if dt is not torch.bfloat16 and dt is not torch.float32:
        raise TypeError(f"the pack backward reads bf16 or f32, not {dt}")
    plan = _plan(ws, dt)
    ptrs = []
    for i, (d, shape) in enumerate(zip(dps, plan.shapes)):   # one combined test each
        p = d.data_ptr()
        if (p & 15 or d.dtype is not dt or d.device != dev or not d.is_contiguous()
                or d.shape != shape):
            build.require(f"cotangent {i}", d, dt, dev, shape)
        ptrs.append(p)
    buf = torch.empty(plan.grad_total, device=dev, dtype=torch.float32)
    base = buf.data_ptr()
    _launch("siggan_pack_tail_bwd", plan, ptrs, [base + o for o in plan.grad_offsets],
            dt is torch.bfloat16, dev)
    BWD_LAUNCHES.add()
    return tuple([buf.as_strided(*v) for v in plan.grad_views])


class _PackTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out_dtype, *ws):
        ctx.save_for_backward(*ws)
        ctx.out_dtype = out_dtype
        if ws[0].device.type == "cpu":
            return pack_tail_reference(ws, out_dtype)
        return pack_tail_launch(ws, out_dtype)

    @staticmethod
    def backward(ctx, *dps):
        ws, odt = ctx.saved_tensors, ctx.out_dtype
        if any(d is None or d.dtype is not odt or not d.is_contiguous() for d in dps):
            shapes = _plan(ws, odt).shapes
            dps = [torch.zeros(s, device=ws[0].device, dtype=odt) if d is None
                   else d.to(odt).contiguous() for d, s in zip(dps, shapes)]
        if ws[0].device.type == "cpu":
            return (None, *pack_tail_backward_reference(ws, dps))
        return (None, *pack_tail_backward_launch(ws, dps))


def pack_tail(ws: Sequence[torch.Tensor],
              out_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """[entry (Ci,Co,4,4), interior (Ci,Co,4,4)..., final (1,C,3,3)] f32 ->
    their packed forms in ``out_dtype`` (default: the weights' dtype), in
    the consumer layouts; differentiable. CUDA tensors launch B1 (and B1'
    in the backward); CPU tensors take the plain versions."""
    return _PackTail.apply(out_dtype or ws[0].dtype, *ws)
