"""Kernel B2: the train-mode forward of the packed generator tail, without
gradient -- the generator forward inside every discriminator step.

Port of ``siggan_tpu/ops/pallas/train_tail.py`` (``_stats_to_affine``,
``tail_forward_train``; no patches matrix from ``pack_w9_conv3``: the
kernels read B1's packed weights as they are). From the last pixel-space
activation ``h0`` (N, H, W, Ci) (the ReLU output of the last wide block)
it runs

  entry     3x3 s1p1 conv, pixel space -> packed (N, H, W, 4Co), batch stats
  interior  per block: the previous BN's affine + ReLU, then the packed
            ConvT(4, 2, 1) -> (N, 2H, 2W, 4Co'), batch stats
  final     affine + ReLU, 3x3 conv to the 4 packed image channels, + bias,
            tanh

and returns the packed image ``space_to_depth(image)`` and every tail BN's
new running statistics. Numerics are the TPU kernel's: convolutions sum
compute-dtype operands in f32; each BN's batch sum and sum of squares come
from the f32 conv result before it is stored in the compute dtype; the
biased variance E[y^2] - E[y]^2 pools the 4 phases of a canonical channel
and normalizes, the unbiased one enters the running estimate (momentum 0.1,
eps 1e-5); the folded affine is rounded to the compute dtype and applied
with the ReLU in the next layer's prologue, before its zero padding.

The weights are the packed tail weights of kernel B1
(``ops/kernels/pack_tail.py``) in the layouts it writes: entry OIHW (4Co,
Ci, 3, 3), interior IOHW (4Ci, 4Co, 4, 4), final (4C, 3, 3, 4).

``tail_forward_train`` writes the new running statistics into the BN
state tensors it is given, as the discriminator step needs. On CUDA tensors
it makes one host call of ``csrc/train_tail.cu`` (every layer's kernel and
the statistics in between, nothing leaves the card), counted once in
``LAUNCHES``; on CPU tensors it takes ``tail_forward_train_reference``, the
plain version. There is no fallback from a CUDA tensor to the plain
version. Which configurations take this route is decided by
``models/generator.py::fused_tail_supported``.

Over a mesh of several ranks (``mesh``, ``parallel/mesh.py::DataMesh``)
each BN takes the global batch's statistics, so the ranks' sums are added
between a layer's conv and its finalize: on the card the layer route
(``tail_forward_train_layers``) makes one host call per stage of
``siggan_train_tail_stage`` -- per BN layer its conv and totals, one
all-reduce of the 8 C totals on the current stream, its finalize with the
global count -- and then the final conv; it is counted in ``LAUNCHES`` and
in ``LAYER_LAUNCHES``. Every call stays on the stream, so a CUDA graph
captures it with its all-reduces. The plain version takes the same
``mesh``. On one rank (or without a mesh) the single host call runs.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from siggan_tpu_torch.ops.kernels import build
from siggan_tpu_torch.ops.norm import EPS, MOMENTUM
from siggan_tpu_torch.ops.packed import conv3_mc_as_matmul_ihwo

LAUNCHES = build.LaunchCounter()
LAYER_LAUNCHES = build.LaunchCounter()   # the layer route's share of LAUNCHES
# Every layer's input channel count must be a multiple of 16: the f32
# tile's reduction chunk (kBK in the .cu) and the tensor cores' k16 step, so
# that a chunk never straddles two taps.
CHUNK = 16
_SHAPE = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),   # L, channels (L + 1)
          ctypes.c_int, ctypes.c_int, ctypes.c_int,      # N, H, W of h0
          ctypes.c_int]                                  # bf16
_SIGNATURES = {"siggan_train_tail_scratch": _SHAPE, "siggan_train_tail": [
    ctypes.c_int,                                   # number of conv layers L
    ctypes.POINTER(ctypes.c_void_p),                # weights, L
    ctypes.POINTER(ctypes.c_void_p),                # activations, L + 1 (h0 .. image)
    ctypes.POINTER(ctypes.c_void_p),                # BN scale, L - 1
    ctypes.POINTER(ctypes.c_void_p),                # BN offset, L - 1
    ctypes.POINTER(ctypes.c_void_p),                # running mean, L - 1, in place
    ctypes.POINTER(ctypes.c_void_p),                # running var, L - 1, in place
    ctypes.c_void_p,                                # final bias (1,) f32
    ctypes.c_void_p,                                # scratch f32
    ctypes.c_longlong,                              # scratch size (floats)
    ctypes.POINTER(ctypes.c_int),                   # channels, L + 1
    ctypes.c_int, ctypes.c_int, ctypes.c_int,       # N, H, W of h0
    ctypes.c_int,                                   # bf16
    ctypes.c_void_p]}                               # stream
# The layer route's entry: siggan_train_tail's arguments, then the stage,
# the totals buffer and the batch the totals cover, then the stream.
_SIGNATURES["siggan_train_tail_stage"] = (_SIGNATURES["siggan_train_tail"][:-1] + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def stats_to_affine(ssum: torch.Tensor, ssq: torch.Tensor, scale: torch.Tensor,
                    offset: torch.Tensor, state: Dict[str, torch.Tensor], count: int,
                    mesh=None) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Packed-channel sums (4C,) over ``count`` positions -> the train-mode
    affine (a4, b4) over packed channels (f32) and the new running state:
    the 4 phases of canonical channel c pool into its statistics. With a
    ``mesh`` of several ranks the sums are first added over its ranks and
    ``count`` is each rank's."""
    if mesh is not None and mesh.size > 1:
        ssum, ssq = mesh.all_reduce_sum(torch.cat([ssum, ssq])).chunk(2)
        count *= mesh.size
    c = scale.shape[0]
    mean = (ssum / count).reshape(4, c).mean(0)
    ey2 = (ssq / count).reshape(4, c).mean(0)
    var = ey2 - mean * mean
    n = count * 4
    unbiased = var * (n / max(n - 1, 1))
    new_state = {"mean": (1 - MOMENTUM) * state["mean"] + MOMENTUM * mean,
                 "var": (1 - MOMENTUM) * state["var"] + MOMENTUM * unbiased}
    a = scale.float() * torch.rsqrt(var + EPS)
    b = offset.float() - mean * a
    return a.repeat(4), b.repeat(4), new_state


def tail_cost(batch: int, side: int, canonical: Sequence[Tuple[int, int]],
              itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call at the least the function needs: the
    yardstick of B2's bound. ``canonical`` is the (Ci, Co) of each tail
    ConvT block, entry first; ``side`` is h0's side; ``itemsize`` the
    compute dtype's. FLOPs: every tail ConvT at 16 Ci Co H_in W_in MACs and
    the final conv at 9 C over the image. Bytes: h0, the packed weights and
    the image (compute dtype), the BN vectors (f32); and each pre-BN
    intermediate written once and read once, since train-mode BN needs the
    whole batch's statistics before the next layer may read it."""
    macs = acts = 0
    s = side
    for ci, co in canonical:
        macs += 16 * ci * co * s * s
        s *= 2
        acts += batch * s * s * co          # its packed output (N, s/2, s/2, 4Co)
    c = canonical[-1][1]
    macs += 9 * c * s * s
    ci0, co0 = canonical[0]
    weights = 36 * ci0 * co0 + sum(256 * ci * co for ci, co in canonical[1:]) + 144 * c
    nbytes = (itemsize * (batch * side * side * ci0 + weights + batch * s * s + 2 * acts)
              + 4 * (4 * sum(co for _, co in canonical) + 1))
    return 2.0 * batch * macs, float(nbytes)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def tail_forward_train_reference(
        h0: torch.Tensor, packed_ws: Sequence[torch.Tensor],
        bn_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        bn_states: Sequence[Dict[str, torch.Tensor]], final_bias: torch.Tensor,
        compute_dtype: torch.dtype, mesh=None
        ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """The plain version of B2: (packed image (N, H', W', 4) in
    ``compute_dtype``, new running states [{mean, var}] per tail BN); with
    ``mesh``, statistics over its ranks' global batch."""
    cdt = compute_dtype
    ws = [w.to(cdt).float() for w in packed_ws]
    x = h0.to(cdt)
    new_states: List[Dict[str, torch.Tensor]] = []
    a4 = b4 = None
    for i, w in enumerate(ws):
        if i > 0:
            x = torch.relu(x * a4.to(cdt) + b4.to(cdt))
        if i == 0:
            y = _nhwc(F.conv2d(_nchw(x.float()), w, padding=1))
        elif i < len(ws) - 1:
            y = _nhwc(F.conv_transpose2d(_nchw(x.float()), w, stride=2, padding=1))
        else:
            bias4 = final_bias.float().expand(w.shape[-1] // 4).repeat(4)
            y = conv3_mc_as_matmul_ihwo(x.float(), w, bias4)
            return torch.tanh(y).to(cdt), new_states
        scale, offset = bn_params[i]
        count = y.shape[0] * y.shape[1] * y.shape[2]
        a4, b4, st = stats_to_affine(y.sum((0, 1, 2)), (y * y).sum((0, 1, 2)),
                                     scale, offset, bn_states[i], count, mesh)
        new_states.append(st)
        x = y.to(cdt)
    raise ValueError("a packed tail has an entry and a final weight")


def _check_layers(h0: torch.Tensor, packed_ws: Sequence[torch.Tensor]) -> List[int]:
    """Channels [Ci of h0, out channels of each layer]; raises on a weight
    that does not chain."""
    if len(packed_ws) < 2:
        raise ValueError(f"a packed tail has an entry and a final weight, "
                         f"got {len(packed_ws)} weights")
    chans = [h0.shape[-1]]
    for i, w in enumerate(packed_ws):
        if i == 0:
            co, ci = w.shape[0], w.shape[1]
            ok = tuple(w.shape[2:]) == (3, 3)
        elif i < len(packed_ws) - 1:
            ci, co = w.shape[0], w.shape[1]
            ok = tuple(w.shape[2:]) == (4, 4)
        else:
            ci, co = w.shape[0], w.shape[3]
            ok = tuple(w.shape[1:3]) == (3, 3) and co == 4
        if not ok or ci != chans[-1] or co % 4:
            raise ValueError(f"tail weight {i} of shape {tuple(w.shape)} does not "
                             f"take {chans[-1]} channels")
        chans.append(co)
    return chans


class _Plan:
    """What the shapes and the compute dtype of a call fix, built once: the
    channels (as the C array too), the intermediates' and the scratch's
    byte offsets in one buffer, and the image's shape."""

    def __init__(self, lib, h0: torch.Tensor, packed_ws: Sequence[torch.Tensor],
                 compute_dtype: torch.dtype) -> None:
        chans = _check_layers(h0, packed_ws)
        self.n_layers = n_layers = len(packed_ws)
        n, h, w, _ = h0.shape
        self.c_chans = (ctypes.c_int * len(chans))(*chans)
        self.bf16 = int(compute_dtype == torch.bfloat16)
        # f32 scratch for the per-block partial statistics and folded affines
        # (and, in bf16, the weights' canonical taps); its layout follows the
        # kernels' tiling, which only the library knows.
        self.scratch_floats = lib.siggan_train_tail_scratch(n_layers, self.c_chans, n, h, w,
                                                            self.bf16)
        if self.scratch_floats < 0:
            raise ValueError(f"the train-tail kernel does not take channels {chans} at "
                             f"({n}, {h}, {w})")
        isz = torch.empty((), dtype=compute_dtype).element_size()
        self.offsets, nbytes = [], 0
        for i in range(n_layers - 1):   # the intermediates, then the scratch
            if i > 0:
                h, w = 2 * h, 2 * w
            self.offsets.append(nbytes)
            nbytes += -(-n * h * w * chans[i + 1] * isz // 256) * 256
        self.scratch_offset = nbytes
        self.nbytes = nbytes + 4 * self.scratch_floats
        self.image = (n, h, w, chans[-1])
        self.grid = (n, h0.shape[1], h0.shape[2])   # N, H, W of h0
        self.bn_shapes = [(c // 4,) for c in chans[1:-1]]


_plans: Dict[Tuple, _Plan] = {}


def _prepare(h0: torch.Tensor, packed_ws: Sequence[torch.Tensor],
             bn_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
             bn_states: Sequence[Dict[str, torch.Tensor]], final_bias: torch.Tensor,
             compute_dtype: torch.dtype):
    """(library, plan, image, the C arguments before the stream): checks
    every input and allocates the image and the intermediates' buffer."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the train-tail kernel runs bf16 or f32, not {compute_dtype}")
    dev = h0.device
    if dev.type != "cuda":
        raise ValueError(f"the train-tail kernel needs CUDA tensors, got {dev}")
    lib = build.load("train_tail", _SIGNATURES)
    key = (compute_dtype, h0.shape, *[w.shape for w in packed_ws])
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _Plan(lib, h0, packed_ws, compute_dtype)
    n_bn = plan.n_layers - 1
    if len(bn_params) != n_bn or len(bn_states) != n_bn:
        raise ValueError(f"{plan.n_layers} tail weights need {n_bn} BatchNorms")
    build.require("h0", h0, compute_dtype, dev)
    for i, t in enumerate(packed_ws):
        build.require(f"tail weight {i}", t, compute_dtype, dev)
    for i, ((scale, offset), st, c) in enumerate(zip(bn_params, bn_states, plan.bn_shapes)):
        for name, t in (("scale", scale), ("offset", offset), ("mean", st["mean"]),
                        ("var", st["var"])):
            build.require(f"BN {i} {name}", t, torch.float32, dev, c)
    build.require("final bias", final_bias, torch.float32, dev, (1,))

    buf = torch.empty(plan.nbytes, device=dev, dtype=torch.uint8)
    img = torch.empty(plan.image, device=dev, dtype=compute_dtype)
    base = buf.data_ptr()
    ptrs = lambda xs: (ctypes.c_void_p * len(xs))(*xs)  # noqa: E731
    args = (plan.n_layers, ptrs([t.data_ptr() for t in packed_ws]),
            ptrs([h0.data_ptr(), *[base + o for o in plan.offsets], img.data_ptr()]),
            ptrs([p[0].data_ptr() for p in bn_params]),
            ptrs([p[1].data_ptr() for p in bn_params]),
            ptrs([s["mean"].data_ptr() for s in bn_states]),
            ptrs([s["var"].data_ptr() for s in bn_states]),
            final_bias.data_ptr(), base + plan.scratch_offset, plan.scratch_floats,
            plan.c_chans, *plan.grid, plan.bf16)
    # The intermediates' buffer lives as long as the image.
    return lib, plan, img, args, buf


def tail_forward_train_launch(
        h0: torch.Tensor, packed_ws: Sequence[torch.Tensor],
        bn_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        bn_states: Sequence[Dict[str, torch.Tensor]], final_bias: torch.Tensor,
        compute_dtype: torch.dtype) -> torch.Tensor:
    """B2 on the card: one host call; writes the new running statistics into
    ``bn_states`` and returns the packed image. Nothing that holds data is
    cached: every pointer is read on every call."""
    lib, _, img, args, _buf = _prepare(h0, packed_ws, bn_params, bn_states, final_bias,
                                       compute_dtype)
    dev = h0.device
    build.call(lib, lib.siggan_train_tail, (*args, build.stream_ptr(dev)), dev,
               "train-tail kernel")
    LAUNCHES.add()
    return img


def tail_forward_train_layers(
        h0: torch.Tensor, packed_ws: Sequence[torch.Tensor],
        bn_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        bn_states: Sequence[Dict[str, torch.Tensor]], final_bias: torch.Tensor,
        compute_dtype: torch.dtype, mesh=None) -> torch.Tensor:
    """B2 on the card through the layer route: per BN layer a host call of
    its conv and totals, the totals all-reduced over ``mesh``'s ranks (on
    one rank an all-reduce that changes nothing; without a mesh none), a
    host call of its finalize over the global batch; then the final conv.
    Writes the new running statistics into ``bn_states`` and returns the
    packed image. Raises on a failed build or launch, as the single call
    does."""
    lib, plan, img, args, _buf = _prepare(h0, packed_ws, bn_params, bn_states, final_bias,
                                          compute_dtype)
    dev = h0.device
    world = 1 if mesh is None else mesh.size
    n_total = h0.shape[0] * world
    for i, (c,) in enumerate(plan.bn_shapes):
        totals = torch.empty(8 * c, device=dev, dtype=torch.float32)
        build.call(lib, lib.siggan_train_tail_stage,
                   (*args, 2 * i, totals.data_ptr(), n_total, build.stream_ptr(dev)), dev,
                   "train-tail kernel (layer route)")
        if mesh is not None:
            mesh.all_reduce_(totals)
        build.call(lib, lib.siggan_train_tail_stage,
                   (*args, 2 * i + 1, totals.data_ptr(), n_total, build.stream_ptr(dev)), dev,
                   "train-tail kernel (layer route)")
    build.call(lib, lib.siggan_train_tail_stage,
               (*args, 2 * len(plan.bn_shapes), None, n_total, build.stream_ptr(dev)), dev,
               "train-tail kernel (layer route)")
    LAUNCHES.add()
    LAYER_LAUNCHES.add()
    return img


def tail_forward_train(
        h0: torch.Tensor, packed_ws: Sequence[torch.Tensor],
        bn_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        bn_states: Sequence[Dict[str, torch.Tensor]], final_bias: torch.Tensor,
        compute_dtype: torch.dtype, mesh=None) -> torch.Tensor:
    """The packed image; the new running statistics are written into
    ``bn_states``' tensors. CUDA tensors make one host call of kernel B2,
    or with a ``mesh`` of several ranks its layer route; CPU tensors take
    the plain version. No gradient: call it under ``torch.no_grad()``."""
    if torch.is_grad_enabled():
        raise RuntimeError("the train-tail forward has no gradient; call it under "
                           "torch.no_grad()")
    if h0.device.type == "cpu":
        img, new = tail_forward_train_reference(h0, packed_ws, bn_params, bn_states,
                                                final_bias, compute_dtype, mesh)
        for dst, src in zip(bn_states, new):
            dst["mean"].copy_(src["mean"])
            dst["var"].copy_(src["var"])
        return img
    args = (h0.to(compute_dtype).contiguous(), [w.contiguous() for w in packed_ws], bn_params,
            bn_states, final_bias, compute_dtype)
    if mesh is not None and mesh.size > 1:
        return tail_forward_train_layers(*args, mesh=mesh)
    return tail_forward_train_launch(*args)
