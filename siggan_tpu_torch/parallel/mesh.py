"""Data parallelism over several ranks, one process per card: the mesh, the
collectives the train step needs, and the launcher of local ranks.

Port of the JAX package's ``parallel/mesh.py``. There a ``(data, model)``
``jax.sharding.Mesh`` shards the batch over ``data`` and replicates the
state, and GSPMD inserts the collectives. Here each rank is a process with
one card (NCCL) or one CPU (gloo), and the collectives are explicit. The
semantics are the JAX package's (``ops/norm.py``): N ranks train what one
device trains at the same global batch B --

- every rank holds the same state (``replicate`` broadcasts rank 0's);
- rank r trains on rows ``[r B/N, (r+1) B/N)`` of each global batch
  (``rows``, ``shard_rows``), and of every draw made for the global batch;
- BatchNorm takes global-batch statistics (``all_reduce_sum``, which is
  differentiable: the cotangent is all-reduced too);
- gradients and metrics are global means (``average``, ``all_reduce_mean``).

``make_mesh`` returns None for a single process that joined no process
group: that is the one-card run, with no collective at all. A mesh of one
rank (a process group of size 1) runs every collective of the step but
takes its BatchNorm statistics locally, where they already are global.

``spawn`` starts N local ranks of a function (``cli.train
--num_data_devices N`` uses it); this module imports torch only, so a
spawned rank never imports JAX.
"""

from __future__ import annotations

import os
import socket
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from siggan_tpu_torch.core.config import MeshConfig
from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.ops.kernels import build


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward all-reduces the cotangent, since
    every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: "DataMesh") -> torch.Tensor:
        ctx.mesh = mesh
        out = x.contiguous().clone()
        mesh.all_reduce_(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        ctx.mesh.all_reduce_(grad)
        return grad, None


class DataMesh:
    """The data axis of ``size`` ranks as seen by rank ``rank``: its process
    group (NCCL on the card, gloo on the CPU), a gloo group ``control`` for
    the host's decisions (stop, barriers; the same group on the CPU), and
    the rank's ``device``. ``collectives`` counts the all-reduces of the
    train step (a registered launch counter, so a CUDA graph's replays add
    the ones its capture recorded)."""

    def __init__(self, size: int, rank: int, device: DeviceLike, group=None, control=None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        self.size, self.rank = size, rank
        self.device = torch.device(device)
        self.group = group
        self.backend = None if group is None else dist.get_backend(group)
        self.control = control if control is not None else group
        self.collectives = build.LaunchCounter()

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes files."""
        return self.rank == 0

    def local_batch_size(self, global_batch: int) -> int:
        if global_batch % self.size:
            raise ValueError(f"global batch {global_batch} not divisible by data-axis "
                             f"size {self.size}")
        return global_batch // self.size

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch."""
        b = self.local_batch_size(global_batch)
        return slice(self.rank * b, (self.rank + 1) * b)

    def shard_rows(self, t: torch.Tensor, global_batch: int) -> torch.Tensor:
        """This rank's rows of ``t``, whose leading dimension is k whole
        global batches stacked (k = 2 for a D step's ``[real; fake]``): its
        rows of each block, in block order."""
        blocks = t.shape[0] // global_batch
        if blocks < 1 or t.shape[0] % global_batch:
            raise ValueError(f"{tuple(t.shape)} is not whole global batches of "
                             f"{global_batch}")
        r = self.rows(global_batch)
        if blocks == 1:
            return t[r]
        return torch.cat([t[k * global_batch:][r] for k in range(blocks)])

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks in place (on the current stream)."""
        dist.all_reduce(t, group=self.group)
        self.collectives.add()
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The differentiable sum of ``t`` over the ranks."""
        return _AllReduceSum.apply(t, self)

    def average(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean of each tensor over the ranks, by one all-reduce of one
        flat f32 buffer; returns views of that buffer in ``tensors``'
        shapes."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        self.all_reduce_(flat).div_(self.size)
        return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]),
                                                 tensors)]

    def all_reduce_mean(self, metrics: Dict[str, torch.Tensor],
                        keep: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
        """The mean over the ranks of every metric (one all-reduce) but the
        keys in ``keep``, which are the same on every rank already."""
        keys = [k for k in metrics if k not in keep]
        return {**metrics, **dict(zip(keys, self.average([metrics[k] for k in keys])))}

    def replicate(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite every tensor with rank 0's, in place."""
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, 0, group=self.group)

    def barrier(self) -> None:
        dist.barrier(group=self.control)

    def decide(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a stop decision taken once)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.broadcast(t, 0, group=self.control)
        return bool(t.item())


def make_mesh(cfg: MeshConfig = MeshConfig(), device: DeviceLike = "cuda"
              ) -> Optional[DataMesh]:
    """The data axis of the launched ranks, or None for a single process
    that joined no process group.

    ``num_data == -1`` takes every launched rank. Raises when ``num_data``
    exceeds the launched ranks (or falls short of them: every launched rank
    trains) and for a model axis (``num_model > 1``: the port replicates
    nothing but the data axis). Prints the JAX package's note when the mesh
    uses fewer than the visible cards.
    """
    if cfg.num_model != 1:
        raise ValueError(f"num_model={cfg.num_model}: the port's mesh is the data axis "
                         "only (one process per card); use num_model=1")
    dev = resolve_device(device)
    joined = dist.is_available() and dist.is_initialized()
    launched = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    num = cfg.num_data if cfg.num_data > 0 else launched
    if num > launched:
        raise ValueError(f"mesh ({num} data ranks) exceeds the launched ranks ({launched}): "
                         f"train with --num_data_devices {num}, which starts them, or "
                         f"under torchrun --nproc_per_node {num}")
    if num < launched:
        raise ValueError(f"mesh ({num} data ranks) is smaller than the {launched} "
                         f"launched ranks; every rank trains")
    visible = torch.cuda.device_count() if dev.type == "cuda" else launched
    if num < visible and rank == 0:
        print(f"NOTE: mesh uses {num} of {visible} visible devices", flush=True)
    if not joined:
        return None
    control = None
    if dist.get_backend() != "gloo":
        control = dist.new_group(backend="gloo")
    return DataMesh(launched, rank, dev, dist.group.WORLD, control)


def free_port() -> int:
    """A TCP port on localhost that is free now (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    code = fn(*args)
    if code:
        raise SystemExit(code)


def spawn(fn, nprocs: int, *args) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes (the spawn start
    method), ranks 0 .. nprocs - 1 of one job on localhost: each finds its
    rank, the world size and a free coordinator port in torchrun's
    variables (``core/platform.py::init_distributed`` reads them). ``fn``
    is pickled by its import path. Returns when every rank has ended;
    raises when one fails or returns a non-zero code, after ending the
    others."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(nprocs, free_port(), fn, args), nprocs=nprocs,
                       join=True, start_method="spawn")
