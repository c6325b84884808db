"""Device selection, device info and the process group of several ranks.

``resolve_device`` is the one place that picks the card: entry points pass
their ``device`` argument (default ``"cuda"``) through it, and it raises on a
host without CUDA rather than running on the CPU unasked.

``init_distributed`` joins a job of several processes, one per card (the
counterpart of the JAX package's ``core/platform.py::init_distributed``,
where one process drives every local chip).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"`` -> ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and none exists.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def device_info(device: DeviceLike = "cuda") -> dict:
    """What ``/health`` reports about the device the server runs on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(dev),
                "num_devices": torch.cuda.device_count()}
    if dev.type == "cuda":
        return {"platform": "none", "device_kind": "none", "num_devices": 0}
    return {"platform": "cpu", "device_kind": "cpu", "num_devices": 1}


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_distributed(device: DeviceLike = "cuda") -> bool:
    """Join the process group of a job of several ranks, one per card.

    The job is read from the environment: the JAX package's
    ``SIGGAN_COORDINATOR`` (``host:port``), ``SIGGAN_NUM_PROCS`` and
    ``SIGGAN_PROC_ID``, or torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. Returns False, and joins
    nothing, for a single process (no job in the environment, or a world of
    one); True once the group is initialized (or already was).

    The backend follows ``device``: NCCL for ``"cuda"``, with the rank bound
    to ``cuda:LOCAL_RANK`` (raises when that card does not exist: a rank
    never moves to the CPU), gloo for ``"cpu"``. Call it before anything
    touches the card.
    """
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return True
    world = _env_int("SIGGAN_NUM_PROCS", "WORLD_SIZE")
    rank = _env_int("SIGGAN_PROC_ID", "RANK")
    if world is None or world <= 1:
        return False
    if rank is None or not 0 <= rank < world:
        raise ValueError(f"a job of {world} processes needs a rank in [0, {world}), "
                         f"got {rank}")
    coordinator = os.environ.get("SIGGAN_COORDINATOR")
    if coordinator is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("a job of several processes needs SIGGAN_COORDINATOR or "
                             "MASTER_ADDR and MASTER_PORT")
        coordinator = f"{addr}:{port}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("rank %d of %d asks for a CUDA card, but "
                               "torch.cuda.is_available() is False" % (rank, world))
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = rank % torch.cuda.device_count()
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} has no card: "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return True
