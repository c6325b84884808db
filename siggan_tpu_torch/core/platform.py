"""Device selection and device info.

``resolve_device`` is the one place that picks the card: entry points pass
their ``device`` argument (default ``"cuda"``) through it, and it raises on a
host without CUDA rather than running on the CPU unasked.
"""

from __future__ import annotations

from typing import Union

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
