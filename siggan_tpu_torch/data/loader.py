"""Batch iteration over a host-resident set, with copies to the card kept
``prefetch`` batches ahead of the step.

Port of the JAX package's ``data/loader.py::BatchLoader`` on one process:
the same seeded epoch order (``RandomState((seed, epoch)).permutation``),
the same batches, ``len()``, ``shuffle`` and ``drop_last``, and aligned
``(images, labels)`` pairs for a conditional model. Over a mesh of ranks
(``mesh``, ``parallel/mesh.py::DataMesh``) every rank holds the whole set,
walks the same global order and yields only its rows of each global batch
of ``batch_size`` (``DataMesh.rows``); the remainder is dropped, as the
JAX loader drops it under a mesh.

On the card the set stays in host memory; only the batches in flight are
on the device. Each batch is gathered with numpy into one of a ring of
pinned staging buffers, copied by a side stream with ``non_blocking=True``
into the device slot of the same index, and handed over after the
consuming stream (the current stream where the batch is asked for) waits
on the copy's event. When the consumer asks for the next batch, an event
is recorded on its stream; a slot is refilled only after the host has
waited on that event, so neither its staging buffer nor its device buffer
is written while a step that reads it may still run. The ring holds
``prefetch + 2`` slots: ``prefetch`` copies ahead, the batch being
consumed, and the one before it, whose step the card may still be running
when the host refills. On the CPU the batches are plain tensors.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from siggan_tpu_torch.core.platform import DeviceLike, resolve_device
from siggan_tpu_torch.parallel.mesh import DataMesh


class BatchLoader:
    """Seeded, epoch-aware batch iterator over a host (N, ...) array."""

    def __init__(self, images: np.ndarray, batch_size: int, *,
                 labels: Optional[np.ndarray] = None, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, mesh=None, prefetch: int = 2,
                 device: DeviceLike = "cuda"):
        if mesh is not None and not isinstance(mesh, DataMesh):
            raise TypeError(f"mesh must be a parallel.mesh.DataMesh, got {type(mesh).__name__}")
        if mesh is not None:
            # A partial final batch cannot be split over the ranks.
            drop_last = True
        self.mesh = mesh
        self.local_bs = batch_size if mesh is None else mesh.local_batch_size(batch_size)
        self.images = images
        if labels is not None and len(labels) != len(images):
            raise ValueError(f"labels ({len(labels)}) and images ({len(images)}) lengths "
                             "differ")
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        if drop_last and len(images) < batch_size:
            raise ValueError(f"dataset shard ({len(images)}) smaller than the per-process "
                             f"batch ({batch_size})")
        self._ring: Optional[_Ring] = None

    def __len__(self) -> int:
        n = len(self.images) // self.batch_size
        if not self.drop_last and len(self.images) % self.batch_size:
            n += 1
        return n

    def order(self, epoch_idx: int) -> np.ndarray:
        """The epoch's order of the set, as the JAX loader draws it."""
        n = len(self.images)
        if self.shuffle:
            return np.random.RandomState((self.seed, epoch_idx)).permutation(n)
        return np.arange(n)

    def epoch(self, epoch_idx: int) -> Iterator:
        """The epoch's batches (``(images, labels)`` pairs with labels), on
        the loader's device: over a mesh, this rank's rows of each."""
        order = self.order(epoch_idx)
        sels = [order[b * self.batch_size:(b + 1) * self.batch_size]
                for b in range(len(self))]
        if self.mesh is not None:
            mine = self.mesh.rows(self.batch_size)
            sels = [sel[mine] for sel in sels]
        if self.device.type != "cuda":
            for sel in sels:
                x = torch.from_numpy(self.images[sel])
                yield x if self.labels is None else (x, torch.from_numpy(self.labels[sel]))
            return
        if self._ring is None:
            self._ring = _Ring(self, self.prefetch + 2)
        yield from self._ring.run(sels)


class _Ring:
    """The staging ring of a loader on the card: per slot a pinned host
    buffer and a device buffer (and the same for labels), the event of the
    copy into it and the event of its consumer."""

    def __init__(self, loader: BatchLoader, slots: int):
        self.loader = loader
        dev, b = loader.device, loader.local_bs
        self.arrays = [loader.images] + ([] if loader.labels is None else [loader.labels])
        self.host: List[List[torch.Tensor]] = []
        self.dev: List[List[torch.Tensor]] = []
        for a in self.arrays:
            t = torch.from_numpy(a[:1])
            shape = (b, *a.shape[1:])
            self.host.append([torch.empty(shape, dtype=t.dtype, pin_memory=True)
                              for _ in range(slots)])
            self.dev.append([torch.empty(shape, dtype=t.dtype, device=dev)
                             for _ in range(slots)])
        self.copied = [torch.cuda.Event() for _ in range(slots)]
        self.consumed = [torch.cuda.Event() for _ in range(slots)]
        self.stream = torch.cuda.Stream(dev)
        self.slots = slots

    def _stage(self, t: int, sel: np.ndarray) -> None:
        """Gather batch ``t`` into its slot's staging buffer and start its
        copy to the slot's device buffer on the side stream."""
        s, n = t % self.slots, len(sel)
        # The slot's last consumer (batch t - slots) has finished with it.
        self.consumed[s].synchronize()
        for a, host in zip(self.arrays, self.host):
            np.take(a, sel, axis=0, out=host[s][:n].numpy())
        with torch.cuda.stream(self.stream):
            for host, dev in zip(self.host, self.dev):
                dev[s][:n].copy_(host[s][:n], non_blocking=True)
            self.copied[s].record(self.stream)

    def run(self, sels: List[np.ndarray]) -> Iterator:
        # A previous epoch's copies have landed, and its consumer's work
        # (a batch it left unfinished included) precedes this epoch's copies.
        self.stream.synchronize()
        self.stream.wait_stream(torch.cuda.current_stream(self.loader.device))
        ahead = self.loader.prefetch
        for t in range(min(ahead, len(sels))):
            self._stage(t, sels[t])
        for t, sel in enumerate(sels):
            if t + ahead < len(sels):
                self._stage(t + ahead, sels[t + ahead])
            s, n = t % self.slots, len(sel)
            consumer = torch.cuda.current_stream(self.loader.device)
            consumer.wait_event(self.copied[s])
            out = [dev[s][:n] for dev in self.dev]
            yield out[0] if len(out) == 1 else tuple(out)
            # The consumer's work on the batch is enqueued by now.
            self.consumed[s].record(torch.cuda.current_stream(self.loader.device))
