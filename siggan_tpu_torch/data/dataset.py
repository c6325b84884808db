"""Host-side dataset: glob -> decode -> one resident [-1, 1] array.

Port of the JAX package's ``data/dataset.py``. The whole set is decoded
once into a contiguous float32 (N, s, s, 1) array, which the trainer moves
to the card; a ``.npy`` cache beside the data directory makes re-runs
decode-free. PNGs are decoded by the port's own ``infer/export.decode_png``
(no imaging package): grayscale as stored, RGB/RGBA converted with the ITU-R
601 luma weights PIL's ``convert("L")`` uses. Images of another size are
resized with PyTorch's antialiased bilinear filter, close to (not bit-equal
with) PIL's. A file that fails to decode becomes a zero image with a
warning, as in the reference. Only PNG files are read: a directory that
also holds the reference's other image files (.jpg, .jpeg, .bmp, .tiff,
.tif) is refused, rather than trained on its PNG subset, until their
decoders are ported (ROADMAP A.6).
"""

from __future__ import annotations

import hashlib
import logging
import struct
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from siggan_tpu_torch.infer.export import decode_png

logger = logging.getLogger(__name__)

IMAGE_EXTENSIONS = {".png"}
# The reference's other image extensions (its data/dataset.py), not decoded yet.
UNDECODED_EXTENSIONS = {".jpg", ".jpeg", ".bmp", ".tiff", ".tif"}


def list_images(data_dir: str | Path, recursive: bool = True) -> List[Path]:
    root = Path(data_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"data_dir does not exist: {root}")
    files = list(root.rglob("*") if recursive else root.glob("*"))
    other = sorted(p for p in files if p.suffix.lower() in UNDECODED_EXTENSIONS)
    if other:
        raise NotImplementedError(
            f"{root} holds {len(other)} image files the port cannot decode yet "
            f"({other[0].name}, ...): only PNG is read until the other formats' "
            f"decoders are ported (ROADMAP A.6)")
    return sorted(p for p in files if p.suffix.lower() in IMAGE_EXTENSIONS)


def _to_gray(u8: np.ndarray) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (H, W), PIL's L = (19595 R + 38470 G + 7471 B
    + 2^15) >> 16; alpha is dropped, as PIL does."""
    if u8.shape[-1] == 1:
        return u8[..., 0]
    rgb = u8[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def decode_image(path: Path, image_size: int) -> np.ndarray:
    """Grayscale decode (+ resize to (s, s)), scaled to [-1, 1], (s, s, 1)."""
    try:
        arr = _to_gray(decode_png(Path(path).read_bytes())).astype(np.float32)
    except (OSError, ValueError, struct.error, zlib.error) as e:   # zero-image fallback (reference)
        logger.warning("failed to decode %s (%s); using zero image", path, e)
        return np.zeros((image_size, image_size, 1), np.float32)
    if arr.shape != (image_size, image_size):
        t = torch.from_numpy(arr)[None, None]
        t = F.interpolate(t, size=(image_size, image_size), mode="bilinear",
                          align_corners=False, antialias=True)
        arr = t[0, 0].round().clamp(0, 255).numpy()
    return (arr / 255.0 * 2.0 - 1.0)[:, :, None]


class SignatureDataset:
    """All images resident as one (N, s, s, 1) float32 array in [-1, 1]."""

    def __init__(self, data_dir: str | Path, image_size: int = 64,
                 use_cache: bool = True, max_images: Optional[int] = None):
        self.data_dir = Path(data_dir)
        self.image_size = image_size
        self.paths = list_images(data_dir)
        if max_images is not None:
            self.paths = self.paths[:max_images]
        if not self.paths:
            raise ValueError(f"no PNG images found under {data_dir}")
        self.images = self._load(use_cache)

    def _cache_path(self) -> Path:
        sig = hashlib.sha1(
            ("|".join(f"{p.name}:{p.stat().st_size}" for p in self.paths)
             + f"@{self.image_size}").encode()).hexdigest()[:16]
        return self.data_dir / f".siggan_cache_{self.image_size}_{sig}.npy"

    def _load(self, use_cache: bool) -> np.ndarray:
        cache = self._cache_path()
        if use_cache and cache.exists():
            arr = np.load(cache)
            if arr.shape[0] == len(self.paths):
                return arr
        arr = np.stack([decode_image(p, self.image_size) for p in self.paths])
        if use_cache:
            try:
                np.save(cache, arr)
            except OSError as e:
                logger.warning("could not write dataset cache: %s", e)
        return arr

    def __len__(self) -> int:
        return len(self.paths)

    def statistics(self) -> dict:
        x = self.images
        return {"num_images": len(self), "image_size": self.image_size,
                "mean": float(x.mean()), "std": float(x.std()),
                "min": float(x.min()), "max": float(x.max())}

