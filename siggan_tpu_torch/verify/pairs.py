"""Signature pair construction for verifier training and evaluation.

Port of the JAX package's ``verify/pairs.py`` with the same rules and the
same random streams, so a seed gives the same pair lists and splits in
both packages:
 - per-user subdirectories, or flat files grouped by filename prefix
   ("user001_sig1.png" -> user "user001"); users need >= 2 signatures;
 - genuine pairs (label 1) sampled within a user, impostor pairs (label 0)
   across users, ``pairs_per_user`` each, from ``random.Random(seed)``;
 - an optional synthetic directory joins as the extra ``_synthetic_`` user,
   used as negatives but never paired with itself;
 - the train/val split is ``np.random.RandomState(seed).permutation``.

The JAX package's image files are read (``data/dataset.py::decode_image``:
PNG, JPEG, BMP and TIFF by content, PIL's grey and resize bit for bit).
Decoded pairs are materialized as arrays, which training moves to the
device once.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from siggan_tpu_torch.data.dataset import IMAGE_EXTENSIONS, decode_images

SYNTHETIC_USER = "_synthetic_"


def _images(files) -> List[Path]:
    return sorted(f for f in files if f.suffix.lower() in IMAGE_EXTENSIONS)


def load_user_signatures(data_dir: str | Path,
                         synthetic_dir: Optional[str | Path] = None
                         ) -> Dict[str, List[Path]]:
    data_dir = Path(data_dir)
    users: Dict[str, List[Path]] = {}
    subdirs = sorted(d for d in data_dir.iterdir() if d.is_dir())
    if subdirs:
        for user_dir in subdirs:
            imgs = _images(user_dir.iterdir())
            if len(imgs) >= 2:
                users[user_dir.name] = imgs
    else:
        for f in _images(data_dir.iterdir()):
            user_id = f.stem.split("_")[0] or f.stem
            users.setdefault(user_id, []).append(f)
        users = {k: v for k, v in users.items() if len(v) >= 2}
    if synthetic_dir is not None:
        sdir = Path(synthetic_dir)
        if sdir.exists():
            imgs = _images(sdir.iterdir())
            if imgs:
                users[SYNTHETIC_USER] = imgs
    return users


def generate_pairs(users: Dict[str, List[Path]], pairs_per_user: int = 10,
                   seed: int = 0) -> List[Tuple[Path, Path, int]]:
    rng = random.Random(seed)
    pairs: List[Tuple[Path, Path, int]] = []
    user_ids = list(users.keys())
    for user_id in user_ids:
        if user_id == SYNTHETIC_USER:
            continue  # synthetic images appear only as negatives
        sigs = users[user_id]
        for _ in range(pairs_per_user):
            if len(sigs) >= 2:
                a, b = rng.sample(sigs, 2)
                pairs.append((a, b, 1))
        others = [u for u in user_ids if u != user_id]
        for _ in range(pairs_per_user):
            if others:
                other = rng.choice(others)
                pairs.append((rng.choice(sigs), rng.choice(users[other]), 0))
    rng.shuffle(pairs)
    return pairs


class PairDataset:
    """Materialized pair arrays: img1/img2 (N, s, s, 1) in [-1, 1], labels (N,)."""

    def __init__(self, data_dir: str | Path,
                 synthetic_dir: Optional[str | Path] = None,
                 pairs_per_user: int = 10, image_size: int = 64,
                 seed: int = 0):
        self.users = load_user_signatures(data_dir, synthetic_dir)
        if not self.users:
            raise ValueError(f"no users with >=2 signatures under {data_dir}")
        self.pairs = generate_pairs(self.users, pairs_per_user, seed)
        uniq = list(dict.fromkeys(p for a, b, _ in self.pairs for p in (a, b)))
        img = dict(zip(uniq, decode_images(uniq, image_size)))
        self.img1 = np.stack([img[a] for a, _, _ in self.pairs])
        self.img2 = np.stack([img[b] for _, b, _ in self.pairs])
        self.labels = np.asarray([l for _, _, l in self.pairs], np.float32)

    def __len__(self) -> int:
        return len(self.pairs)

    def split(self, val_fraction: float = 0.2, seed: int = 0):
        """Deterministic train/val split of the pair arrays (80/20 by default)."""
        n = len(self)
        idx = np.random.RandomState(seed).permutation(n)
        n_val = int(n * val_fraction)
        va, tr = idx[:n_val], idx[n_val:]
        return ((self.img1[tr], self.img2[tr], self.labels[tr]),
                (self.img1[va], self.img2[va], self.labels[va]))

    def summary(self) -> Dict[str, int]:
        return {
            "users": len(self.users),
            "pairs": len(self.pairs),
            "genuine": int(self.labels.sum()),
            "impostor": int((1 - self.labels).sum()),
        }
