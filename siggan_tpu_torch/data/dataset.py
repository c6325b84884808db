"""Host-side dataset: glob -> decode -> one resident [-1, 1] array.

Port of the JAX package's ``data/dataset.py``. The whole set is decoded
once into a contiguous float32 (N, s, s, 1) array, which the trainer moves
to the card; a ``.npy`` cache beside the data directory makes re-runs
decode-free (its name carries the decoder's version,
``data/native/loader.py::DECODE_VERSION``, and is not the JAX package's
cache name). The files are those the JAX package reads (.png, .jpg, .jpeg,
.bmp, .tiff, .tif), each decoded by its content, not its name, with no
imaging package: PNG (and an ICO file's PNG icon) by
``infer/export.decode_png``, JPEG, BMP, TIFF, GIF, Netpbm, WebP, DIB, ICO,
CUR, TGA, PCX, DCX, SGI, SUN, MSP, QOI, IM, XBM, XPM, XV thumbnail and PSD
by the port's C++ decoder
(``data/native/``), the whole set on several threads; each gives PIL's
``convert("L")`` grey bit for bit. Images of
another size are resized by the same C++ library
(``data/native/loader.py::resize_bilinear``), bit-equal with the PIL
``resize(..., Image.BILINEAR)`` that the JAX package calls and with
``data/resample.py``'s numpy version. A corrupt or unreadable file, and
one of a kind PIL itself refuses, becomes a zero image with a warning, as
in the reference; a file PIL reads, of a kind the port does not read yet,
raises ``NotImplementedError`` (ROADMAP A.6). ``writer_labels`` labels the images
by their per-writer subdirectory, for conditional training.
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from siggan_tpu_torch.data.native import loader as native
from siggan_tpu_torch.infer.export import decode_png

logger = logging.getLogger(__name__)

# The JAX package's extensions (its data/dataset.py).
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".tif"}
# What a corrupt or unreadable file raises (a zero image in the dataset).
DECODE_ERRORS = (OSError, ValueError, struct.error, zlib.error)


def list_images(data_dir: str | Path, recursive: bool = True) -> List[Path]:
    root = Path(data_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"data_dir does not exist: {root}")
    it = root.rglob("*") if recursive else root.glob("*")
    return sorted(p for p in it if p.suffix.lower() in IMAGE_EXTENSIONS)


def _to_gray(u8: np.ndarray) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (H, W), PIL's L = (19595 R + 38470 G + 7471 B
    + 2^15) >> 16; alpha is dropped, as PIL does."""
    if u8.shape[-1] <= 2:
        return u8[..., 0]
    rgb = u8[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def read_gray(path: str | Path) -> Tuple[np.ndarray, bool]:
    """``decode_gray``'s grey, and whether PIL resizes it nearest (its
    ``convert("L")`` left the image in mode P: a grey TGA with a colour
    map)."""
    data = Path(path).read_bytes()
    got = native.decode_or_png(data, str(path))
    if got.gray is None:
        return _to_gray(decode_png(data[got.png_at:])), False
    return got.gray, got.nearest


def decode_gray(path: str | Path) -> np.ndarray:
    """An image file as uint8 (H, W) grey, PIL's ``convert("L")``; the
    format comes from the file's bytes, as PIL's ``Image.open`` finds it.
    Raises ``NotImplementedError`` naming the format for a file PIL reads,
    of a kind not read yet (a PGM, an ICO or an XBM saved as ``.png``
    reads; an AVIF saved as ``.png`` raises naming AVIF and ROADMAP A.6), ``ValueError
    (or ``OSError``) for a corrupt (or unreadable) one or one PIL refuses.
    A PNG stream (a PNG file, an ICO file's PNG icon) goes to
    ``decode_png``."""
    return read_gray(path)[0]


def resize(gray: np.ndarray, width: int, height: int, nearest: bool = False) -> np.ndarray:
    """PIL's ``resize(..., Image.BILINEAR)`` of a grey, which PIL does
    nearest for an image of mode P (``read_gray``)."""
    return (native.resize_nearest if nearest else native.resize_bilinear)(gray, width, height)


def _scaled(gray: np.ndarray, image_size: int, nearest: bool = False) -> np.ndarray:
    """uint8 grey (+ resize to (s, s)) -> [-1, 1] float32 (s, s, 1)."""
    if gray.shape != (image_size, image_size):
        gray = resize(gray, image_size, image_size, nearest)
    return (gray.astype(np.float32) / 255.0 * 2.0 - 1.0)[:, :, None]


def _zero_image(path, image_size: int, err: Exception) -> np.ndarray:
    logger.warning("failed to decode %s (%s); using zero image", path, err)
    return np.zeros((image_size, image_size, 1), np.float32)


def decode_image(path: Path, image_size: int) -> np.ndarray:
    """Grayscale decode (+ resize to (s, s)), scaled to [-1, 1], (s, s, 1).
    A corrupt or unreadable file, or one PIL refuses, gives a zero image
    and a warning (the reference's fallback); ``NotImplementedError`` (a
    kind PIL reads and the port not yet) passes through."""
    try:
        gray, nearest = read_gray(path)
    except DECODE_ERRORS as e:
        return _zero_image(path, image_size, e)
    return _scaled(gray, image_size, nearest)


# The Python pool pays once the files it decodes or resizes average about
# this many pixels. Between the two sizes measured on the card's host
# (``chip_smoke.py`` phase 12, PERF.md PR 11): 210 x 80 PNGs (16,800 px) went
# faster on 1 thread than on 8, 1200 x 500 pages (600,000 px) 2.4-3.2 times
# faster on 8; where between them the two cross is not measured.
POOL_MIN_PIXELS = 1 << 17


def _png_pixels(path: Path, at: int = 0) -> int:
    """Width x height from the IHDR of the PNG stream at ``at`` (0 if the
    header is cut short)."""
    with open(path, "rb") as f:
        f.seek(at)
        head = f.read(24)
    return int.from_bytes(head[16:20], "big") * int.from_bytes(head[20:24], "big")


def pool_threads(paths: List[Path], grays, status, png_at, threads: int) -> int:
    """The Python pool's size for ``decode_images``: ``threads`` when the
    files it decodes (PNG streams, at ``png_at``) or resizes (the rest)
    average ``POOL_MIN_PIXELS`` or more, else 1 (on small files the
    interpreter lock's hand-offs cost more than the work that runs without
    it); the greys, statuses and offsets are ``native.decode_files``'."""
    px = [_png_pixels(p, int(png_at[i])) if s == native.PNG else grays[i].size
          for i, (p, s) in enumerate(zip(paths, status)) if s in (native.PNG, native.OK, native.INDICES)]
    return threads if px and sum(px) >= POOL_MIN_PIXELS * len(px) else 1


def decode_images(paths: List[Path], image_size: int,
                  n_threads: Optional[int] = None) -> np.ndarray:
    """``decode_image`` of every path -> (N, s, s, 1) float32: every file
    but PNG streams in the C++ decoder's own threads (up to 8, one per
    core); then PNG streams (PNG files and ICO files' PNG icons: zlib and
    the C++ row unfilter, both of which release the interpreter lock) and
    every resize (C++, which releases it too) on a pool of Python threads,
    as many as ``pool_threads`` gives. ``n_threads`` fixes both counts."""
    threads = n_threads or min(8, os.cpu_count() or 1)
    grays, status, msgs, png_at = native.decode_files(paths, threads)
    pool_size = n_threads or pool_threads(paths, grays, status, png_at, threads)

    def one(i: int) -> np.ndarray:
        p = paths[i]
        if status[i] == native.PNG:
            try:
                return _scaled(_to_gray(decode_png(p.read_bytes()[png_at[i]:])), image_size)
            except DECODE_ERRORS as e:
                return _zero_image(p, image_size, e)
        if status[i] in (native.OK, native.INDICES):
            return _scaled(grays[i], image_size, status[i] == native.INDICES)
        err = native.error(int(status[i]), msgs[i], str(p))
        if isinstance(err, NotImplementedError):
            raise err
        return _zero_image(p, image_size, err)

    out = np.empty((len(paths), image_size, image_size, 1), np.float32)
    with ThreadPoolExecutor(pool_size) as pool:
        for i, img in enumerate(pool.map(one, range(len(paths)))):
            out[i] = img
    return out


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
            raise ValueError(f"no images found under {data_dir}")
        self.images = self._load(use_cache)

    def writer_labels(self):
        """(labels (N,) int32, writer names) from the per-writer
        subdirectories of ``data_dir`` (sorted names, label = index), the
        data of conditional (v2.0) training; raises if images sit directly
        in ``data_dir``."""
        names = sorted({p.parent.name for p in self.paths if p.parent != self.data_dir})
        direct = [p for p in self.paths if p.parent == self.data_dir]
        if direct or not names:
            raise ValueError("conditional training expects per-writer subdirectories "
                             f"under {self.data_dir}")
        index = {n: i for i, n in enumerate(names)}
        return np.asarray([index[p.parent.name] for p in self.paths], np.int32), names

    def _cache_path(self) -> Path:
        """The port's own cache file: its name carries ``DECODE_VERSION``,
        so neither the JAX package's cache (``.siggan_cache_*``: its native
        decoder may be 1-2 grey levels off PIL) nor one an older decoder of
        the port wrote is read."""
        sig = hashlib.sha1(
            ("|".join(f"{p.name}:{p.stat().st_size}" for p in self.paths)
             + f"@{self.image_size}").encode()).hexdigest()[:16]
        return self.data_dir / (f".siggan_torch_cache_{self.image_size}_"
                                f"{native.DECODE_VERSION}_{sig}.npy")

    def _load(self, use_cache: bool) -> np.ndarray:
        cache = self._cache_path()
        if use_cache and cache.exists():
            arr = np.load(cache)
            if arr.shape[0] == len(self.paths):
                return arr
        arr = decode_images(self.paths, self.image_size)
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


def train_val_split(ds: SignatureDataset, val_fraction: float = 0.1,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(train, val) images: a shuffled split by numpy's ``RandomState(seed)``
    permutation, the JAX package's ``train_val_split`` index for index."""
    n = len(ds)
    idx = np.random.RandomState(seed).permutation(n)
    n_val = int(n * val_fraction)
    return ds.images[idx[n_val:]], ds.images[idx[:n_val]]
