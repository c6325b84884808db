"""Seeded ``torch.Generator``s derived from (seed, stream tag, counter).

The stream tags are the JAX package's. JAX's threefry bits cannot be
reproduced in PyTorch, so a seed gives other numbers here than there; within
the port every draw is a pure function of (seed, tag, counter).
``generator`` makes a CPU generator, so that the same seed gives the same
latents and initial weights whichever device then runs the model;
``reseed`` re-keys an existing generator of any device, which is how the
train step draws on the card per (stream, step) without a host round trip.
"""

from __future__ import annotations

import torch

STREAM_INIT_G = 0x47454E          # generator init
STREAM_INIT_D = 0x444953          # discriminator init
STREAM_NOISE = 0x4E4F49           # latent noise per step
STREAM_DROPOUT = 0x44524F         # discriminator dropout per step
STREAM_AUGMENT = 0x415547         # data augmentation per step
STREAM_FIXED = 0x464958           # fixed evaluation noise
STREAM_EVAL = 0x4556414C          # evaluation sampling
STREAM_DATA = 0x44415441          # per-epoch shuffle of the resident dataset
STREAM_INIT_VERIFIER = 0x564552   # signature verifier init
STREAM_DROPOUT_VERIFIER = 0x564450  # signature verifier dropout

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def derive_seed(seed: int, *path: int) -> int:
    """Mix ``seed`` and each element of ``path`` into a 63-bit seed."""
    h = _splitmix64(int(seed) & _MASK64)
    for p in path:
        h = _splitmix64(h ^ (int(p) & _MASK64))
    return h & ((1 << 63) - 1)


def reseed(gen: torch.Generator, seed: int, tag: int, *counters: int) -> torch.Generator:
    """Re-key ``gen`` (any device) to stream ``tag`` at ``counters``."""
    gen.manual_seed(derive_seed(seed, tag, *counters))
    return gen


def generator(seed: int, tag: int, *counters: int) -> torch.Generator:
    """A CPU ``torch.Generator`` for stream ``tag`` at ``counters``."""
    return reseed(torch.Generator(device="cpu"), seed, tag, *counters)
