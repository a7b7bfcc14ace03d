"""Seeded random generators.

The JAX package threads explicit keys, folding well-known integers into a
root key from ``DEFAULT_SEED`` (its ``core/rng.py``). Here a key is an
integer seed: ``fold(seed, *tags)`` mixes the tags into it (splitmix64
steps), and ``generator(seed, *tags, device=...)`` is a ``torch.Generator``
seeded with the folded value on an explicit device, so a CUDA draw comes
from a CUDA generator. The same seed and tags give the same draws on one
device type; they are not the JAX package's threefry bits, and no test holds
them to be.
"""

from __future__ import annotations

import torch

DEFAULT_SEED = 7

_MASK = (1 << 64) - 1


def _mix(v: int) -> int:
    """One splitmix64 step."""
    v = (v + 0x9E3779B97F4A7C15) & _MASK
    v = ((v ^ (v >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    v = ((v ^ (v >> 27)) * 0x94D049BB133111EB) & _MASK
    return v ^ (v >> 31)


def fold(seed: int, *tags: int) -> int:
    """The seed with each tag folded in, in order: a non-negative int < 2^63."""
    v = _mix(seed & _MASK)
    for t in tags:
        v = _mix(v ^ (t & _MASK))
    return v >> 1


def generator(seed: int = DEFAULT_SEED, *tags: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``fold(seed, *tags)``."""
    g = torch.Generator(device=device)
    g.manual_seed(fold(seed, *tags))
    return g
