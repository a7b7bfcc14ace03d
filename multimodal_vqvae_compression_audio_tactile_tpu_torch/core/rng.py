"""Seeded random generators.

The JAX package threads explicit keys, folding well-known integers into a
root key from ``DEFAULT_SEED`` (its ``core/rng.py``). Here a key is an
integer seed: ``fold(seed, *tags)`` mixes the tags into it (splitmix64
steps), and ``generator(seed, *tags, device=...)`` is a ``torch.Generator``
seeded with the folded value on an explicit device, so a CUDA draw comes
from a CUDA generator. The same seed and tags give the same draws on one
device type; they are not the JAX package's threefry bits, and no test holds
them to be.

``BatchShard`` is a generator's draws over a batch axis on one rank of a
data-parallel mesh (``parallel/mesh.py``): ``rand`` and ``randint`` draw the
global batch's tensor from the shared generator and keep this rank's rows,
so a sharded step draws what the step over the whole batch draws.
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


class BatchShard:
    """``gen``'s draws over a leading batch axis split into ``count`` equal
    shards, of which this rank holds shard ``index``."""

    def __init__(self, gen: torch.Generator, index: int, count: int):
        self.gen, self.index, self.count = gen, index, count

    @property
    def device(self) -> torch.device:
        return self.gen.device


def _draw(fn, shape, gen, device):
    if isinstance(gen, BatchShard):
        b = shape[0]
        full = fn((b * gen.count, *shape[1:]), gen.gen, device)
        return full[gen.index * b:(gen.index + 1) * b]
    return fn(tuple(shape), gen, device)


def rand(shape, gen, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen`` (a generator or a ``BatchShard``,
    whose draw is the global batch's, this shard's rows kept)."""
    return _draw(lambda s, g, d: torch.rand(s, generator=g, device=d), shape, gen, device)


def randint(low: int, high: int, shape, gen, device=None) -> torch.Tensor:
    """``torch.randint(low, high, shape)`` from ``gen``, as ``rand``."""
    return _draw(lambda s, g, d: torch.randint(low, high, s, generator=g, device=d), shape,
                 gen, device)
