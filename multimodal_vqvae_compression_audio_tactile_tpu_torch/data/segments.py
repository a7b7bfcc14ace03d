"""Segment dataset: paired crops of ``seg`` samples at the training rate.

The JAX package's ``data/segments.py``: load both WAVs, resample to the
target rate (the port's ``dsp/resample.py``, on the CPU; results cached per
file), keep channel 0, sanitize NaN/Inf, crop to the common length,
reflect-pad short files to the segment length, take a crop whose start is
drawn from ``random.Random(f"{seed}:{index}:{epoch}")``.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np

from ..dsp.resample import resample
from ..utils.wav_io import load_wav_mono
from .pairs import Pair


def sanitize_wave_np(x: np.ndarray, clamp: bool = True) -> np.ndarray:
    x = np.nan_to_num(x, nan=0.0, posinf=0.9999, neginf=-0.9999)
    return np.clip(x, -1.0, 1.0) if clamp else x


def reflect_pad_right(x: np.ndarray, need: int) -> np.ndarray:
    """Iterated reflect pad for very short signals (edge pad at one sample)."""
    while need > 0:
        T = x.shape[-1]
        if T <= 1:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, need)], mode="edge")
            break
        step = min(need, T - 1)
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, step)], mode="reflect")
        need -= step
    return x


class SegmentDataset:
    """Map-style dataset yielding (audio[seg], tactile[seg]) float32 pairs."""

    def __init__(self, items: List[Pair], sr: int = 24000, seg: int = 24000,
                 seed: int = 7, cache: bool = True):
        self.items = items
        self.sr = sr
        self.seg = seg
        self.seed = seed
        self.epoch = 0
        self._cache: Optional[dict] = {} if cache else None

    def set_epoch(self, epoch: int) -> None:
        """Crops are deterministic per (seed, index, epoch)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.items)

    def _prep(self, path: str) -> np.ndarray:
        if self._cache is not None and path in self._cache:
            return self._cache[path]
        w, sr_in = load_wav_mono(path)          # [1, T]
        if sr_in != self.sr:
            w = resample(w, sr_in, self.sr).numpy()
        w = sanitize_wave_np(w)
        if self._cache is not None:
            self._cache[path] = w
        return w

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        ap, tp, _ = self.items[i]
        a, t = self._prep(ap), self._prep(tp)
        L = min(a.shape[-1], t.shape[-1])
        a, t = a[..., :L], t[..., :L]
        if a.shape[-1] < self.seg:
            a = reflect_pad_right(a, self.seg - a.shape[-1])
        if t.shape[-1] < self.seg:
            t = reflect_pad_right(t, self.seg - t.shape[-1])
        if a.shape[-1] > self.seg:
            rng = random.Random(f"{self.seed}:{i}:{self.epoch}")
            st = rng.randint(0, a.shape[-1] - self.seg)
        else:
            st = 0
        return a[0, st: st + self.seg], t[0, st: st + self.seg]
