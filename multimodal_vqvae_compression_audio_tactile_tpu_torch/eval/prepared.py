"""Pair preparation and batching shared by the codec evaluators.

Port of the JAX package's ``eval/prepared.py``, on the host:

- ``prepare_pairs``: one pass over the corpus: load, the per-file tactile
  scale (max |t|, the raw protocol's transmitter-side normalisation),
  resampling to the model's rate and a crop to the common length. Every run,
  depth and protocol of an evaluation session reuses the result.
- ``equal_length_batches``: groups the prepared pairs by length, so that
  the model's forwards run batched (one call per ``batch`` files).

The metrics are unchanged: callers run the same per-file alignment, PSNR and
ST-SIM on the batched outputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..dsp.resample import resample
from ..utils.wav_io import load_wav_mono


@dataclass
class PreparedPair:
    stem: str
    a24: np.ndarray      # [1, L] audio / scale at the model's rate
    t24: np.ndarray      # [1, L] tactile / scale at the model's rate
    t_raw: np.ndarray    # [1, T_orig] raw tactile at its own rate
    scale: float         # max |t_raw| (the raw protocol's per-file scale)
    sr_t: int


def prepare_pairs(pairs: Sequence, sr_model: int, log=None) -> List[PreparedPair]:
    out: List[PreparedPair] = []
    for i, (a_path, t_path, stem) in enumerate(pairs):
        a_raw, sr_a = load_wav_mono(a_path)
        t_raw, sr_t = load_wav_mono(t_path)
        scale = max(float(np.abs(t_raw).max()), 1e-8)
        a24 = np.asarray(resample(a_raw / scale, sr_a, sr_model))
        t24 = np.asarray(resample(t_raw / scale, sr_t, sr_model))
        L = min(a24.shape[-1], t24.shape[-1])
        out.append(PreparedPair(stem, a24[..., :L].astype(np.float32),
                                t24[..., :L].astype(np.float32),
                                t_raw.astype(np.float32), scale, int(sr_t)))
        if log is not None and (i + 1) % 200 == 0:
            log(f"  [prepare] {i + 1}/{len(pairs)}")
    return out


def equal_length_batches(prepared: Sequence[PreparedPair], batch: int
                         ) -> Iterator[Tuple[List[int], np.ndarray, np.ndarray]]:
    """Yield (indices, A [b, 1, L], T [b, 1, L]) groups of equal-length pairs."""
    by_len: dict = {}
    for i, p in enumerate(prepared):
        by_len.setdefault(p.a24.shape[-1], []).append(i)
    for _, idxs in sorted(by_len.items()):
        for s in range(0, len(idxs), batch):
            chunk = idxs[s: s + batch]
            A = np.stack([prepared[i].a24 for i in chunk])
            T = np.stack([prepared[i].t24 for i in chunk])
            yield chunk, A, T
