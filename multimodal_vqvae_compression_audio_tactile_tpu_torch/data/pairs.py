"""Audio/tactile file pairing and train/val splitting.

Reference: Training/compare_dacvsproposal_3.py:90, :115-118 (stem-matched WAV pairs),
:354-360 (shuffled split with VAL_FRAC=0.2 capped at MAX_VAL=300).
"""

from __future__ import annotations

import glob
import os
import random
from pathlib import Path
from typing import List, Tuple

Pair = Tuple[str, str, str]  # (audio_path, tactile_path, stem)


def list_wavs(dirpath: str) -> dict:
    return {Path(p).stem: p for p in glob.glob(os.path.join(dirpath, "*.wav"))}


def pair_stems(audio_dir: str, tact_dir: str) -> List[Pair]:
    A, T = list_wavs(audio_dir), list_wavs(tact_dir)
    stems = sorted(set(A) & set(T))
    return [(A[s], T[s], s) for s in stems]


def split_items(
    items: List[Pair],
    val_frac: float = 0.2,
    max_val: int = 300,
    seed: int = 7,
) -> Tuple[List[Pair], List[Pair]]:
    """Shuffled split; first val_frac (capped) go to validation
    (reference: Training/compare_dacvsproposal_3.py:354-360)."""
    items = list(items)
    random.Random(seed).shuffle(items)
    n_val = max(1, int(len(items) * val_frac))
    val_items = items[:n_val][:max_val]
    train_items = items[n_val:]
    return train_items, val_items
