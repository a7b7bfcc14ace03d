"""MATLAB corpus extraction: .mat recordings -> WAV files.

A copy of the JAX package's ``data/mat_extract.py`` (which imports no JAX,
but whose package does), writing through the port's ``utils/wav_io.py``, so
both write the same bytes. scipy reads the files; h5py, for v7.3 (HDF5)
files, and matplotlib, for the raw variants' plots, are imported only where
they are needed (where matplotlib is missing, the raw variants write their
WAV and JSON, and ``extract_corpus`` says in one line that the plots are not
drawn). Covers the reference's four extractor scripts
(reference: Dataset/Dataset_creation/):

- ``Dataset_creation_audio.py`` — walks a ``CBM_FinalDatabase`` tree, extracts
  ``finalMaterialRecording.sound``, peak-normalizes to [-1, 1], writes 44.1 kHz
  PCM_16 WAV (:25-26, :31-37, :208-237).
- ``Dataset_creation_tactile.py`` — same, extracting
  ``finalMaterialRecording.accelDFT`` (accelerometer) at 3 kHz (:26, :138-198).
- ``Dataset_creation_audio_raw.py`` / ``Dataset_creation_tactile_raw.py`` —
  NO normalization, 32-bit-float WAV, plus a per-file PNG plot and JSON stats
  (min/max/mean/std) (:160-244).

Handles both scipy-loadable MAT files and v7.3 HDF5 MATs (h5py), with the
reference's unwrap heuristics for MATLAB struct access and mono downmixing.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from ..utils.artifacts import have_matplotlib, not_drawn
from ..utils.wav_io import write_wav

AUDIO_SR = 44100   # reference: Dataset_creation_audio.py:25
TACTILE_SR = 3000  # reference: Dataset_creation_tactile.py:26


def normalize_audio(x: np.ndarray) -> np.ndarray:
    """Peak-normalize to [-1, 1]; zero-safe
    (reference: Dataset_creation_audio.py:31-37)."""
    x = np.asarray(x, dtype=np.float32)
    max_val = float(np.max(np.abs(x))) if x.size else 0.0
    return x / max_val if max_val > 0 else x


def ensure_1d_mono(x: np.ndarray) -> np.ndarray:
    """Downmix 2-D signals to mono with the reference's channel heuristic
    (reference: Dataset_creation_audio.py:86-108)."""
    x = np.asarray(x)
    if x.ndim == 0:
        x = x.reshape(1)
    elif x.ndim == 2:
        if x.shape[0] == 1 or x.shape[1] == 1:
            x = x.reshape(-1)
        elif x.shape[0] <= 8:
            x = x.mean(axis=0)
        elif x.shape[1] <= 8:
            x = x.mean(axis=1)
        else:
            x = x.mean(axis=-1)
    return x.astype(np.float32).ravel()


def load_mat_safely(path: str):
    """scipy first, h5py for v7.3 HDF5 MATs
    (reference: Dataset_creation_audio.py:112-135)."""
    try:
        from scipy.io import loadmat
        return loadmat(path, squeeze_me=True, struct_as_record=False), "scipy"
    except NotImplementedError:
        import h5py
        return h5py.File(path, "r"), "h5py"


def _get_field(obj, field: str) -> Optional[np.ndarray]:
    if hasattr(obj, field):
        return np.asarray(getattr(obj, field))
    try:
        return np.asarray(obj[field])
    except Exception:
        pass
    try:
        inner = obj[()]
        if hasattr(inner, field):
            return np.asarray(getattr(inner, field))
        return np.asarray(inner[field])
    except Exception:
        return None


def extract_signal(mat_obj, backend: str, field: str) -> Optional[np.ndarray]:
    """Extract ``finalMaterialRecording.<field>`` with the reference's fallbacks."""
    if backend == "scipy":
        fmr = mat_obj.get("finalMaterialRecording")
        if fmr is not None:
            sig = _get_field(fmr, field)
            if sig is not None:
                return sig
        # fallback: any numeric entry whose key contains the field name
        for k, v in mat_obj.items():
            if not k.startswith("__") and field.lower() in k.lower():
                arr = np.asarray(v)
                if np.issubdtype(arr.dtype, np.number):
                    return arr
        return None
    # h5py backend
    for key in (f"finalMaterialRecording/{field}", field):
        if key in mat_obj:
            return np.asarray(mat_obj[key])
    return None


def _stats(x: np.ndarray) -> dict:
    return {
        "min": float(x.min()) if x.size else 0.0,
        "max": float(x.max()) if x.size else 0.0,
        "mean": float(x.mean()) if x.size else 0.0,
        "std": float(x.std()) if x.size else 0.0,
        "num_samples": int(x.size),
    }


def _save_plot(x: np.ndarray, sr: int, path: str, title: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(x.size) / float(sr)
    plt.figure(figsize=(10, 3))
    plt.plot(t, x, linewidth=0.6)
    plt.xlabel("Time (s)")
    plt.ylabel("Amplitude")
    plt.title(title)
    plt.tight_layout()
    plt.savefig(path, dpi=120)
    plt.close()


def process_mat_file(
    mat_path: str,
    out_dir: str,
    field: str,
    sr: int,
    normalize: bool = True,
    raw_artifacts: bool = False,
) -> Optional[str]:
    """One .mat -> WAV (+ optional PNG/JSON for the raw variants)."""
    loaded, backend = load_mat_safely(mat_path)
    if loaded is None:
        return None
    try:
        sig = extract_signal(loaded, backend, field)
    finally:
        if backend == "h5py":
            loaded.close()
    if sig is None or np.asarray(sig).size == 0:
        return None
    x = ensure_1d_mono(sig)
    x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)

    stem = Path(mat_path).stem
    os.makedirs(out_dir, exist_ok=True)
    out_wav = os.path.join(out_dir, stem + ".wav")
    if normalize:
        write_wav(out_wav, normalize_audio(x), sr, subtype="PCM_16")
    else:
        write_wav(out_wav, x, sr, subtype="FLOAT")
    if raw_artifacts:
        if have_matplotlib():
            _save_plot(x, sr, os.path.join(out_dir, stem + ".png"), stem)
        with open(os.path.join(out_dir, stem + ".json"), "w") as f:
            json.dump(_stats(x), f, indent=2)
    return out_wav


def walk_mats(root: str) -> Iterable[str]:
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if fn.lower().endswith(".mat"):
                yield os.path.join(dirpath, fn)


def extract_corpus(
    root: str,
    out_dir: str,
    kind: str,
    sr: Optional[int] = None,
    log=print,
) -> int:
    """Extract a whole tree. kind: audio | tactile | audio_raw | tactile_raw."""
    field = "sound" if kind.startswith("audio") else "accelDFT"
    default_sr = AUDIO_SR if kind.startswith("audio") else TACTILE_SR
    sr = sr or default_sr
    raw = kind.endswith("_raw")
    if raw and not have_matplotlib():
        log(not_drawn("the per-file PNG plots"))
    n = 0
    for p in walk_mats(root):
        out = process_mat_file(p, out_dir, field, sr,
                               normalize=not raw, raw_artifacts=raw)
        if out:
            n += 1
        else:
            log(f"[skip] {p}")
    log(f"[extract:{kind}] wrote {n} WAVs -> {out_dir}")
    return n
