"""Synthetic paired audio/vibrotactile corpus generator (numpy and scipy).

The JAX package's ``data/synth.py`` (``synth_pair``, ``make_synth_corpus``),
copied so that the same seed writes the same WAVs: stem-matched mono pairs,
audio at 44.1 kHz (PCM_16, peak-normalised) and tactile at 3 kHz (float, raw
amplitudes whose corpus peak is the reference corpus' 4.3857), rendered from
a shared sparse impact train through per-modality modal resonator banks with
class-coloured friction noise, over 8 material classes C1..C8.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from scipy.signal import lfilter

from ..utils.wav_io import write_wav
from .pairs import Pair

# the reference corpus' recorded global raw tactile peak (BASELINE.md)
GLOBAL_TACTILE_PEAK = 4.3857


# Material classes C1..C8: (impact rate /s, micro-impact rate /s, tactile modal
# band Hz, audio modal band Hz, mode damping time s, noise weight, noise color
# pole Hz). Loosely: hard/resonant (wood, metal), granular (mesh, foam),
# textured scratch (sandpaper, fabric) families.
_CLASSES: Tuple[dict, ...] = (
    dict(taps=3.0, micro=0.0, tband=(60, 220), aband=(300, 3500),
         decay=(0.04, 0.25), noise_w=0.15, npole=500.0),     # C1 hard resonant
    dict(taps=6.0, micro=30.0, tband=(50, 300), aband=(400, 4000),
         decay=(0.02, 0.12), noise_w=0.25, npole=700.0),     # C2 wood-like
    dict(taps=2.0, micro=80.0, tband=(40, 350), aband=(200, 2500),
         decay=(0.01, 0.05), noise_w=0.45, npole=300.0),     # C3 granular
    dict(taps=1.5, micro=200.0, tband=(60, 400), aband=(500, 5000),
         decay=(0.004, 0.02), noise_w=0.6, npole=900.0),     # C4 rough texture
    dict(taps=8.0, micro=0.0, tband=(80, 250), aband=(800, 6000),
         decay=(0.05, 0.4), noise_w=0.1, npole=1200.0),      # C5 metal-like
    dict(taps=4.0, micro=50.0, tband=(45, 180), aband=(150, 1800),
         decay=(0.015, 0.08), noise_w=0.35, npole=250.0),    # C6 soft damped
    dict(taps=2.5, micro=120.0, tband=(55, 320), aband=(300, 3000),
         decay=(0.008, 0.04), noise_w=0.5, npole=450.0),     # C7 fabric scratch
    dict(taps=5.0, micro=15.0, tband=(70, 280), aband=(600, 4500),
         decay=(0.03, 0.18), noise_w=0.2, npole=800.0),      # C8 laminate
)


def _impact_train(rng: np.random.Generator, T: int, sr: int, rate: float,
                  amp_lo: float = 0.25, amp_hi: float = 1.0) -> np.ndarray:
    """Sparse impulse train with Poisson arrivals and random amplitudes."""
    train = np.zeros(T)
    n = rng.poisson(max(rate * T / sr, 0.0))
    if n > 0:
        pos = rng.integers(0, T, size=n)
        train[pos] += rng.uniform(amp_lo, amp_hi, size=n) * rng.choice(
            [-1.0, 1.0], size=n)
    return train

def _modal_bank(rng: np.random.Generator, exc: np.ndarray, sr: int,
                band: Tuple[float, float], decay: Tuple[float, float],
                n_modes: int) -> np.ndarray:
    """Render excitation through a bank of 2-pole resonators (vectorized IIR)."""
    out = np.zeros_like(exc)
    nyq = 0.45 * sr
    for _ in range(n_modes):
        f = min(rng.uniform(*band), nyq)
        tau = rng.uniform(*decay)
        r = np.exp(-1.0 / (tau * sr))
        w = 2 * np.pi * f / sr
        # H(z) = 1 / (1 - 2 r cos(w) z^-1 + r^2 z^-2)
        out += rng.uniform(0.3, 1.0) * lfilter(
            [1.0], [1.0, -2 * r * np.cos(w), r * r], exc)
    return out


def _colored_noise(rng: np.random.Generator, T: int, sr: int,
                   pole_hz: float) -> np.ndarray:
    """One-pole lowpassed white noise (vectorized lfilter, unit peak)."""
    a = np.exp(-2 * np.pi * pole_hz / sr)
    n = lfilter([1 - a], [1.0, -a], rng.standard_normal(T))
    return n / (np.abs(n).max() + 1e-9)


def synth_pair(rng: np.random.Generator, dur_sec: float = 2.0,
               sr_audio: int = 44100, sr_tact: int = 3000,
               material: Optional[int] = None,
               decorrelate: float = 0.0, jitter_ms: float = 0.0):
    """One correlated (audio, tactile) pair.

    Returns (audio float32 peak-normalized [-1,1] @ sr_audio,
    tactile float32 raw-amplitude @ sr_tact).

    Corpus-hardness knobs (round-2 VERDICT missing #3 — the default corpus'
    fully shared excitation plausibly overstates audio->tactile
    predictability vs the reference's recordings, where the proposed codec
    LOSES to its DAC baseline at >=3 kbps):

    - ``decorrelate`` in [0, 1]: fraction of contact events that are
      per-modality INDEPENDENT — each non-shared tap is replaced by a fresh
      independent draw in each modality (event rates unchanged), and the
      shared contact-speed envelope is mixed ``(1-d)*shared + d*independent``
      per modality. 0 = round-2 corpus (bit-identical rng stream), 1 = zero
      cross-modal mutual information beyond class timbre statistics.
    - ``jitter_ms``: gaussian per-modality timing jitter on the SHARED events
      (sensor/actuator asynchrony); degrades sample-aligned predictability
      without removing event co-occurrence.
    """
    cls = _CLASSES[int(material) if material is not None
                   else int(rng.integers(len(_CLASSES)))]
    hard = decorrelate > 0.0 or jitter_ms > 0.0

    # ---- shared excitation on a common 3 kHz grid, then per-SR resample-free
    # re-render: impacts are re-drawn at each SR from the SAME event list so
    # both modalities see identical contact timing.
    T_t = int(dur_sec * sr_tact)
    taps = rng.poisson(max(cls["taps"] * dur_sec, 0.5))
    tap_t = rng.uniform(0, dur_sec, size=taps)
    tap_a = rng.uniform(0.4, 1.0, size=taps) * rng.choice([-1, 1], size=taps)

    if hard:
        # per-modality event lists: shared events keep identical (t, a);
        # decorrelated slots are re-drawn independently per modality. All
        # extra rng draws are gated behind `hard` so decorrelate=0 keeps the
        # round-2 corpus bit-identical (same rng stream).
        shared = rng.random(taps) >= decorrelate

        def modality_events():
            t, a = tap_t.copy(), tap_a.copy()
            repl = ~shared
            n_r = int(repl.sum())
            if n_r:
                t[repl] = rng.uniform(0, dur_sec, size=n_r)
                a[repl] = rng.uniform(0.4, 1.0, size=n_r) * rng.choice(
                    [-1.0, 1.0], size=n_r)
            if jitter_ms > 0.0 and taps:
                t = np.clip(t + rng.normal(0.0, jitter_ms / 1000.0,
                                           size=taps), 0.0, dur_sec)
            return t, a

        ev_audio = modality_events()
        ev_tact = modality_events()
    else:
        ev_audio = ev_tact = (tap_t, tap_a)

    def impulse(sr: int, T: int, ev) -> np.ndarray:
        ev_t, ev_a = ev
        tr = np.zeros(T)
        idx = np.minimum((ev_t * sr).astype(int), T - 1)
        np.add.at(tr, idx, ev_a)
        return tr

    # contact-speed envelope (shared; smooth positive, 10 Hz bandwidth)
    def draw_env() -> np.ndarray:
        e = np.abs(lfilter([1 - 0.98], [1, -0.98],
                           rng.standard_normal(max(T_t, 8))))
        return e / (e.max() + 1e-9)

    env_grid = draw_env()
    if hard and decorrelate > 0.0:
        def modality_env():
            e = (1.0 - decorrelate) * env_grid + decorrelate * draw_env()
            return e / (e.max() + 1e-9)
        env_audio, env_tact = modality_env(), modality_env()
    else:
        env_audio = env_tact = env_grid
    t_grid = np.arange(T_t) / sr_tact

    def render(sr: int, band, noise_pole: float, n_modes: int, ev,
               env_grid_m) -> np.ndarray:
        T = int(dur_sec * sr)
        exc = impulse(sr, T, ev)
        exc += _impact_train(rng, T, sr, cls["micro"], 0.05, 0.35)
        sig = _modal_bank(rng, exc, sr, band, cls["decay"], n_modes)
        t = np.arange(T) / sr
        env = np.interp(t, t_grid, env_grid_m[:T_t])
        sig += cls["noise_w"] * env * _colored_noise(rng, T, sr, noise_pole) \
            * (np.abs(sig).max() + 1e-9)
        return sig.astype(np.float32)

    audio = render(sr_audio, cls["aband"], cls["npole"] * 4.0, n_modes=4,
                   ev=ev_audio, env_grid_m=env_audio)
    tact = render(sr_tact, cls["tband"], cls["npole"], n_modes=3,
                  ev=ev_tact, env_grid_m=env_tact)

    # audio contract: peak-normalized to [-1, 1] (Dataset_creation_audio.py:31-37)
    audio = audio / (np.abs(audio).max() + 1e-9)
    # tactile contract: raw accelerometer amplitudes; per-file peak lognormal
    # around ~0.9, heavy right tail clipped at the reference's global peak
    peak = float(np.clip(rng.lognormal(mean=-0.25, sigma=0.55), 0.05,
                         GLOBAL_TACTILE_PEAK))
    tact = tact / (np.abs(tact).max() + 1e-9) * peak
    return audio, tact


def make_synth_corpus(root: str, n_pairs: int = 12, dur_sec: float = 2.0,
                      seed: int = 7, decorrelate: float = 0.0,
                      jitter_ms: float = 0.0) -> List[Pair]:
    """Write a corpus under root/{audio,tactile}/pair_XXXX.wav; returns pairs.

    Material classes cycle C1..C8 so every corpus size covers all families.
    ``decorrelate`` / ``jitter_ms``: corpus-hardness knobs (see synth_pair);
    defaults keep the round-2 corpus bit-identical for a given seed.
    """
    audio_dir = os.path.join(root, "audio")
    tact_dir = os.path.join(root, "tactile")
    os.makedirs(audio_dir, exist_ok=True)
    os.makedirs(tact_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n_pairs):
        a, t = synth_pair(rng, dur_sec=dur_sec, material=i % len(_CLASSES),
                          decorrelate=decorrelate, jitter_ms=jitter_ms)
        stem = f"pair_{i:04d}"
        ap = os.path.join(audio_dir, stem + ".wav")
        tp = os.path.join(tact_dir, stem + ".wav")
        write_wav(ap, a, 44100, subtype="PCM_16")
        write_wav(tp, t, 3000, subtype="FLOAT")
        pairs.append((ap, tp, stem))
    return pairs
