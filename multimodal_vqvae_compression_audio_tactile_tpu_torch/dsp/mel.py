"""HTK mel filterbank and max-normalised mel magnitudes.

The filterbank is the JAX package's ``dsp/mel.py`` construction in numpy
(torchaudio ``MelScale(norm=None, mel_scale="htk")``): triangles on the HTK
mel scale (mel = 2595 log10(1 + f / 700)) over a linear FFT-bin grid, no
area normalisation. ``mel_mag`` is a host-side metric: numpy input computes
on the CPU, a tensor on its own device, in fp32 (true fp32 on a card).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.precision import fp32_exact
from .stft import stft_mag


def _hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=32)
def mel_fbanks_htk(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """Triangular HTK mel filterbank [n_freqs, n_mels], norm=None (float32)."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                       # [n_mels+1]
    slopes = f_pts[None, :] - all_freqs[:, None]          # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def mel_mag(x, sr: int = 24000, n_fft: int = 512, hop: int = 128, n_mels: int = 64,
            log: bool = False, eps: float = 1e-8) -> torch.Tensor:
    """Max-normalised mel magnitude of x [..., T] -> [..., n_mels, frames]:
    |STFT| clamped to ``eps``, the mel projection, division by each example's
    maximum; with ``log``, then log(M + eps)."""
    x = torch.as_tensor(x)
    mag = stft_mag(x, n_fft=n_fft, hop=hop, center=True).clamp_min(eps)
    fb = torch.from_numpy(mel_fbanks_htk(n_fft // 2 + 1, 0.0, sr * 0.5, n_mels, sr))
    with fp32_exact(x.device.type == "cuda"):
        M = torch.einsum("...ft,fm->...mt", mag, fb.to(mag.device))
    M = M / torch.amax(M, dim=(-2, -1), keepdim=True).clamp_min(eps)
    return torch.log(M + eps) if log else M
