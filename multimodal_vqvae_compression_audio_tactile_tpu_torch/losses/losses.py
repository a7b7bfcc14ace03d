"""Reconstruction losses: L1, multi-resolution STFT, mel-cosine.

The JAX package's ``losses/losses.py`` as differentiable PyTorch functions on
the port's ``dsp/stft.py`` and ``dsp/mel.py``. Everything runs in fp32, and
on a card in true fp32 (``core/precision.py::fp32_exact``: no TF32), as the
JAX package's fp32 islands do. An STFT resolution whose window is longer
than twice the signal is skipped (all skipped: 0.1 x L1).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.precision import fp32_exact
from ..dsp.mel import mel_mag
from ..dsp.stft import stft_mag


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x.float(), nan=0.0, posinf=0.0, neginf=0.0)


def _mono(x: torch.Tensor) -> torch.Tensor:
    """[B, 1, T] or [B, T] -> [B, T]."""
    return x if x.dim() == 2 else x[:, 0, :]


def safe_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute error with NaN/Inf zeroed."""
    return torch.mean(torch.abs(_finite(x) - _finite(y)))


def multires_stft_loss(x: torch.Tensor, y: torch.Tensor,
                       ffts: Sequence[int] = (256, 512, 1024),
                       hops: Sequence[int] = (64, 128, 256),
                       wins: Sequence[int] | None = None,
                       eps: float = 1e-7) -> torch.Tensor:
    """0.5 * spectral convergence + 0.5 * magnitude L1, averaged over the
    resolutions; x, y [B, 1, T] or [B, T]."""
    wins = ffts if wins is None else wins
    xs, ys = _mono(_finite(x)), _mono(_finite(y))
    T = xs.shape[-1]
    used, sc, mag = 0, 0.0, 0.0
    with fp32_exact(xs.device.type == "cuda"):
        for n_fft, hop, win in zip(ffts, hops, wins):
            if T < max(8, win // 2):
                continue
            X = stft_mag(xs, n_fft=n_fft, hop=hop, win_length=win, eps=eps)
            Y = stft_mag(ys, n_fft=n_fft, hop=hop, win_length=win, eps=eps)
            num = torch.sqrt(torch.sum((X - Y) ** 2, dim=(1, 2)))
            den = torch.clamp_min(torch.sqrt(torch.sum(Y ** 2, dim=(1, 2))), eps)
            sc = sc + torch.mean(num / den)
            mag = mag + torch.mean(torch.abs(X - Y))
            used += 1
    if used == 0:
        return 0.1 * safe_l1(xs, ys)
    return 0.5 * sc / used + 0.5 * mag / used


def _interp_frames(M: torch.Tensor, T_out: int) -> torch.Tensor:
    """Linear interpolation along the last axis (align_corners=False)."""
    T_in = M.shape[-1]
    if T_in == T_out:
        return M
    pos = (torch.arange(T_out, dtype=torch.float32, device=M.device) + 0.5) \
        * (T_in / T_out) - 0.5
    pos = torch.clamp(pos, 0.0, T_in - 1.0)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=T_in - 1)
    w = pos - lo
    return M[..., lo] * (1.0 - w) + M[..., hi] * w


def mel_cosine_loss(x: torch.Tensor, y: torch.Tensor, sr: int = 24000,
                    n_fft: int = 512, hop: int = 128, n_mels: int = 64,
                    eps: float = 1e-7) -> torch.Tensor:
    """1 - mean per-frame cosine similarity of max-normalised log-mel
    magnitudes."""
    xs, ys = _mono(x), _mono(y)
    X = mel_mag(xs, sr=sr, n_fft=n_fft, hop=hop, n_mels=n_mels, log=True, eps=eps)
    Y = mel_mag(ys, sr=sr, n_fft=n_fft, hop=hop, n_mels=n_mels, log=True, eps=eps)
    T = max(X.shape[-1], Y.shape[-1])
    X, Y = _interp_frames(X, T), _interp_frames(Y, T)
    num = torch.sum(X * Y, dim=1)                                    # [B, T]
    den = torch.clamp_min(torch.linalg.vector_norm(X, dim=1)
                          * torch.linalg.vector_norm(Y, dim=1), eps)
    cos = torch.clamp(num / den, -1.0, 1.0)
    return 1.0 - torch.mean(cos)


def codec_loss(y_hat: torch.Tensor, tgt: torch.Tensor, w_wav_l1: float = 0.55,
               w_stft: float = 0.25, w_melcos: float = 0.20, sr: int = 24000,
               ) -> Tuple[torch.Tensor, dict]:
    """total = 0.55 L1 + 0.25 MR-STFT + 0.20 MelCos, and its parts."""
    l1 = safe_l1(y_hat, tgt)
    lst = multires_stft_loss(y_hat, tgt)
    lme = mel_cosine_loss(y_hat, tgt, sr=sr)
    total = w_wav_l1 * l1 + w_stft * lst + w_melcos * lme
    return total, {"l1": l1, "stft": lst, "mel": lme, "total": total}
