"""STFT in PyTorch with ``torch.stft``'s framing, as the JAX package's
``dsp/stft.py`` computes it.

The signal is made finite (NaN and infinities to 0), reflect-padded by
``n_fft // 2`` on both sides (``center=True``; a signal no longer than the
pad is reflected again and again, as ``numpy.pad``'s reflect mode does), cut into ``1 + T // hop``
frames of ``n_fft`` samples, windowed by a periodic Hann window of
``win_length`` samples zero-padded symmetrically to ``n_fft``, and
transformed by ``torch.fft.rfft``. Everything runs in fp32, on the device of
the input tensor.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.rvq import take_rows


def hann_window(win_length: int) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window``'s default), fp32 on the CPU."""
    n = np.arange(win_length)
    return torch.from_numpy((0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length)))
                            .astype(np.float32))


def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """x [..., T] reflect-padded by p on both sides, for any p (numpy's
    repeated reflection when p >= T; ``F.pad`` takes only p < T), out of
    slices, flips and a concatenation, or ``take_rows``: the backward of
    ``F.pad``'s reflect mode accumulates with atomics on the card."""
    T = x.shape[-1]
    if p < T:
        return torch.cat([x[..., 1:p + 1].flip(-1), x, x[..., -p - 1:-1].flip(-1)], dim=-1)
    i = torch.arange(-p, T + p, device=x.device)
    j = torch.zeros_like(i) if T == 1 else torch.remainder(i, 2 * (T - 1))
    j = torch.where(j >= T, 2 * (T - 1) - j, j)
    return take_rows(x.movedim(-1, 0), j).movedim(0, -1)


def reflect_pad_right(x: torch.Tensor, p: int) -> torch.Tensor:
    """x [..., T] reflect-padded by p < T on the right, as ``F.pad(...,
    mode="reflect")`` pads, out of slices, flips and a concatenation: their
    backward writes each gradient once, where the card's backward of
    ``F.pad``'s reflect mode accumulates with atomics."""
    return torch.cat([x, x[..., -p - 1:-1].flip(-1)], dim=-1) if p else x


def stft_complex(x: torch.Tensor, n_fft: int, hop: int,
                 win_length: Optional[int] = None, center: bool = True) -> torch.Tensor:
    """Complex STFT of x [..., T] -> [..., n_fft // 2 + 1, n_frames], complex64,
    as ``torch.stft(center=True, pad_mode="reflect", onesided=True)``."""
    win_length = n_fft if win_length is None else win_length
    x = torch.nan_to_num(torch.as_tensor(x).float(), nan=0.0, posinf=0.0, neginf=0.0)
    if center:
        x = _reflect_pad(x, n_fft // 2)
    win = hann_window(win_length).to(x.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    frames = x.unfold(-1, n_fft, hop) * win                 # [..., n_frames, n_fft]
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def stft_mag(x: torch.Tensor, n_fft: int, hop: int, win_length: Optional[int] = None,
             center: bool = True, eps: float = 0.0) -> torch.Tensor:
    """|STFT| of x [..., T] -> [..., n_fft // 2 + 1, n_frames], fp32."""
    mag = stft_complex(x, n_fft, hop, win_length, center).abs()
    return mag.clamp_min(eps) if eps > 0.0 else mag
