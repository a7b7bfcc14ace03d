"""Windowed-sinc polyphase resampler (torchaudio's algorithm).

The kernel bank is the JAX package's ``dsp/resample.py`` construction, built
in float64 numpy and cast to fp32: rates reduced by their gcd, ``new_g``
Hann-windowed sinc kernels at ``rolloff * min(orig_g, new_g)`` cutoff
(``lowpass_filter_width`` 6, rolloff 0.99, torchaudio's defaults), applied as
one ``conv1d`` of stride ``orig_g``. The output has ``ceil(new * T / orig)``
samples. A host-side op: numpy input computes on the CPU, a tensor on its
own device, in fp32 (true fp32 on a card).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..core.precision import fp32_exact


@lru_cache(maxsize=64)
def resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                    rolloff: float = 0.99) -> tuple:
    """(kernels [new_g, 1, kernel_len] float32, width, orig_g, new_g), orig_g
    and new_g the gcd-reduced rates."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_g, new_g = orig_freq // g, new_freq // g
    base_freq = min(orig_g, new_g) * rolloff
    width = math.ceil(lowpass_filter_width * orig_g / base_freq)

    idx = np.arange(-width, width + orig_g, dtype=np.float64)[None, :] / orig_g
    t = np.arange(0, -new_g, -1, dtype=np.float64)[:, None] / new_g + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    scale = base_freq / orig_g
    kernels = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernels = (kernels * window * scale).astype(np.float32)
    return kernels[:, None, :], width, orig_g, new_g


def resample(x, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """Resample x [..., T] from ``orig_freq`` to ``new_freq`` -> fp32 tensor
    [..., ceil(new_freq * T / orig_freq)]."""
    x = torch.as_tensor(x).float()
    if orig_freq == new_freq:
        return x.clone()
    kernels, width, orig_g, new_g = resample_kernel(orig_freq, new_freq,
                                                    lowpass_filter_width, rolloff)
    lead, T = x.shape[:-1], x.shape[-1]
    xf = F.pad(x.reshape(-1, 1, T), (width, width + orig_g))
    with fp32_exact(x.device.type == "cuda"):
        y = F.conv1d(xf, torch.from_numpy(kernels).to(x.device), stride=orig_g)
    y = y.transpose(1, 2).reshape(xf.shape[0], -1)            # [B, frames * new_g]
    target_len = int(math.ceil(new_g * T / orig_g))
    return y[:, :target_len].reshape(*lead, target_len)
