"""int16 wire format for waveform batches.

Waveforms are clipped to [-1, 1] by the loaders (``data/loader.py::_collate``,
``data/segments.py::sanitize_wave_np``), so a producer may ship a batch as
int16 (``encode_wave_i16``, numpy, on the host), halving the bytes moved to
the device at ~90 dB quantization SNR; every training step passes its
waveform inputs through ``decode_wave``, which scales int16 back to fp32 and
hands float tensors back unchanged. The JAX package's ``data/wire.py``.
"""

from __future__ import annotations

import numpy as np
import torch

_SCALE = 32767.0


def encode_wave_i16(x: np.ndarray) -> np.ndarray:
    """Host side: [-1, 1] float waveform -> int16 wire batch."""
    return np.clip(np.round(np.asarray(x) * _SCALE),
                   -32768, 32767).astype(np.int16)


def decode_wave(x: torch.Tensor) -> torch.Tensor:
    """int16 wire batch -> fp32 waveform; a float tensor passes unchanged."""
    if x.dtype == torch.int16:
        return x.float() * (1.0 / _SCALE)
    return x
