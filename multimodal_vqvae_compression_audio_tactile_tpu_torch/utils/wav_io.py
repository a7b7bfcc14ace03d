"""Minimal self-contained RIFF/WAVE reader and writer (numpy).

The reference uses ``soundfile`` (reference: Training/compare_dacvsproposal_3.py:92-96:
``sf.read(path, always_2d=True)`` scaling PCM to [-1, 1]). soundfile is not available
here, so this module implements the same contract from first principles:

- ``read_wav`` returns float32 data scaled to [-1, 1] for integer PCM
  (PCM_16 / PCM_24 / PCM_32) and raw values for IEEE float32/float64.
- ``write_wav`` supports ``"PCM_16"`` and ``"FLOAT"`` subtypes, matching the extractor
  scripts (reference: Dataset/Dataset_creation/Dataset_creation_audio.py — PCM_16;
  Dataset_creation_tactile_raw.py:156 — FLOAT subtype).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str, always_2d: bool = True) -> Tuple[np.ndarray, int]:
    """Read a WAV file. Returns (data[T, C] float32 in [-1,1] for PCM, sr)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    data_bytes = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos:pos + 4]
        (size,) = struct.unpack("<I", raw[pos + 4:pos + 8])
        body = raw[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            data_bytes = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or data_bytes is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    wformat, channels, sr, _byte_rate, _block_align, bits = fmt
    if wformat == _WAVE_FORMAT_EXTENSIBLE:
        # sub-format GUID starts with the real format code
        wformat = struct.unpack("<H", raw[raw.find(b"fmt ") + 8 + 24:][:2])[0]

    if wformat == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(data_bytes, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data_bytes, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(data_bytes, dtype=np.uint8).reshape(-1, 3)
            v = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            x = v.astype(np.float32) / float(1 << 23)
        elif bits == 8:
            x = (np.frombuffer(data_bytes, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif wformat == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(data_bytes, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data_bytes, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAVE format 0x{wformat:04x}")

    n = (len(x) // channels) * channels
    x = x[:n].reshape(-1, channels)
    if not always_2d and channels == 1:
        x = x[:, 0]
    return x, int(sr)


def write_wav(path: str, data: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    """Write a WAV file. data: [T] or [T, C] float; subtype: PCM_16 | FLOAT."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    channels = data.shape[1]

    if subtype == "PCM_16":
        # libsndfile semantics: scale by 32768, clip to the int16 range
        pcm = np.clip(np.round(data * 32768.0), -32768, 32767).astype("<i2")
        payload = pcm.tobytes()
        wformat, bits = _WAVE_FORMAT_PCM, 16
    elif subtype == "FLOAT":
        payload = data.astype("<f4").tobytes()
        wformat, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    block_align = channels * bits // 8
    byte_rate = sr * block_align
    fmt = struct.pack("<HHIIHH", wformat, channels, sr, byte_rate, block_align, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if wformat == _WAVE_FORMAT_IEEE_FLOAT:
        chunks += b"fact" + struct.pack("<II", 4, data.shape[0])
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks)


def load_wav_mono(path: str) -> Tuple[np.ndarray, int]:
    """First channel as [1, T] float32 with NaN/Inf zeroed.

    Mirrors the reference's ``load_wav_raw``
    (reference: Evaluation/dac_vcpwq_proposed6_latency.py:138-148).
    """
    data, sr = read_wav(path, always_2d=True)
    w = data.T[:1, :].astype(np.float32)
    w = np.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0)
    return w, sr
