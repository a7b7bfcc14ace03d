"""Batched streaming serving: the codec over fixed ``[batch, 1, frame]`` shapes.

Port of the JAX package's ``eval/serving.py::StreamingCodec``. One frame is one
second of signal (75 latent tokens) by default. As there, two settings
choose the arithmetic, independently of each other:

- ``compute_dtype`` (default ``torch.bfloat16``, the serving default): the
  activations' type, so the operands of the conv stacks and the attention,
  with fp32 accumulation; ``torch.float32`` is the parity mode. The VQ
  scores that pick the transmitted codes are true fp32 in both.
- ``fast`` (default True): the JAX package's ``CodecConfig.fast_serving()``
  matmul precision ("default" against "highest"), kept in ``cfg``. The
  port's CUDA paths compute in the operand type at full precision either way.

In fp32 every convolution and product is true fp32: the entry points pin
TF32 off for the duration of a call (``core/precision.py::fp32_exact``) and
leave the process's settings as they found them.

The layout options ``time_major``, ``time_major_enc``, ``tail_kernel`` and
``poly_upsample`` have the JAX package's names and meanings (see
``core/config.py``); an explicit boolean sets the option as there. ``None``
means off, for all four. The JAX package resolves ``time_major`` and
``poly_upsample`` to ``batch < 8 and fast``, a policy that rests on TPU
measurements; on the H100 nothing supports it yet, and it would move the
default batch-1 decoder off the kernel K1 onto plain matrix products. An A/B
on the card is to set this policy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.config import CodecConfig
from ..core.precision import fp32_exact
from ..models import allpred_ar
from . import bitstream


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CPU run must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


class StreamingCodec:
    """Encode/decode over fixed batched shapes; the warm-up runs once here."""

    def __init__(self, modules: allpred_ar.CodecModules, batch: int,
                 frame_sec: float = 1.0, n_books_use: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.bfloat16, fast: bool = True,
                 device=None,
                 poly_upsample: Optional[bool] = None,
                 time_major: Optional[bool] = None,
                 tail_kernel: Optional[bool] = None,
                 time_major_enc: Optional[bool] = None):
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"StreamingCodec: unsupported compute_dtype {compute_dtype}")
        self.device = resolve_device(device)
        cfg: CodecConfig = modules.cfg
        cfg = cfg.fast_serving() if fast else cfg
        self.cfg = dataclasses.replace(cfg, dac=dataclasses.replace(
            cfg.dac, poly_upsample=bool(poly_upsample), time_major=bool(time_major),
            tail_kernel=bool(tail_kernel), time_major_enc=bool(time_major_enc)))
        self.dtype = compute_dtype
        self.modules = modules.to(self.device).eval()
        self.batch = batch
        self.frame = int(frame_sec * cfg.dac.sample_rate)
        self.n_books_use = n_books_use or cfg.rvq.n_books
        zeros = np.zeros((batch, 1, self.frame), np.float32)
        z_run, _ = self.encode(zeros, zeros)
        self.decode(z_run)

    def _put(self, x) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if t.shape != (self.batch, 1, self.frame):
            raise ValueError(f"expected [{self.batch}, 1, {self.frame}], got "
                             f"{tuple(t.shape)}")
        return t.to(self.dtype)

    def encode(self, a, tc):
        """audio, tactile [batch, 1, frame] -> (z_run [batch, C, T_lat] in the
        compute dtype, codes [batch, T_lat, n_books_use] int32)."""
        return allpred_ar.encode_latents(self.modules, self._put(a), self._put(tc),
                                         n_books_use=self.n_books_use, cfg=self.cfg)

    @torch.no_grad()
    def decode(self, z_run: torch.Tensor) -> torch.Tensor:
        """Latent stream -> tactile waveform [batch, 1, frame] (fp32)."""
        with fp32_exact(self.dtype == torch.float32):
            return self.modules.tactile_dac.decoder(z_run.to(self.dtype),
                                                    self.cfg.dac).float()

    def decode_from_codes(self, a, codes) -> torch.Tensor:
        """Receiver: audio [batch, 1, frame] + codes [batch, T_lat, n] ->
        tactile waveform [batch, 1, frame] (fp32)."""
        codes = torch.as_tensor(codes, dtype=torch.int32, device=self.device)
        return allpred_ar.decode_from_codes(self.modules, self._put(a), codes,
                                            cfg=self.cfg).float()

    def encode_to_bytes(self, a, tc) -> List[bytes]:
        """Transmitter: waveforms -> one 'RVQ1' byte stream per batch element."""
        _, codes = self.encode(a, tc)
        return [bitstream.pack_codes(c, self.cfg.rvq.n_embed)
                for c in codes.cpu().numpy()]

    def decode_from_bytes(self, a, streams: List[bytes]) -> torch.Tensor:
        """Receiver: audio + 'RVQ1' byte streams -> tactile waveforms."""
        codes = np.stack([bitstream.unpack_codes(s) for s in streams])
        return self.decode_from_codes(a, codes)
