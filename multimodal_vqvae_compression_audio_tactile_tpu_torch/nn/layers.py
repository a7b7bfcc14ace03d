"""Predictor building blocks: sinusoidal position table, fp32 LayerNorm,
TokenNorm and the single-block cross-attention predictor.

Port of the JAX package's ``nn/layers.py``. Matmuls run in the input's dtype
(fp32 for parity, bf16 for serving); layer norms and the softmax run in fp32.
The attention over one AR chunk is plain ``torch.matmul``/``softmax``.
Training drops the merged attention output at rate ``cfg.dropout`` (kept
values scaled by ``1 / (1 - p)``), drawing from a generator the caller
passes; with none there is no dropout, as in the JAX package without a
dropout key.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import rng
from ..core.config import PredictorConfig


@lru_cache(maxsize=8)
def posenc_table(c: int, max_len: int = 8192) -> np.ndarray:
    """Sinusoidal table [max_len, c]: even channels sin, odd channels cos."""
    pe = np.zeros((max_len, c), np.float32)
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, c, 2, dtype=np.float64) * (-math.log(10000.0) / c))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def layer_norm(m: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * m.weight + m.bias).to(x.dtype)


def token_norm(m: nn.LayerNorm, z_bct: torch.Tensor) -> torch.Tensor:
    """TokenNorm: LayerNorm over the channels of [B, C, T]."""
    return layer_norm(m, z_bct.transpose(-1, -2)).transpose(-1, -2)


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.linear(x, m.weight.to(x.dtype), b)


class CrossPredictor(nn.Module):
    """One cross-attention block: queries from the previous tactile latents,
    keys/values from the quantized audio latents, bias-free projections,
    exact-GELU FFN at ``mlp_mul`` x width, eval wiring ``y = out(ctx) + q``
    with q the layer-normed, position-encoded query."""

    def __init__(self, cfg: PredictorConfig):
        super().__init__()
        c = cfg.dim
        self.cfg = cfg
        self.ln_q = nn.LayerNorm(c)
        self.ln_kv = nn.LayerNorm(c)
        self.q_proj = nn.Linear(c, c, bias=False)
        self.k_proj = nn.Linear(c, c, bias=False)
        self.v_proj = nn.Linear(c, c, bias=False)
        self.out = nn.Linear(c, c, bias=False)
        self.ffn_ln = nn.LayerNorm(c)
        self.ffn_in = nn.Linear(c, cfg.mlp_mul * c)
        self.ffn_out = nn.Linear(cfg.mlp_mul * c, c)
        self.register_buffer("pe", torch.from_numpy(posenc_table(c, cfg.max_len)),
                             persistent=False)

    def _posenc(self, x_bct: torch.Tensor) -> torch.Tensor:
        """x [B, C, T] + PE[:T] -> [B, T, C]."""
        return x_bct.transpose(-1, -2) + self.pe[:x_bct.shape[-1]].to(x_bct.dtype)

    def forward(self, zt_prev: torch.Tensor, za: torch.Tensor,
                kv_valid: Optional[torch.Tensor] = None,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        """zt_prev [B, C, Tq], za [B, C, Tkv] -> [B, C, Tq]. ``kv_valid``
        [Tkv] or [B, Tkv] bool masks out keys (the padded tail of a chunk);
        ``dropout``, a generator on the inputs' device (or a
        ``core/rng.py::BatchShard`` of one), turns on train-time dropout."""
        h = self.cfg.heads
        dh = self.cfg.dim // h
        q = layer_norm(self.ln_q, self._posenc(zt_prev))           # [B, Tq, C]
        kv = layer_norm(self.ln_kv, self._posenc(za))              # [B, Tkv, C]

        def split(x):  # [B, T, C] -> [B, h, T, dh]
            B, T, _ = x.shape
            return x.reshape(B, T, h, dh).transpose(1, 2)

        Q = split(linear(self.q_proj, q))
        K = split(linear(self.k_proj, kv))
        V = split(linear(self.v_proj, kv))
        attn = torch.matmul(Q, K.transpose(-1, -2)) / math.sqrt(dh)
        if kv_valid is not None:
            mask = kv_valid if kv_valid.dim() == 2 else kv_valid[None]
            attn = attn.masked_fill(~mask[:, None, None, :],
                                    torch.finfo(attn.dtype).min)
        attn = torch.softmax(attn.float(), dim=-1).to(Q.dtype)
        ctx = torch.matmul(attn, V)
        B, _, Tq, _ = ctx.shape
        merged = ctx.transpose(1, 2).reshape(B, Tq, self.cfg.dim)
        p = self.cfg.dropout
        if dropout is not None and p > 0.0:
            keep = rng.rand(merged.shape, dropout, merged.device) < 1.0 - p
            merged = torch.where(keep, merged / (1.0 - p), 0.0)
        y = linear(self.out, merged)
        y = y + q
        ff = linear(self.ffn_out, F.gelu(linear(self.ffn_in,
                                                layer_norm(self.ffn_ln, y))))
        return (y + ff).transpose(-1, -2)
