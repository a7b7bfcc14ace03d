"""AllPredAR: the autoregressive cross-modal residual codec.

Port of the JAX package's ``models/allpred_ar.py`` (serving half). Audio goes
through the audio backbone's encoder and quantizer; tactile latents are
predicted chunk by chunk from (the last reconstructed token, the quantized
audio latents) by the cross-attention predictor, and only the prediction
residual is transmitted, through the head RVQ on a 96-dim projection. The
receiver replays the predictor and adds the decoded residual.

The roll is a Python loop over fixed-size chunks (5 chunks of 16 tokens for
1 s at 75 tokens/s). The token count is padded to a chunk multiple; the padded
tail is masked out of the attention keys and cut from the outputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.config import CodecConfig
from ..core.precision import fp32_exact
from ..nn.layers import CrossPredictor, token_norm
from ..ops.rvq import rvq_decode, rvq_quantize
from .dac import DAC, init_dac_


class Head(nn.Module):
    """Predictor + TokenNorm + scale + 1x1 projections + VQ books.
    ``proj_down``/``proj_up`` are ``nn.Linear`` (weight = JAX ``w``.T)."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        C, D = cfg.predictor.dim, cfg.rvq.code_dim
        self.predict = CrossPredictor(cfg.predictor)
        self.tokennorm = nn.LayerNorm(C)
        self.scale = nn.Parameter(torch.tensor(cfg.scale_init))
        self.proj_down = nn.Linear(C, D)
        self.proj_up = nn.Linear(D, C)
        self.vq_books = nn.Parameter(torch.empty(cfg.rvq.n_books,
                                                 cfg.rvq.n_embed, D))
        # EMA cluster sizes: training state, carried so checkpoints round-trip
        self.register_buffer("vq_counts", torch.zeros(cfg.rvq.n_books,
                                                      cfg.rvq.n_embed))


class CodecModules(nn.Module):
    """Full codec: two backbones (audio, tactile) + the trainable head."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.cfg = cfg
        self.audio_dac = DAC(cfg.dac)
        self.tactile_dac = DAC(cfg.dac)
        self.head = Head(cfg)


@torch.no_grad()
def codec_init(cfg: CodecConfig, gen: torch.Generator) -> CodecModules:
    """Random weights from ``gen``, with the JAX package's init distributions
    (``codec_init``; the numbers differ, the generators being different)."""
    m = CodecModules(cfg)
    init_dac_(m.audio_dac, gen)
    init_dac_(m.tactile_dac, gen)
    h = m.head
    for lin in (h.predict.q_proj, h.predict.k_proj, h.predict.v_proj,
                h.predict.out, h.predict.ffn_in, h.predict.ffn_out,
                h.proj_down, h.proj_up):
        bound = 1.0 / math.sqrt(lin.weight.shape[1])
        lin.weight.uniform_(-bound, bound, generator=gen)
        if lin.bias is not None:
            lin.bias.uniform_(-bound, bound, generator=gen)
    D = cfg.rvq.code_dim
    h.vq_books.normal_(generator=gen).div_(math.sqrt(D))
    return m


def _proj(lin: nn.Linear, x_bct: torch.Tensor) -> torch.Tensor:
    """1x1 conv as a matmul: [B, C, T] -> [B, D, T], in x's dtype."""
    y = torch.einsum("bct,dc->bdt", x_bct, lin.weight.to(x_bct.dtype))
    return y + lin.bias.to(x_bct.dtype)[None, :, None]


def _chunks(T: int, chunk: int) -> Tuple[int, int]:
    n = -(-T // chunk)
    return n, n * chunk


def _zt_prev(carry: torch.Tensor, chunk: int) -> torch.Tensor:
    """The query of a chunk: last reconstructed token, then zeros."""
    B, C, _ = carry.shape
    return torch.cat([carry, carry.new_zeros(B, C, chunk - 1)], dim=-1)


class ARRollOut(NamedTuple):
    z_run: torch.Tensor    # [B, C, T] reconstructed latent stream
    codes: torch.Tensor    # [B, T, n_books_use] transmitted indices


def ar_roll(head: Head, cfg: CodecConfig, qa: torch.Tensor,
            zt_teacher: torch.Tensor, n_books_use: Optional[int] = None,
            ) -> ARRollOut:
    """The chunked AR latent roll: qa, zt_teacher [B, C, T] -> z_run, codes."""
    B, C, T = zt_teacher.shape
    chunk = cfg.ar_chunk_tok
    n_chunks, Tp = _chunks(T, chunk)
    pad = Tp - T
    qa_p = torch.nn.functional.pad(qa, (0, pad))
    zt_p = torch.nn.functional.pad(zt_teacher, (0, pad))
    valid = torch.arange(Tp, device=qa.device) < T
    scale = torch.clamp(head.scale, cfg.scale_min, cfg.scale_max).to(zt_teacher.dtype)

    carry = zt_teacher.new_zeros(B, C, 1)
    z_hats, idxs = [], []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        z_pred = head.predict(_zt_prev(carry, chunk), qa_p[..., sl],
                              kv_valid=valid[sl])
        rN = torch.tanh(token_norm(head.tokennorm, zt_p[..., sl] - z_pred))
        rD = _proj(head.proj_down, scale * rN)                    # [B, D, chunk]
        qD, idx = rvq_quantize(head.vq_books, rD, n_books_use=n_books_use)
        z_hat = z_pred + _proj(head.proj_up, qD)
        carry = z_hat[..., -1:]
        z_hats.append(z_hat)
        idxs.append(idx)
    z_run = torch.cat(z_hats, dim=-1)[..., :T]
    codes = torch.cat(idxs, dim=1)[:, :T]
    return ARRollOut(z_run, codes)


def backbone_latents(m: CodecModules, a: torch.Tensor, tc: torch.Tensor,
                     cfg: Optional[CodecConfig] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quantized audio latents, tactile teacher latents), both [B, C, T_lat].
    ``cfg`` (default ``m.cfg``) chooses the backbone's layout options."""
    dcfg = (cfg or m.cfg).dac
    za = m.audio_dac.encoder(a, dcfg)
    zt = m.tactile_dac.encoder(tc, dcfg)
    qa, _ = m.audio_dac.quantizer.quantize(za)
    return qa, zt


@torch.no_grad()
def encode_latents(m: CodecModules, a: torch.Tensor, tc: torch.Tensor,
                   n_books_use: Optional[int] = None,
                   cfg: Optional[CodecConfig] = None) -> ARRollOut:
    """Serving encode: audio + tactile [B, 1, T] -> (z_run, codes). In fp32
    (a's dtype) every convolution and product is true fp32 (no TF32)."""
    cfg = cfg or m.cfg
    with fp32_exact(a.dtype == torch.float32):
        qa, zt = backbone_latents(m, a, tc, cfg)
        return ar_roll(m.head, cfg, qa, zt, n_books_use=n_books_use)


@torch.no_grad()
def forward_eval(m: CodecModules, a: torch.Tensor, tc: torch.Tensor,
                 n_books_use: Optional[int] = None,
                 cfg: Optional[CodecConfig] = None) -> torch.Tensor:
    """Full encode + decode -> tactile waveform [B, 1, T]; true fp32 in fp32."""
    cfg = cfg or m.cfg
    with fp32_exact(a.dtype == torch.float32):
        z_run, _ = encode_latents(m, a, tc, n_books_use=n_books_use, cfg=cfg)
        return m.tactile_dac.decoder(z_run, cfg.dac)


@torch.no_grad()
def decode_from_codes(m: CodecModules, a: torch.Tensor, codes: torch.Tensor,
                      cfg: Optional[CodecConfig] = None) -> torch.Tensor:
    """Receiver: audio waveform [B, 1, T] + codes [B, T_lat, n_use] -> tactile
    waveform. Re-encodes the audio, replays the predictor and adds the decoded
    residual; no tactile input is needed. True fp32 in fp32 (a's dtype)."""
    with fp32_exact(a.dtype == torch.float32):
        return _decode_from_codes(m, a, codes, cfg or m.cfg)


def _decode_from_codes(m: CodecModules, a: torch.Tensor, codes: torch.Tensor,
                       cfg: CodecConfig) -> torch.Tensor:
    head = m.head
    za = m.audio_dac.encoder(a, cfg.dac)
    qa, _ = m.audio_dac.quantizer.quantize(za)
    B, C, T = qa.shape
    T = min(T, codes.shape[1])
    chunk = cfg.ar_chunk_tok
    n_chunks, Tp = _chunks(T, chunk)
    qa_p = torch.nn.functional.pad(qa[..., :T], (0, Tp - T))
    codes_p = torch.nn.functional.pad(codes[:, :T], (0, 0, 0, Tp - T))
    valid = torch.arange(Tp, device=qa.device) < T

    carry = qa.new_zeros(B, C, 1)
    z_hats = []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        z_pred = head.predict(_zt_prev(carry, chunk), qa_p[..., sl],
                              kv_valid=valid[sl])
        qD = rvq_decode(head.vq_books, codes_p[:, sl]).to(z_pred.dtype)
        z_hat = z_pred + _proj(head.proj_up, qD)
        carry = z_hat[..., -1:]
        z_hats.append(z_hat)
    z_run = torch.cat(z_hats, dim=-1)[..., :T]
    return m.tactile_dac.decoder(z_run, cfg.dac)
