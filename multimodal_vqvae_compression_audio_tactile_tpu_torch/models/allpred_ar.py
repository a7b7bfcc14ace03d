"""AllPredAR: the autoregressive cross-modal residual codec.

Port of the JAX package's ``models/allpred_ar.py``. Audio goes
through the audio backbone's encoder and quantizer; tactile latents are
predicted chunk by chunk from (the last reconstructed token, the quantized
audio latents) by the cross-attention predictor, and only the prediction
residual is transmitted, through the head RVQ on a 96-dim projection. The
receiver replays the predictor and adds the decoded residual.

The roll is a Python loop over fixed-size chunks (5 chunks of 16 tokens for
1 s at 75 tokens/s). The token count is padded to a chunk multiple; the padded
tail is masked out of the attention keys and cut from the outputs.

Training (``ar_roll_train``, ``forward_step``): the same roll with the
predictor's dropout drawn from a generator, the residual taken against the
detached prediction, and the residual projections returned detached for the
EMA codebook step; the frozen encoders run under ``no_grad`` (on the card
through K1) and the tactile decoder through its differentiable plain stacks
(``Decoder.forward_train``).
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
from . import dac
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


def codec_of(audio_dac: DAC, tactile_dac: DAC, head: Head,
             cfg: CodecConfig) -> CodecModules:
    """A ``CodecModules`` around existing modules (used as they are, not
    copied; none is allocated)."""
    with torch.device("meta"):
        m = CodecModules(cfg)
    m.audio_dac, m.tactile_dac, m.head = audio_dac, tactile_dac, head
    return m


@torch.no_grad()
def codec_init(cfg: CodecConfig, gen: torch.Generator) -> CodecModules:
    """Random weights from ``gen``, with the JAX package's init distributions
    (``codec_init``; the numbers differ, the generators being different)."""
    m = CodecModules(cfg)
    init_dac_(m.audio_dac, gen)
    init_dac_(m.tactile_dac, gen)
    m.head = head_init(cfg, gen)
    return m


@torch.no_grad()
def head_init(cfg: CodecConfig, gen: torch.Generator) -> Head:
    """A head with the JAX package's ``head_init`` distributions, from ``gen``:
    linears U(+-1/sqrt(fan_in)), LayerNorms 1/0, scale ``cfg.scale_init``,
    books N(0, 1)/sqrt(D), counts 0."""
    h = Head(cfg)
    for lin in (h.predict.q_proj, h.predict.k_proj, h.predict.v_proj,
                h.predict.out, h.predict.ffn_in, h.predict.ffn_out,
                h.proj_down, h.proj_up):
        bound = 1.0 / math.sqrt(lin.weight.shape[1])
        lin.weight.uniform_(-bound, bound, generator=gen)
        if lin.bias is not None:
            lin.bias.uniform_(-bound, bound, generator=gen)
    D = cfg.rvq.code_dim
    h.vq_books.normal_(generator=gen).div_(math.sqrt(D))
    return h


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


class TrainRollOut(NamedTuple):
    z_run: torch.Tensor    # [B, C, T] reconstructed latent stream
    r_tokens: torch.Tensor  # [B, D, T] residual projections, detached (EMA food)
    codes: torch.Tensor    # [B, T, n_books_use] transmitted indices
    valid: torch.Tensor    # [T] bool token validity


def _roll(head: Head, cfg: CodecConfig, qa: torch.Tensor, zt_teacher: torch.Tensor,
          n_books_use: Optional[int], dropout: Optional[torch.Generator]) -> TrainRollOut:
    B, C, T = zt_teacher.shape
    chunk = cfg.ar_chunk_tok
    n_chunks, Tp = _chunks(T, chunk)
    pad = Tp - T
    qa_p = torch.nn.functional.pad(qa, (0, pad))
    zt_p = torch.nn.functional.pad(zt_teacher, (0, pad))
    valid = torch.arange(Tp, device=qa.device) < T
    scale = torch.clamp(head.scale, cfg.scale_min, cfg.scale_max).to(zt_teacher.dtype)

    carry = zt_teacher.new_zeros(B, C, 1)
    z_hats, rDs, idxs = [], [], []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        z_pred = head.predict(_zt_prev(carry, chunk), qa_p[..., sl],
                              kv_valid=valid[sl], dropout=dropout)
        rN = torch.tanh(token_norm(head.tokennorm, zt_p[..., sl] - z_pred.detach()))
        rD = _proj(head.proj_down, scale * rN)                    # [B, D, chunk]
        qD, idx = rvq_quantize(head.vq_books, rD, n_books_use=n_books_use)
        z_hat = z_pred + _proj(head.proj_up, qD)
        carry = z_hat[..., -1:]
        z_hats.append(z_hat)
        rDs.append(rD.detach())
        idxs.append(idx)
    return TrainRollOut(torch.cat(z_hats, dim=-1)[..., :T], torch.cat(rDs, dim=-1)[..., :T],
                        torch.cat(idxs, dim=1)[:, :T], valid[:T])


def ar_roll(head: Head, cfg: CodecConfig, qa: torch.Tensor,
            zt_teacher: torch.Tensor, n_books_use: Optional[int] = None,
            ) -> ARRollOut:
    """The chunked AR latent roll: qa, zt_teacher [B, C, T] -> z_run, codes."""
    out = _roll(head, cfg, qa, zt_teacher, n_books_use, None)
    return ARRollOut(out.z_run, out.codes)


def ar_roll_train(head: Head, cfg: CodecConfig, qa: torch.Tensor,
                  zt_teacher: torch.Tensor, dropout: Optional[torch.Generator] = None,
                  ) -> TrainRollOut:
    """The training roll: ``ar_roll`` with the predictor's dropout drawn from
    ``dropout`` (none when None), returning the detached residual projections
    and the token validity beside z_run and the codes. Gradients reach the
    predictor through z_pred and the projections through the straight-through
    VQ; the residual's target detaches z_pred."""
    return _roll(head, cfg, qa, zt_teacher, None, dropout)


def backbone_latents(m: CodecModules, a: torch.Tensor, tc: torch.Tensor,
                     cfg: Optional[CodecConfig] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(quantized audio latents, tactile teacher latents), both [B, C, T_lat].
    ``cfg`` (default ``m.cfg``) chooses the backbone's layout options; with
    its ``vmap_dual_encoder`` both encoders run in one pass, their stacks as
    grouped kernel launches (``models/dac.py::dual_encode``, channels-first
    whatever ``time_major_enc`` says, as the JAX package's vmapped path)."""
    cfg = cfg or m.cfg
    if cfg.vmap_dual_encoder:
        za, zt = dac.dual_encode(m.audio_dac.encoder, m.tactile_dac.encoder, a, tc, cfg.dac)
    else:
        za = m.audio_dac.encoder(a, cfg.dac)
        zt = m.tactile_dac.encoder(tc, cfg.dac)
    qa, _ = m.audio_dac.quantizer.quantize(za)
    return qa, zt


def forward_step(m: CodecModules, a: torch.Tensor, tc: torch.Tensor,
                 dropout: Optional[torch.Generator] = None,
                 cfg: Optional[CodecConfig] = None) -> dict:
    """Training forward, a and tc [B, 1, T] waveforms: the frozen encoders
    under ``no_grad`` (K1 on the card), the training roll, the tactile
    decoder through its plain stacks with autograd. -> {"y_hat", "tgt"
    (both cropped to a common length, NaN/Inf zeroed), "r_tokens", "codes",
    "valid"}."""
    cfg = cfg or m.cfg
    with torch.no_grad():
        qa, zt = backbone_latents(m, a, tc, cfg)
    roll = ar_roll_train(m.head, cfg, qa, zt, dropout=dropout)
    y_hat = m.tactile_dac.decoder.forward_train(roll.z_run, cfg.dac)
    T = min(y_hat.shape[-1], tc.shape[-1])
    fin = lambda x: torch.nan_to_num(x[..., :T], nan=0.0, posinf=0.0, neginf=0.0)  # noqa: E731
    return {"y_hat": fin(y_hat), "tgt": fin(tc), "r_tokens": roll.r_tokens,
            "codes": roll.codes, "valid": roll.valid}


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
