"""Audio -> tactile packet-loss concealment (AllPredPLC).

Port of the JAX package's ``plc/model.py``. The backbones are frozen; the
receiver sees the tactile latent stream with its lost tokens zeroed (plus
the head's learned mask token there, with ``mask_embed``). A cross-attention
predictor over the whole stream (one block, or ``n_layers`` stacked) predicts
every token from the audio latents and the surviving tactile tokens, and only
the lost positions are replaced before the tactile decoder runs. There is no
AR roll: one attention over the 75 tokens of a second.

The entry points take ``PLCModules`` (audio backbone, tactile backbone,
head) where the JAX package takes ``CodecParams``, and a boolean loss mask
[B, T_lat] (True = lost). They compute in the inputs' dtype; in fp32 every
convolution and product is true fp32 (``core/precision.py::fp32_exact``). On
a CUDA card the backbones' stacks run through the kernels K1 (and K3 under
``tail_kernel``), as in ``models/allpred_ar.py``.

By default they run without gradients and without dropout (serving,
evaluation). The PLC trainer (``plc/train.py``) calls ``forward_step``,
``forward_step_latents`` and ``predict_latents`` with ``train=True``: the
predictor records autograd and draws its dropout from the ``dropout``
generator, the frozen encoders still run under ``no_grad`` (K1 on the card),
and the tactile decoder runs through its differentiable plain stacks
(``Decoder.forward_train``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..core.config import CodecConfig
from ..core.precision import fp32_exact
from ..models import allpred_ar
from ..models.dac import DAC, Decoder, init_dac_
from ..nn.layers import CrossPredictor


class PLCHead(nn.Module):
    """The trainable PLC head: ``predict`` (the first cross-attention block),
    ``tokennorm`` (kept for checkpoint parity; the forward does not use it),
    ``mask_embed`` (always present, zeros until trained; read only with
    ``mask_embed=True``) and ``predict_extra`` (blocks 2..n_layers)."""

    def __init__(self, cfg: CodecConfig, n_layers: int = 1):
        super().__init__()
        C = cfg.predictor.dim
        self.predict = CrossPredictor(cfg.predictor)
        self.tokennorm = nn.LayerNorm(C)
        self.mask_embed = nn.Parameter(torch.zeros(C))
        self.predict_extra = nn.ModuleList(CrossPredictor(cfg.predictor)
                                           for _ in range(n_layers - 1))


class PLCModules(nn.Module):
    """Concealment model: two backbones (audio, tactile) + the PLC head."""

    def __init__(self, cfg: CodecConfig, n_layers: int = 1):
        super().__init__()
        self.cfg = cfg
        self.audio_dac = DAC(cfg.dac)
        self.tactile_dac = DAC(cfg.dac)
        self.head = PLCHead(cfg, n_layers)


def plc_of(audio_dac: DAC, tactile_dac: DAC, head: PLCHead, cfg: CodecConfig) -> PLCModules:
    """A ``PLCModules`` around existing modules (used as they are, not
    copied; none is allocated), as ``models/allpred_ar.py::codec_of``."""
    with torch.device("meta"):
        m = PLCModules(cfg, n_layers=len(head.predict_extra) + 1)
    m.audio_dac, m.tactile_dac, m.head = audio_dac, tactile_dac, head
    return m


@torch.no_grad()
def plc_head_init(cfg: CodecConfig, gen: torch.Generator, n_layers: int = 1) -> PLCHead:
    """Random head from ``gen`` with the JAX package's init distributions
    (``plc_head_init``: linear weights and biases U(+-1/sqrt(d_in)), layer
    norms 1 and 0, ``mask_embed`` zeros); the numbers differ, the generators
    being different."""
    head = PLCHead(cfg, n_layers)
    for block in (head.predict, *head.predict_extra):
        for lin in (block.q_proj, block.k_proj, block.v_proj, block.out,
                    block.ffn_in, block.ffn_out):
            bound = 1.0 / math.sqrt(lin.weight.shape[1])
            lin.weight.uniform_(-bound, bound, generator=gen)
            if lin.bias is not None:
                lin.bias.uniform_(-bound, bound, generator=gen)
    return head


@torch.no_grad()
def plc_init(cfg: CodecConfig, gen: torch.Generator, n_layers: int = 1) -> PLCModules:
    """Random backbones and head from ``gen``."""
    m = PLCModules(cfg, n_layers)
    init_dac_(m.audio_dac, gen)
    init_dac_(m.tactile_dac, gen)
    m.head = plc_head_init(cfg, gen, n_layers)
    return m


def _apply_predictor(head: PLCHead, zt_in: torch.Tensor, qa_res: torch.Tensor,
                     dropout: Optional[torch.Generator] = None) -> torch.Tensor:
    """The (possibly stacked) predictor: every block cross-attends the running
    tactile estimate to the audio latents; ``dropout`` (a generator) turns
    on the blocks' train-time dropout."""
    z = head.predict(zt_in, qa_res, dropout=dropout)
    for blk in head.predict_extra:
        z = blk(z, qa_res, dropout=dropout)
    return z


def _interp_latent(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """Linear length-matching of [B, C, T] latents (align_corners=False, the
    sample positions clipped to [0, T - 1]), computed in fp32 and returned in
    x's dtype."""
    t_in = x.shape[-1]
    if t_in == t_out:
        return x
    pos = (torch.arange(t_out, dtype=torch.float32, device=x.device) + 0.5) \
        * (t_in / t_out) - 0.5
    pos = torch.clamp(pos, 0.0, t_in - 1.0)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=t_in - 1)
    w = pos - lo
    xf = x.float()
    return (xf[..., lo] * (1.0 - w) + xf[..., hi] * w).to(x.dtype)


class PLCOut(NamedTuple):
    y_hat: torch.Tensor
    tgt: torch.Tensor
    latent_mask: torch.Tensor                  # [B, 1, T_lat]
    z_pred: Optional[torch.Tensor] = None      # predictor output [B, C, T_lat]
    z_tgt: Optional[torch.Tensor] = None       # true tactile latents [B, C, T_lat]


def _receiver_view(head: PLCHead, zt_full: torch.Tensor, m: torch.Tensor,
                   mask_embed: bool) -> torch.Tensor:
    """Lost tokens zeroed; with ``mask_embed``, the head's mask token added
    there, so the predictor can tell "lost" from "zero"."""
    zt_in = zt_full * ~m
    if mask_embed:
        zt_in = zt_in + head.mask_embed.to(zt_in.dtype)[None, :, None] * m
    return zt_in


def _fin(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _conceal_latents(head: PLCHead, qa: torch.Tensor, zt: torch.Tensor, m: torch.Tensor,
                     mask_embed: bool, dropout: Optional[torch.Generator] = None):
    """(z_filled, z_pred): the predictor's tokens at the lost positions, the
    received ones elsewhere."""
    zt_in = _receiver_view(head, zt, m, mask_embed)
    z_pred = _apply_predictor(head, zt_in, _interp_latent(qa, zt.shape[-1]), dropout)
    return torch.where(m, z_pred, zt * ~m), z_pred


def _fill_and_decode(head: PLCHead, decoder: Decoder, cfg: CodecConfig, qa: torch.Tensor,
                     zt_full: torch.Tensor, tc: torch.Tensor, mask_tokens: torch.Tensor,
                     mask_embed: bool, dropout, train: bool) -> PLCOut:
    mk = mask_tokens[:, None, :]
    z_filled, z_pred = _conceal_latents(head, qa, zt_full, mk, mask_embed, dropout)
    y_hat = decoder.forward_train(z_filled, cfg.dac) if train else decoder(z_filled, cfg.dac)
    T = min(y_hat.shape[-1], tc.shape[-1])
    return PLCOut(_fin(y_hat[..., :T]), _fin(tc[..., :T]), mk, z_pred=z_pred, z_tgt=zt_full)


def _audio_latents(m: PLCModules, a: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    qa, _ = m.audio_dac.quantizer.quantize(m.audio_dac.encoder(a, cfg.dac))
    return qa


def forward_step(m: PLCModules, a: torch.Tensor, tc: torch.Tensor,
                 mask_tokens: torch.Tensor, mask_embed: bool = False,
                 cfg: Optional[CodecConfig] = None, decoder: Optional[Decoder] = None,
                 dropout: Optional[torch.Generator] = None, train: bool = False) -> PLCOut:
    """a, tc: [B, 1, T] waveforms; mask_tokens: [B, T_lat] bool (True = lost).
    Both backbones encode, the predictor fills the lost tokens, the tactile
    decoder (``decoder`` in its place when given: an inpainting decoder)
    runs; outputs cut to the common length and made finite. ``train``: see
    the module docstring."""
    cfg = cfg or m.cfg
    with torch.set_grad_enabled(train and torch.is_grad_enabled()), \
            fp32_exact(a.dtype == torch.float32):
        with torch.no_grad():
            qa, zt_full = allpred_ar.backbone_latents(m, a, tc, cfg)
        return _fill_and_decode(m.head, decoder or m.tactile_dac.decoder, cfg, qa, zt_full,
                                tc, mask_tokens, mask_embed, dropout, train)


def forward_step_latents(head: PLCHead, tactile_dac: DAC, cfg: CodecConfig,
                         qa: torch.Tensor, zt_full: torch.Tensor, tc: torch.Tensor,
                         mask_tokens: torch.Tensor, mask_embed: bool = False,
                         dropout: Optional[torch.Generator] = None,
                         train: bool = False) -> PLCOut:
    """``forward_step`` from precomputed backbone latents (no encoders)."""
    with torch.set_grad_enabled(train and torch.is_grad_enabled()), \
            fp32_exact(zt_full.dtype == torch.float32):
        return _fill_and_decode(head, tactile_dac.decoder, cfg, qa, zt_full, tc, mask_tokens,
                                mask_embed, dropout, train)


def predict_latents(head: PLCHead, cfg: CodecConfig, qa: torch.Tensor,
                    zt_full: torch.Tensor, mask_tokens: torch.Tensor,
                    mask_embed: bool = False, dropout: Optional[torch.Generator] = None,
                    train: bool = False) -> tuple:
    """Predictor only (no decode): (z_pred, latent_mask [B, 1, T_lat])."""
    with torch.set_grad_enabled(train and torch.is_grad_enabled()), \
            fp32_exact(zt_full.dtype == torch.float32):
        mk = mask_tokens[:, None, :]
        zt_in = _receiver_view(head, zt_full, mk, mask_embed)
        return _apply_predictor(head, zt_in, _interp_latent(qa, zt_full.shape[-1]),
                                dropout), mk


@torch.no_grad()
def forward_zero_fill(m: PLCModules, a: torch.Tensor, tc: torch.Tensor,
                      mask_tokens: torch.Tensor,
                      cfg: Optional[CodecConfig] = None) -> PLCOut:
    """No-concealment baseline: the receiver view decoded as it is (lost
    tokens stay zero). Only the tactile side is encoded; ``a`` is not read,
    as the JAX package's compiled program does not read it."""
    cfg = cfg or m.cfg
    with fp32_exact(tc.dtype == torch.float32):
        zt_full = m.tactile_dac.encoder(tc, cfg.dac)
        mk = mask_tokens[:, None, :]
        y0 = m.tactile_dac.decoder(zt_full * ~mk, cfg.dac)
    T = min(y0.shape[-1], tc.shape[-1])
    return PLCOut(_fin(y0[..., :T]), _fin(tc[..., :T]), mk)


@torch.no_grad()
def conceal(m: PLCModules, a: torch.Tensor, zt_received: torch.Tensor,
            mask_tokens: torch.Tensor, mask_embed: bool = False,
            cfg: Optional[CodecConfig] = None) -> torch.Tensor:
    """Serving: conceal the losses of an already-encoded tactile latent stream
    (the receiver never re-encodes; lost tokens arrive zeroed): audio [B, 1, T],
    zt_received [B, C, T_lat], mask_tokens [B, T_lat] -> tactile waveform.
    ``mask_embed`` must match the head's training condition (its meta.json)."""
    cfg = cfg or m.cfg
    with fp32_exact(a.dtype == torch.float32):
        qa = _audio_latents(m, a, cfg)
        z_filled, _ = _conceal_latents(m.head, qa, zt_received,
                                       mask_tokens[:, None, :], mask_embed)
        return m.tactile_dac.decoder(z_filled, cfg.dac)
