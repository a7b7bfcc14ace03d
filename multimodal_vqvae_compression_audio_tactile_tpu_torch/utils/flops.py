"""Closed-form FLOP counts of the codec's programs, from the config alone.

Own copy of the JAX package's ``utils/flops.py`` (the same functions and
numbers; that module imports no JAX, but the port imports nothing of the
JAX package). The configs are duck-typed: the port's ``core/config.py``
classes serve, as the JAX package's do.

Counting convention: 1 multiply-accumulate = 2 FLOPs; a convolution's FLOPs
= 2 * T_positions * K * C_in * C_out (dense, the same padding counted at
full length). Elementwise work (the snakes, the residual adds) is not
counted: it is under 1% of any stack here. Geometry: ``models/dac.py``
(encoder blocks = 3 residual units + a down conv k=2r stride r doubling the
channels from ``encoder_dim``; decoder blocks = an up conv k=2r stride r
halving them from ``decoder_dim`` + 3 residual units; a residual unit = a
k7 dilated conv + a k1 conv at constant width).
"""

from __future__ import annotations

from typing import Dict, Optional

MAC = 2  # FLOPs per multiply-accumulate


def conv_flops(t_positions: int, k: int, c_in: int, c_out: int) -> float:
    """Dense conv / matmul FLOPs at ``t_positions`` output (or input for
    transposed convs) time steps."""
    return float(MAC * t_positions * k * c_in * c_out)


def resunit_flops(t: int, c: int) -> float:
    """One residual unit at width ``c``: k7 dilated conv + k1 conv."""
    return conv_flops(t, 7, c, c) + conv_flops(t, 1, c, c)


def resunit_stack_flops(t: int, c: int, n_units: int = 3) -> float:
    return n_units * resunit_flops(t, c)


def encoder_flops(cfg, t_samples: int) -> Dict[str, float]:
    """Per-stage FLOPs of one DAC encoder on a ``t_samples``-sample signal.

    Returns {"in_conv", "block{i}_units", "block{i}_down", "out_conv",
    "total"}. Down conv k=2r stride r: T_in input positions contribute to
    T_in/r outputs with 2r taps each -> 2 * (T_in/r) * 2r * C_in * C_out.
    """
    out: Dict[str, float] = {}
    d, t = cfg.encoder_dim, t_samples
    out["in_conv"] = conv_flops(t, 7, 1, d)
    for i, r in enumerate(cfg.encoder_rates):
        out[f"block{i}_units"] = resunit_stack_flops(t, d)
        out[f"block{i}_down"] = conv_flops(t // r, 2 * r, d, 2 * d)
        d, t = 2 * d, t // r
    out["out_conv"] = conv_flops(t, 3, d, cfg.latent_dim)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def decoder_flops(cfg, t_tokens: int) -> Dict[str, float]:
    """Per-stage FLOPs of the DAC decoder on ``t_tokens`` latent steps.

    Transposed up conv k=2r stride r: every input position touches 2r taps
    across C_in x C_out/... -> 2 * T_in * 2r * C_in * C_out.
    """
    out: Dict[str, float] = {}
    d, t = cfg.decoder_dim, t_tokens
    out["in_conv"] = conv_flops(t, 7, cfg.latent_dim, d)
    for i, r in enumerate(cfg.decoder_rates):
        out[f"block{i}_up"] = conv_flops(t, 2 * r, d, d // 2)
        d, t = d // 2, t * r
        out[f"block{i}_units"] = resunit_stack_flops(t, d)
    out["out_conv"] = conv_flops(t, 7, d, 1)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def quantizer_flops(cfg, t_tokens: int, n_books: Optional[int] = None) -> float:
    """Factorized RVQ encode: per book, in_proj (C->cd), K-way scores
    (cd x K), out_proj (cd->C)."""
    n = n_books if n_books is not None else cfg.n_codebooks
    C, cd, K = cfg.latent_dim, cfg.codebook_dim, cfg.codebook_size
    per_book = (conv_flops(t_tokens, 1, C, cd)
                + conv_flops(t_tokens, 1, cd, K)
                + conv_flops(t_tokens, 1, cd, C))
    return n * per_book


def codec_decode_flops(cfg, t_samples: int, batch: int = 1) -> float:
    """Full codec decode program (dequantize + decoder) per batch call."""
    hop = 1
    for r in cfg.dac.encoder_rates:
        hop *= r
    t_tok = t_samples // hop
    dec = decoder_flops(cfg.dac, t_tok)["total"]
    # dequantize: out_proj per used book
    deq = cfg.rvq.n_books * conv_flops(t_tok, 1, cfg.dac.codebook_dim,
                                       cfg.dac.latent_dim)
    return batch * (dec + deq)


def codec_encode_front_flops(cfg, t_samples: int, batch: int = 1) -> float:
    """The two modality DAC encoder front-ends (audio + tactile) per call —
    the dominant part of codec encode; the AR roll adds the cross-attention
    + head RVQ work on 75-token sequences (small next to the front-ends)."""
    enc = encoder_flops(cfg.dac, t_samples)["total"]
    return batch * 2 * enc
