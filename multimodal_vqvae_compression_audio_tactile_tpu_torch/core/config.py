"""Typed configuration of the codec (own copy; the port imports no JAX module).

Mirrors ``DacConfig``, ``PredictorConfig``, ``RVQConfig``, ``CodecConfig``,
``LossConfig``, ``GanConfig``, ``TrainConfig``, ``SweepConfig``, ``PLCConfig``
and ``EvalConfig`` of the JAX package field for field, minus the fused-stack options
(``fused_resunits``, ``fused_resunits_b1``): the port always runs its
channels-first stacks through its kernel K1. The layout options keep JAX's
names and meanings: ``time_major``/``time_major_enc`` run the decoder/encoder
in ``[B, T, C]`` (``ops/timeconv.py``), ``tail_kernel`` sends every narrow
(C < 256) residual-unit stack through the time-major kernel K3, and
``poly_upsample`` runs the channels-first decoder's upsampling in polyphase
form. All four are off by default, as is ``vmap_dual_encoder`` (both
encoders in one pass, their stacks as grouped launches). ``asdict_jsonable`` and ``dump_config`` are
the JAX package's functions of those names (a run's ``meta.json`` entries).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class DacConfig:
    """DAC-class codec backbone (conv encoder / factorized RVQ / conv decoder).

    Strides (2, 4, 5, 8) give a 320x hop, i.e. 75 tokens/s at 24 kHz, into a
    1024-channel latent quantized by 32 books of 1024 8-dim codes.
    """

    sample_rate: int = 24000
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 5, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 5, 4, 2)
    latent_dim: int = 1024
    n_codebooks: int = 32
    codebook_size: int = 1024
    codebook_dim: int = 8
    # "highest": fp32 convs (parity); "default": the serving precision, bf16
    # operands with fp32 accumulation. VQ scores are fp32 either way.
    precision: str = "highest"
    # narrow (C < 256) residual-unit stacks through the time-major kernel K3
    tail_kernel: bool = False
    # the channels-first decoder's upsampling as a polyphase conv
    poly_upsample: bool = False
    # run the decoder / the encoders time-major, [B, T, C]
    time_major: bool = False
    time_major_enc: bool = False

    @property
    def hop(self) -> int:
        return math.prod(self.encoder_rates)

    @property
    def tokens_per_sec(self) -> float:
        return self.sample_rate / self.hop

    def tiny(self) -> "DacConfig":
        """A tiny CPU-testable variant keeping the 320x hop (75 tok/s)."""
        return dataclasses.replace(
            self, encoder_dim=8, decoder_dim=16, latent_dim=64,
            n_codebooks=4, codebook_size=32, codebook_dim=4)


@dataclass(frozen=True)
class PredictorConfig:
    """Single-block cross-attention predictor (eval/pre-LN wiring)."""

    dim: int = 1024
    heads: int = 8
    mlp_mul: int = 2
    precision: str = "highest"
    dropout: float = 0.1
    max_len: int = 8192


@dataclass(frozen=True)
class RVQConfig:
    """Residual VQ on the 96-dim projection of the prediction residual."""

    code_dim: int = 96
    n_books: int = 10
    n_embed: int = 128
    ema_decay: float = 0.99
    ema_warm_epochs: int = 5
    ema_mode: str = "residual"
    dead_frac: float = 0.1


@dataclass(frozen=True)
class CodecConfig:
    """The AR cross-modal residual codec (AllPredAR)."""

    dac: DacConfig = field(default_factory=DacConfig)
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    rvq: RVQConfig = field(default_factory=RVQConfig)
    ar_chunk_tok: int = 16
    scale_init: float = 0.08
    scale_min: float = 5e-3
    scale_max: float = 0.5
    # run the two frozen encoders (audio, tactile) in one pass, each stack a
    # grouped kernel launch over both weight sets (``models/dac.py::
    # dual_encode``; JAX: one vmapped call over stacked params). Off by
    # default, as in JAX.
    vmap_dual_encoder: bool = False

    def with_rvq(self, n_books: int, n_embed: int) -> "CodecConfig":
        return dataclasses.replace(
            self, rvq=dataclasses.replace(self.rvq, n_books=n_books,
                                          n_embed=n_embed))

    def tiny(self) -> "CodecConfig":
        """CPU-testable variant: tiny backbone, 16-dim codes, 4-token chunks.
        Must stay identical to the JAX package's ``CodecConfig.tiny`` so that
        its tiny checkpoints load strictly."""
        d = self.dac.tiny()
        return dataclasses.replace(
            self, dac=d,
            predictor=dataclasses.replace(self.predictor, dim=d.latent_dim),
            rvq=dataclasses.replace(self.rvq, code_dim=16),
            ar_chunk_tok=4)

    def fast_serving(self) -> "CodecConfig":
        """Serving precision: bf16 conv stacks and attention; the VQ scores
        that pick the transmitted codes stay true fp32."""
        return dataclasses.replace(
            self,
            dac=dataclasses.replace(self.dac, precision="default"),
            predictor=dataclasses.replace(self.predictor, precision="default"))

    def kbps(self, tokens_per_sec: float | None = None) -> float:
        """Nominal bitrate: tokens/s * n_books * log2(n_embed) / 1000."""
        tps = self.dac.tokens_per_sec if tokens_per_sec is None else tokens_per_sec
        return tps * self.rvq.n_books * math.log2(self.rvq.n_embed) / 1000.0


@dataclass(frozen=True)
class LossConfig:
    """Reconstruction loss weights and STFT/mel settings. The two PLC-only
    terms are 0 in the codec's loss (the reference's)."""

    w_wav_l1: float = 0.55
    w_stft: float = 0.25
    w_melcos: float = 0.20
    stft_ffts: Tuple[int, ...] = (256, 512, 1024)
    stft_hops: Tuple[int, ...] = (64, 128, 256)
    mel_nfft: int = 512
    mel_hop: int = 128
    mel_mels: int = 64
    eps: float = 1e-7
    w_plc_latent: float = 0.0
    w_plc_masked: float = 0.0


@dataclass(frozen=True)
class GanConfig:
    """Adversarial backbone pretraining (``losses/gan.py``): multi-period
    discriminators over ``periods``, multi-scale STFT discriminators over
    ``fft_sizes``, hinge (or ``"lsgan"``) adversarial loss at ``w_adv`` and
    relative L1 feature matching at ``w_fm``; the discriminators' own AdamW at
    ``disc_lr`` with betas (``disc_b1``, ``disc_b2``). Epochs before
    ``start_epoch`` train the reconstruction alone."""

    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    fft_sizes: Tuple[int, ...] = (256, 512, 1024)
    loss_kind: str = "hinge"
    w_adv: float = 0.1
    w_fm: float = 0.5
    disc_lr: float = 1e-4
    disc_b1: float = 0.8
    disc_b2: float = 0.99
    start_epoch: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """Training loop hyperparameters: AdamW at ``lr`` with decoupled weight
    decay, per-epoch cosine anneal to ``lr_min_frac * lr``, global-norm clip,
    ``best`` checkpoints only after ``best_after_epoch``."""

    target_sr: int = 24000
    seg_sec: float = 1.0
    batch: int = 6
    epochs: int = 100
    lr: float = 2e-4
    weight_decay: float = 1e-5
    grad_clip: float = 3.0
    seed: int = 7
    val_frac: float = 0.2
    max_val: int = 300
    lr_min_frac: float = 0.1
    best_after_epoch: int = 6
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    loss: LossConfig = field(default_factory=LossConfig)

    @property
    def seg(self) -> int:
        return int(self.seg_sec * self.target_sr)


@dataclass(frozen=True)
class SweepConfig:
    """Grid sweep over RVQ shapes: every (books, embed) pair of the grids."""

    books_grid: Tuple[int, ...] = (1, 2, 3, 4, 6, 8)
    embed_grid: Tuple[int, ...] = (128, 256, 512)


@dataclass(frozen=True)
class PLCConfig:
    """Packet-loss concealment workload: uniform packets of ``packet_tok``
    tokens each lost with ``packet_loss_prob``, or the low/medium/high burst
    categories. ``mask_embed`` adds the head's learned mask token at lost
    positions; ``n_layers`` stacks cross-attention blocks (the first under
    ``predict``, the others under ``predict_extra``)."""

    packet_tok: int = 2
    packet_loss_prob: float = 0.5
    epochs: int = 50
    mask_embed: bool = False
    n_layers: int = 1
    cat_probs: Tuple[float, float, float] = (0.52, 0.32, 0.16)  # low/medium/high
    cat_burst_ms: Tuple[Tuple[float, float], ...] = (
        (20.0, 120.0), (120.0, 320.0), (320.0, 1000.0))
    cat_n_bursts: Tuple[Tuple[int, int], ...] = ((1, 2), (1, 3), (1, 4))


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation harness constants."""

    eval_sr: int = 24000
    orig_tactile_sr: int = 3000
    max_align_shift: int = 200
    pcm_kbps_baseline: float = 48.0       # 3 kHz * 16-bit mono
    dac_nq_list: Tuple[int, ...] = (1, 2, 3, 4, 8)
    vc_b_list: Tuple[int, ...] = (8, 12, 16, 20, 24, 48)
    vc_fs_std_hz: float = 2800.0
    vc_block_len: int = 512
    latency_warmup: int = 3
    latency_repeats: int = 10

    @property
    def vc_buffer_ms(self) -> float:
        return 1000.0 * self.vc_block_len / self.vc_fs_std_hz


def asdict_jsonable(cfg: Any) -> dict:
    """A config dataclass as nested dicts with its tuples as lists (what
    ``json.dump`` writes), as the JAX package's function of that name."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return x

    return conv(dataclasses.asdict(cfg))


def dump_config(cfg: Any, path: str) -> None:
    """Write ``asdict_jsonable(cfg)`` to ``path`` as indented JSON, as the
    JAX package's function of that name."""
    with open(path, "w") as f:
        json.dump(asdict_jsonable(cfg), f, indent=2)
