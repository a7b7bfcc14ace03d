"""DAC-class codec backbone: conv encoder, factorized cosine RVQ, conv decoder.

Port of the JAX package's ``models/dac.py``. Parameters are fp32; every conv
casts its weight to the input's dtype, so the same modules serve the fp32
parity mode and the bf16 serving mode. Two layouts, chosen per call by the
``DacConfig`` passed to ``Encoder.forward``/``Decoder.forward`` (the module's
own config when none is passed), with the JAX package's flags and guards:

- channels-first ``[B, C, T]`` (the default): every residual-unit stack goes
  through ``ops.resunit.resunit_stack`` (the CUDA kernel K1 on the card);
  with ``poly_upsample`` the decoder upsamples in polyphase form
  (``conv1d_transpose_poly``);
- time-major ``[B, T, C]`` (``time_major_enc`` for the encoder, when the
  down-convs are k = 2r and T is a multiple of the hop; ``time_major`` for
  the decoder, when the up-convs are k = 2r): the convs of ``ops/timeconv.py``,
  and every stack through the time-major chain of residual units.

With ``tail_kernel`` every narrow stack (C < 256) goes through
``ops.resunit_tm.resunit_stack_tm`` (the CUDA kernel K3 on the card) in
either layout, between transposes in the channels-first one. A block's
trailing snake runs fused into its stack.

``Decoder.forward_train`` and ``Encoder.forward_train`` are the
differentiable decode and encode of training: channels-first, every stack
through the plain version ``resunit_stack_ref`` (the kernels have no
backward, and the JAX package's training keeps its XLA path too).
``Quantizer.quantize_train`` is the quantize of backbone pretraining, with
its losses and quantizer dropout, and ``quantizer_dead_code_reinit`` its
dead-code reseeding.

``dual_encode`` runs two encoders (audio and tactile) in one pass,
``CodecConfig.vmap_dual_encoder``: one grouped K1 (or K3) launch sequence
over both encoders' stacks, bit-equal to the sequential encoders.

``encode``, ``decode`` and ``encode_quantized`` are the JAX package's
functional entry points over one backbone (its ``dac.encode``,
``dac.decode`` and ``dac.encode_quantized``): they compute in the input's
dtype, in true fp32 (no TF32) when that is fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import DacConfig
from ..core.precision import fp32_exact
from ..ops import timeconv as tc
from ..ops.resunit import DILATIONS, ResUnit, Snake, resunit_stack, resunit_stack_ref
from ..ops.resunit_tm import resunit_stack_tm
from ..ops.rvq import _segment_sum, take_rows, track_counts_and_reinit
from ..parallel.mesh import batch_mean

NARROW = 256     # stacks narrower than this take K3 under ``tail_kernel``


def conv1d(m: nn.Conv1d, x: torch.Tensor, stride: int = 1, dilation: int = 1,
           padding: int = 0) -> torch.Tensor:
    return F.conv1d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), stride=stride,
                    padding=padding, dilation=dilation)


def conv1d_transpose(m: nn.ConvTranspose1d, x: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """ConvTranspose1d(k=2r, stride=r, padding=ceil(r/2), output_padding=r%2):
    output length exactly T * r (the JAX ``conv1d_transpose`` geometry)."""
    return F.conv_transpose1d(x, m.weight.to(x.dtype), m.bias.to(x.dtype),
                              stride=stride, padding=(stride + 1) // 2,
                              output_padding=stride % 2)


def conv1d_transpose_poly(m: nn.ConvTranspose1d, x: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """Polyphase form of ``conv1d_transpose`` for k = 2r: every output sample
    t0 * r + j is x[t0 - 1] . w[:, :, j + r] + x[t0] . w[:, :, j], so the op is
    one stride-1 k=2 conv to r * C_out channels, a depth-to-space reshape and
    the same torch crop."""
    c_in, c_out, k = m.weight.shape
    r = stride
    if k != 2 * r:
        raise ValueError(f"poly upsample requires k == 2*stride, got {k}, {r}")
    pad, op = (r + 1) // 2, r % 2
    B, _, T = x.shape
    wt = m.weight.to(x.dtype).permute(2, 1, 0)        # [2r, C_out, C_in]
    # tap order: ker[..., 0] multiplies x[t0 - 1], ker[..., 1] multiplies x[t0]
    ker = torch.stack([wt[r:], wt[:r]], dim=-1).reshape(r * c_out, c_in, 2)
    y = F.conv1d(x, ker, padding=1)                    # [B, r * C_out, T + 1]
    y = y.reshape(B, r, c_out, T + 1).permute(0, 2, 3, 1).reshape(B, c_out, (T + 1) * r)
    y = y[:, :, pad:(T + 1) * r - (pad - op)]          # torch crop -> T * r
    return y + m.bias.to(x.dtype)[None, :, None]


def _units(c: int) -> nn.ModuleList:
    return nn.ModuleList(ResUnit(c) for _ in DILATIONS)


def _unit_stack(units, y: torch.Tensor, cfg: DacConfig,
                post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channels-first stack: K3 between transposes for a narrow stack under
    ``tail_kernel``, K1 otherwise. ``units`` is one stack or G of them
    (``ops/resunit.py::resunit_stack``), y's rows b G + g going through
    stack g."""
    if cfg.tail_kernel and y.shape[1] < NARROW:
        yt = resunit_stack_tm(units, y.transpose(1, 2).contiguous(), DILATIONS, post_alpha)
        return yt.transpose(1, 2).contiguous()
    return resunit_stack(units, y, DILATIONS, post_alpha=post_alpha)


def _unit_stack_tm(units: Sequence[ResUnit], y: torch.Tensor, cfg: DacConfig,
                   post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Time-major stack: K3 for a narrow stack under ``tail_kernel``, the
    chain of ``timeconv.resunit_tm`` otherwise (as the JAX package does)."""
    if cfg.tail_kernel and y.shape[2] < NARROW:
        return resunit_stack_tm(units, y, DILATIONS[:len(units)], post_alpha)
    for u, d in zip(units, DILATIONS):
        y = tc.resunit_tm(u, y, d)
    return y if post_alpha is None else tc.snake_tm(post_alpha, y)


class EncoderBlock(nn.Module):
    def __init__(self, d: int, r: int):
        super().__init__()
        self.r = r
        self.units = _units(d)
        self.snake = Snake(d)
        self.down = nn.Conv1d(d, 2 * d, 2 * r)

    def forward(self, x: torch.Tensor, cfg: DacConfig, stack=None) -> torch.Tensor:
        """``stack`` (default: ``_unit_stack``'s choice of kernel) runs the
        residual units."""
        if stack is not None:
            x = stack(self.units, x, DILATIONS, post_alpha=self.snake.alpha)
        else:
            x = _unit_stack(self.units, x, cfg, post_alpha=self.snake.alpha)
        # kernel 2r, stride r, symmetric padding ceil(r/2): length T / r
        return conv1d(self.down, x, stride=self.r, padding=(self.r + 1) // 2)

    def forward_tm(self, x: torch.Tensor, cfg: DacConfig) -> torch.Tensor:
        x = _unit_stack_tm(self.units, x, cfg, post_alpha=self.snake.alpha)
        return tc.down_tm(self.down, x, self.r)


class Encoder(nn.Module):
    """x [B, 1, T] -> latent z [B, latent_dim, T / hop]."""

    def __init__(self, cfg: DacConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_dim
        self.in_conv = nn.Conv1d(1, d, 7)
        blocks = []
        for r in cfg.encoder_rates:
            blocks.append(EncoderBlock(d, r))
            d *= 2
        self.blocks = nn.ModuleList(blocks)
        self.out_snake = Snake(d)
        self.out_conv = nn.Conv1d(d, cfg.latent_dim, 3)

    def time_major_ok(self, x: torch.Tensor) -> bool:
        """The time-major encoder's geometry: k = 2r down-convs and a length
        that every stride divides."""
        hop = math.prod(b.r for b in self.blocks)
        return x.shape[-1] % hop == 0 and all(
            b.down.weight.shape[-1] == 2 * b.r for b in self.blocks)

    def forward(self, x: torch.Tensor, cfg: Optional[DacConfig] = None,
                stack=None) -> torch.Tensor:
        """``stack`` (default: the layout and kernel ``cfg`` picks) runs every
        block's residual units, channels-first."""
        cfg = cfg or self.cfg
        if stack is None and cfg.time_major_enc and self.time_major_ok(x):
            return self.forward_tm(x, cfg)
        y = conv1d(self.in_conv, x, padding=3)
        for block in self.blocks:
            y = block(y, cfg, stack=stack)
        return conv1d(self.out_conv, self.out_snake(y), padding=1)

    def forward_train(self, x: torch.Tensor, cfg: Optional[DacConfig] = None) -> torch.Tensor:
        """The training encode, differentiable: channels-first, every stack
        through ``resunit_stack_ref``. The time-major layout and
        ``tail_kernel`` are serving options, refused here."""
        cfg = cfg or self.cfg
        if cfg.time_major_enc or cfg.tail_kernel:
            raise ValueError("forward_train runs the channels-first encoder: "
                             "time_major_enc and tail_kernel are serving options")
        return self(x, cfg, stack=resunit_stack_ref)

    def forward_tm(self, x: torch.Tensor, cfg: DacConfig) -> torch.Tensor:
        y = tc.conv_tm(self.in_conv, x.transpose(1, 2))         # [B, T, C]
        for block in self.blocks:
            y = block.forward_tm(y, cfg)
        y = tc.conv_tm(self.out_conv, tc.snake_tm(self.out_snake.alpha, y))
        return y.transpose(1, 2)                                 # [B, C_lat, T / hop]


def dual_encode(enc_a: Encoder, enc_t: Encoder, a: torch.Tensor, tc: torch.Tensor,
                cfg: Optional[DacConfig] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both encoders in one pass -> (z_a, z_t), each [B, latent_dim, T /
    hop]: ``CodecConfig.vmap_dual_encoder``, where the JAX package vmaps its
    channels-first ``_encoder_apply`` over the two encoders' stacked
    parameters. Each residual-unit stack is one grouped K1 launch sequence
    (K3 for a narrow stack under ``tail_kernel``) over both encoders' units,
    the activations side by side as [B, 2, C, T] (rows b 2 + g, encoder g),
    the block snakes' alphas concatenated; each convolution outside the
    stacks runs on its own encoder's half, as the sequential path runs it,
    so the result is the sequential path's bit for bit and so are the codes
    (on the H100, one ``groups=2`` cuDNN convolution over concatenated
    weights summed in another order, which changed trained codes at batch
    32, and ran 3.6x slower in fp32 there). Always channels-first, whatever
    ``time_major_enc`` says, as the JAX package's vmapped path is. Serving
    only: a call that autograd would record raises."""
    cfg = cfg or enc_a.cfg
    if torch.is_grad_enabled() and any(t.requires_grad for t in (
            a, tc, *enc_a.parameters(), *enc_t.parameters())):
        raise RuntimeError("dual_encode: the grouped encoder is a serving path with no "
                           "backward; run it under torch.no_grad()")
    encs = (enc_a, enc_t)
    ys = [conv1d(e.in_conv, x, padding=3) for e, x in zip(encs, (a, tc))]
    for blocks in zip(enc_a.blocks, enc_t.blocks):
        y = torch.stack(ys, dim=1)                          # [B, 2, C, T]
        B, _, C, T = y.shape
        post = torch.cat([b.snake.alpha for b in blocks])
        y = _unit_stack([b.units for b in blocks], y.view(2 * B, C, T), cfg,
                        post_alpha=post).view(B, 2, C, T)
        ys = [conv1d(b.down, y[:, g].contiguous(), stride=b.r, padding=(b.r + 1) // 2)
              for g, b in enumerate(blocks)]
    za, zt = (conv1d(e.out_conv, e.out_snake(y), padding=1) for e, y in zip(encs, ys))
    return za, zt


class DecoderBlock(nn.Module):
    def __init__(self, d: int, r: int):
        super().__init__()
        self.r = r
        self.snake = Snake(d)
        self.up = nn.ConvTranspose1d(d, d // 2, 2 * r)
        self.units = _units(d // 2)

    def forward(self, x: torch.Tensor, cfg: DacConfig,
                post_alpha: Optional[torch.Tensor] = None, stack=None) -> torch.Tensor:
        """``stack`` (default: ``_unit_stack``'s choice of kernel) runs the
        residual units."""
        # per-block geometry guard: the polyphase form needs k = 2r
        poly = cfg.poly_upsample and self.up.weight.shape[-1] == 2 * self.r
        up = conv1d_transpose_poly if poly else conv1d_transpose
        x = up(self.up, self.snake(x), self.r)
        if stack is not None:
            return stack(self.units, x, DILATIONS, post_alpha=post_alpha)
        return _unit_stack(self.units, x, cfg, post_alpha=post_alpha)

    def forward_tm(self, x: torch.Tensor, cfg: DacConfig,
                   post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = tc.up_tm(self.up, tc.snake_tm(self.snake.alpha, x), self.r)
        return _unit_stack_tm(self.units, x, cfg, post_alpha=post_alpha)


class Decoder(nn.Module):
    """z [B, latent_dim, T] -> waveform [B, 1, T * hop] in (-1, 1)."""

    def __init__(self, cfg: DacConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.decoder_dim
        self.in_conv = nn.Conv1d(cfg.latent_dim, d, 7)
        blocks = []
        for r in cfg.decoder_rates:
            blocks.append(DecoderBlock(d, r))
            d //= 2
        self.blocks = nn.ModuleList(blocks)
        self.out_snake = Snake(d)
        self.out_conv = nn.Conv1d(d, 1, 7)

    def poly_geometry_ok(self) -> bool:
        """Every up-conv is k = 2r, as the time-major decoder needs."""
        return all(b.up.weight.shape[-1] == 2 * b.r for b in self.blocks)

    def _posts(self):
        # the trailing out_snake runs fused into the last block's stack
        last = len(self.blocks) - 1
        return [self.out_snake.alpha if i == last else None
                for i in range(len(self.blocks))]

    def forward(self, z: torch.Tensor, cfg: Optional[DacConfig] = None,
                stack=None) -> torch.Tensor:
        """``stack`` (default: the layout and kernel ``cfg`` picks) runs every
        block's residual units, channels-first."""
        cfg = cfg or self.cfg
        if stack is None and cfg.time_major and self.poly_geometry_ok():
            return self.forward_tm(z, cfg)
        y = conv1d(self.in_conv, z, padding=3)
        for block, post in zip(self.blocks, self._posts()):
            y = block(y, cfg, post_alpha=post, stack=stack)
        return torch.tanh(conv1d(self.out_conv, y, padding=3))

    def forward_tm(self, z: torch.Tensor, cfg: DacConfig) -> torch.Tensor:
        y = tc.conv_tm(self.in_conv, z.transpose(1, 2))         # [B, T, C]
        for block, post in zip(self.blocks, self._posts()):
            y = block.forward_tm(y, cfg, post_alpha=post)
        return torch.tanh(tc.conv_tm(self.out_conv, y)).transpose(1, 2)

    def forward_train(self, z: torch.Tensor, cfg: Optional[DacConfig] = None) -> torch.Tensor:
        """The training decode, differentiable: channels-first, every stack
        through ``resunit_stack_ref``. The time-major layouts and
        ``tail_kernel`` are serving options, refused here."""
        cfg = cfg or self.cfg
        if cfg.time_major or cfg.tail_kernel:
            raise ValueError("forward_train runs the channels-first decoder: "
                             "time_major and tail_kernel are serving options")
        return self(z, cfg, stack=resunit_stack_ref)


def _l2n(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


class Quantizer(nn.Module):
    """Residual VQ over factorized, L2-normalized codebooks (cosine argmax).
    Parameters keep the JAX layout: in_proj [n, C, cd], in_bias [n, cd],
    out_proj [n, cd, C], out_bias [n, C], codebooks [n, K, cd]."""

    def __init__(self, cfg: DacConfig):
        super().__init__()
        n, K, cd, C = (cfg.n_codebooks, cfg.codebook_size, cfg.codebook_dim,
                       cfg.latent_dim)
        self.in_proj = nn.Parameter(torch.empty(n, C, cd))
        self.in_bias = nn.Parameter(torch.zeros(n, cd))
        self.out_proj = nn.Parameter(torch.empty(n, cd, C))
        self.out_bias = nn.Parameter(torch.zeros(n, C))
        self.codebooks = nn.Parameter(torch.empty(n, K, cd))

    def quantize(self, z: torch.Tensor, n_quantizers: Optional[int] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z [B, C, T] -> (z_q [B, C, T] in z's dtype, codes [B, T, n_use]).
        All of it in true fp32: the codes are what is transmitted."""
        n_books = self.codebooks.shape[0]
        use = n_books if n_quantizers is None else min(n_quantizers, n_books)
        B, C, T = z.shape
        x = z.transpose(1, 2).reshape(B * T, C).float()
        residual, zq, idxs = x, torch.zeros_like(x), []
        for i in range(use):
            e = residual @ self.in_proj[i] + self.in_bias[i]            # [N, cd]
            cb = self.codebooks[i]
            idx = torch.argmax(_l2n(e) @ _l2n(cb).T, dim=1)
            q = e + (cb[idx] - e)       # the JAX straight-through value, as computed
            z_b = q @ self.out_proj[i] + self.out_bias[i]               # [N, C]
            residual = residual - z_b
            zq = zq + z_b
            idxs.append(idx)
        zq = zq.reshape(B, T, C).transpose(1, 2).to(z.dtype)
        codes = torch.stack(idxs, dim=1).reshape(B, T, use).to(torch.int32)
        return zq, codes

    def quantize_train(self, z: torch.Tensor, nq_per_example: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The training quantize: z [B, C, T] -> (z_q [B, C, T] in z's dtype,
        codes [B, T, n] int32, commitment loss, codebook loss), through every
        book, with the JAX package's stop-gradient pairings: the commitment
        loss trains the projection, the codebook loss the books, the
        straight-through ``e + sg(q - e)`` carries z_q's gradient to the
        encoder, and the residual chain subtracts each book's output without
        a gradient. ``nq_per_example`` [B] (quantizer dropout): example b's
        z_q sums only its first ``nq_per_example[b]`` books, and both losses
        count only those (example, book) pairs, renormalised by their share.
        Inside ``parallel/mesh.py::batch_scope`` both losses and the share are
        the global batch's.
        The values equal ``quantize``'s; ``quantize`` itself stays the
        serving path, which autograd must not train."""
        n_books = self.codebooks.shape[0]
        B, C, T = z.shape
        x = z.transpose(1, 2).reshape(B * T, C).float()
        w_tok = None if nq_per_example is None else \
            nq_per_example.repeat_interleave(T).float()
        residual, zq, idxs = x, torch.zeros_like(x), []
        commit = codebk = x.new_zeros(())
        for i in range(n_books):
            e = residual @ self.in_proj[i] + self.in_bias[i]            # [N, cd]
            cb = self.codebooks[i]
            idx = torch.argmax(_l2n(e.detach()) @ _l2n(cb.detach()).T, dim=1)
            q_cd = take_rows(cb, idx)       # the books' gradient, in a fixed order
            if w_tok is None:
                active, frac = 1.0, 1.0
            else:
                hit = (i < w_tok).float()
                active, frac = hit[:, None], batch_mean(hit.mean()) + 1e-9
            commit = commit + batch_mean(torch.mean(active * (e - q_cd.detach()) ** 2)) / frac
            codebk = codebk + batch_mean(torch.mean(active * (e.detach() - q_cd) ** 2)) / frac
            z_b = (e + (q_cd - e).detach()) @ self.out_proj[i] + self.out_bias[i]
            residual = residual - z_b.detach()
            zq = zq + active * z_b
            idxs.append(idx)
        zq = zq.reshape(B, T, C).transpose(1, 2).to(z.dtype)
        codes = torch.stack(idxs, dim=1).reshape(B, T, n_books).to(torch.int32)
        return zq, codes, commit, codebk

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, n_use] -> z_q [B, C, T] (fp32)."""
        n_use = codes.shape[-1]
        q = torch.stack([self.codebooks[i][codes[..., i].long()]
                         for i in range(n_use)], dim=2)                 # [B,T,n,cd]
        z = torch.einsum("btnd,ndc->btc", q, self.out_proj[:n_use])
        z = z + self.out_bias[:n_use].sum(0)
        return z.transpose(1, 2)


class DAC(nn.Module):
    def __init__(self, cfg: DacConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantizer = Quantizer(cfg)


@torch.no_grad()
def quantizer_dead_code_reinit(q: Quantizer, counts: torch.Tensor, z: torch.Tensor,
                               gen: Optional[torch.Generator], decay: float = 0.99,
                               dead_frac: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """EMA usage tracking and dead-code reseeding of the backbone RVQ ->
    (codebooks [n, K, cd], counts [n, K]), the JAX package's
    ``quantizer_dead_code_reinit``. ``q`` holds the books after this step's
    update, ``z`` [B, C, T] the step's latents (before the update). Each
    book's EMA cluster sizes and reseeds go through ``ops/rvq.py::
    track_counts_and_reinit`` on that book's factorized features of the
    batch (all-zero counts adopt the batch's counts), drawing from ``gen``
    book by book; the residual chain advances with the codes picked before
    the reseed. ``gen`` cannot reproduce the JAX package's threefry draws:
    the reseeded codes are the same, their new values are not."""
    n_books, K, _ = q.codebooks.shape
    B, C, T = z.shape
    residual = z.detach().transpose(1, 2).reshape(B * T, C).float()
    N = B * T
    ones = residual.new_ones(N)
    books, new_counts = [], []
    for i in range(n_books):
        e = residual @ q.in_proj[i] + q.in_bias[i]
        cb = q.codebooks[i]
        idx = torch.argmax(_l2n(e) @ _l2n(cb).T, dim=1)
        batch_counts = _segment_sum(ones, idx, K)
        b, c = track_counts_and_reinit(cb, counts[i], e, batch_counts, gen, decay=decay,
                                       dead_frac=dead_frac, uniform_share=N / K)
        books.append(b)
        new_counts.append(c)
        residual = residual - (cb[idx] @ q.out_proj[i] + q.out_bias[i])
    return torch.stack(books), torch.stack(new_counts)


@torch.no_grad()
def init_dac_(m: DAC, gen: torch.Generator) -> DAC:
    """Random init with the JAX package's distributions (``dac_init``):
    convs U(+-1/sqrt(c_in k)), snakes 1, quantizer projections
    U(+-1/sqrt(fan)), zero quantizer biases, N(0, 1) codebooks."""
    for mod in m.modules():
        if isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d)):
            c_in = (mod.weight.shape[0] if isinstance(mod, nn.ConvTranspose1d)
                    else mod.weight.shape[1])
            bound = 1.0 / math.sqrt(c_in * mod.weight.shape[-1])
            for p in (mod.weight, mod.bias):
                p.uniform_(-bound, bound, generator=gen)
        elif isinstance(mod, Snake):
            mod.alpha.fill_(1.0)
    q = m.quantizer
    C, cd = q.in_proj.shape[1], q.in_proj.shape[2]
    q.in_proj.uniform_(-1 / math.sqrt(C), 1 / math.sqrt(C), generator=gen)
    q.out_proj.uniform_(-1 / math.sqrt(cd), 1 / math.sqrt(cd), generator=gen)
    q.in_bias.zero_()
    q.out_bias.zero_()
    q.codebooks.normal_(generator=gen)
    return m


@torch.no_grad()
def encode(m: DAC, cfg: DacConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, 1, T] -> continuous latent z [B, latent_dim, T / hop], in x's dtype."""
    with fp32_exact(x.dtype == torch.float32):
        return m.encoder(x, cfg)


@torch.no_grad()
def decode(m: DAC, cfg: DacConfig, z: torch.Tensor) -> torch.Tensor:
    """z [B, latent_dim, T] -> waveform [B, 1, T * hop], in z's dtype."""
    with fp32_exact(z.dtype == torch.float32):
        return m.decoder(z, cfg)


@torch.no_grad()
def encode_quantized(m: DAC, cfg: DacConfig, x: torch.Tensor,
                     n_quantizers: Optional[int] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, 1, T] -> (z_q [B, latent_dim, T / hop] in x's dtype, codes
    [B, T / hop, n_use] int32) through the first ``n_quantizers`` books (all
    when None). The JAX function also returns the training losses, which
    the serving half leaves out."""
    with fp32_exact(x.dtype == torch.float32):
        return m.quantizer.quantize(m.encoder(x, cfg), n_quantizers)
