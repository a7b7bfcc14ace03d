"""Two-pass parallel AR roll: the serving rewrite of the chunked roll.

Port of the JAX package's ``models/ar_parallel.py``. The roll of
``models/allpred_ar.py`` runs its chunks one after another, each carrying its
last reconstructed token into the next chunk's query row 0. That token never
depends on the carry: the carry enters only query row 0, attention mixes keys
(not query rows) into each row, and everything after attention is token-wise.
So for ``chunk >= 2`` every carry can be computed at once, and the roll runs
as two batched passes over all chunks:

1. carry pass: query row ``chunk-1`` (whose query, LN(PE[chunk-1]) @ Wq, is a
   constant) through attention, FFN and the token-wise tail for every chunk;
   shifted one chunk right, its tokens are the carries;
2. output pass: all rows of every chunk, the carries in query row 0.

K and V are projected once and shared by both passes; query rows
``1..chunk-1`` are constants shared by every chunk. The head RVQ is
``ops/rvq.py::rvq_quantize``, as in the scan (and as in the JAX package,
whose parallel roll does not use the fused lookup). ``chunk < 2`` falls back
to the scan, where the carry is the only row.

Every row is computed by the same operations as in the scan, on larger
products; the codes equal the scan's where no score sits within rounding of
a tie (``tests/test_torch_ar_parallel.py``). Plain PyTorch: no kernel of its
own, as in the JAX package, where the roll runs outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import CodecConfig
from ..core.precision import fp32_exact
from ..nn.layers import layer_norm, linear, token_norm
from ..ops.rvq import rvq_decode, rvq_quantize
from .allpred_ar import (ARRollOut, CodecModules, Head, _chunks, _proj, ar_roll,
                         backbone_latents, decode_from_codes)

# tail(z_pred [B * n, C, t], rows of each chunk) -> (z_hat [B * n, C, t], extra)
Tail = Callable[[torch.Tensor, slice], Tuple[torch.Tensor, object]]


def _attend(Q: torch.Tensor, K: torch.Tensor, V: torch.Tensor, heads: int,
            kv_valid: torch.Tensor) -> torch.Tensor:
    """Q [B, n, Tq, C], K/V [B, n, Tk, C], kv_valid [n, Tk] -> [B, n, Tq, C],
    with ``CrossPredictor``'s mask and softmax."""
    dh = Q.shape[-1] // heads

    def split(x):                         # [B, n, T, C] -> [B, n, h, T, dh]
        return x.reshape(*x.shape[:-1], heads, dh).transpose(-2, -3)

    attn = torch.matmul(split(Q), split(K).transpose(-1, -2)) / math.sqrt(dh)
    attn = attn.masked_fill(~kv_valid[None, :, None, None, :],
                            torch.finfo(attn.dtype).min)
    attn = torch.softmax(attn.float(), dim=-1).to(Q.dtype)
    ctx = torch.matmul(attn, split(V))
    return ctx.transpose(-2, -3).reshape(Q.shape)


def _ffn(P, y: torch.Tensor) -> torch.Tensor:
    return y + linear(P.ffn_out, F.gelu(linear(P.ffn_in, layer_norm(P.ffn_ln, y))))


def _two_pass(head: Head, cfg: CodecConfig, qa: torch.Tensor, T: int,
              tail: Tail) -> Tuple[torch.Tensor, object]:
    """Both passes over the first T tokens of qa [B, C, >= T] -> (z_hat
    [B * n, C, chunk], the output pass's ``extra``); the padded tail of the
    last chunk is masked out of the keys."""
    P, chunk = head.predict, cfg.ar_chunk_tok
    n, Tp = _chunks(T, chunk)
    qa_p = F.pad(qa[..., :T], (0, Tp - T))
    B, C, _ = qa_p.shape
    dtype = qa_p.dtype
    valid = (torch.arange(Tp, device=qa_p.device) < T).reshape(n, chunk)
    pe = P.pe[:chunk].to(dtype)
    kv = layer_norm(P.ln_kv, qa_p.reshape(B, C, n, chunk).permute(0, 2, 3, 1) + pe)
    K, V = linear(P.k_proj, kv), linear(P.v_proj, kv)            # [B, n, chunk, C]
    q_const = layer_norm(P.ln_q, pe)                             # row t: LN(PE[t])
    Q_const = linear(P.q_proj, q_const)
    heads = P.cfg.heads

    def predict(Q, q_rows):
        y = linear(P.out, _attend(Q, K, V, heads, valid)) + q_rows
        z_pred = _ffn(P, y)                                      # [B, n, t, C]
        return z_pred.reshape(B * n, -1, C).transpose(1, 2)      # [B * n, C, t]

    # pass 1: row chunk-1 of every chunk, shifted one chunk right = the carries
    last = predict(Q_const[-1].expand(B, n, 1, C), q_const[-1])
    z_last, _ = tail(last, slice(chunk - 1, chunk))
    z_last = z_last.reshape(B, n, C)
    carries = torch.cat([z_last.new_zeros(B, 1, C), z_last[:, :-1]], dim=1)
    # pass 2: every row, the carries in query row 0
    q0 = layer_norm(P.ln_q, carries + pe[0])                     # [B, n, C]
    Q = torch.cat([linear(P.q_proj, q0)[:, :, None],
                   Q_const[1:].expand(B, n, chunk - 1, C)], dim=2)
    q_rows = torch.cat([q0[:, :, None], q_const[1:].expand(B, n, chunk - 1, C)], dim=2)
    return tail(predict(Q, q_rows), slice(None))


def _chunk_rows(x: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
    """[B, C, n * chunk] -> [B * n, C, chunk]."""
    B, C, _ = x.shape
    return x.reshape(B, C, n, chunk).permute(0, 2, 1, 3).reshape(B * n, C, chunk)


def _unchunk(z_hat: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """[B * n, C, chunk] -> [B, C, T]."""
    Bn, C, chunk = z_hat.shape
    return z_hat.reshape(B, Bn // B, C, chunk).permute(0, 2, 1, 3).reshape(B, C, -1)[..., :T]


def ar_roll_parallel(head: Head, cfg: CodecConfig, qa: torch.Tensor,
                     zt_teacher: torch.Tensor, n_books_use: Optional[int] = None,
                     ) -> ARRollOut:
    """``allpred_ar.ar_roll``'s contract as two passes: qa, zt_teacher
    [B, C, T] -> (z_run [B, C, T], codes [B, T, n_books_use])."""
    chunk = cfg.ar_chunk_tok
    if chunk < 2:
        return ar_roll(head, cfg, qa, zt_teacher, n_books_use=n_books_use)
    B, C, T = zt_teacher.shape
    n, Tp = _chunks(T, chunk)
    zt = _chunk_rows(F.pad(zt_teacher, (0, Tp - T)), n, chunk)  # [B * n, C, chunk]
    scale = torch.clamp(head.scale, cfg.scale_min, cfg.scale_max).to(zt_teacher.dtype)

    def tail(z_pred, rows):
        rN = torch.tanh(token_norm(head.tokennorm, zt[..., rows] - z_pred))
        qD, idx = rvq_quantize(head.vq_books, _proj(head.proj_down, scale * rN),
                               n_books_use=n_books_use)
        return z_pred + _proj(head.proj_up, qD), idx

    z_hat, idx = _two_pass(head, cfg, qa, T, tail)
    return ARRollOut(_unchunk(z_hat, B, T), idx.reshape(B, Tp, -1)[:, :T])


@torch.no_grad()
def encode_latents_parallel(m: CodecModules, a: torch.Tensor, tc: torch.Tensor,
                            n_books_use: Optional[int] = None,
                            cfg: Optional[CodecConfig] = None) -> ARRollOut:
    """``allpred_ar.encode_latents`` on the two-pass roll; true fp32 in fp32."""
    cfg = cfg or m.cfg
    with fp32_exact(a.dtype == torch.float32):
        qa, zt = backbone_latents(m, a, tc, cfg)
        return ar_roll_parallel(m.head, cfg, qa, zt, n_books_use=n_books_use)


@torch.no_grad()
def decode_from_codes_parallel(m: CodecModules, a: torch.Tensor, codes: torch.Tensor,
                               cfg: Optional[CodecConfig] = None) -> torch.Tensor:
    """``allpred_ar.decode_from_codes`` on the two-pass roll. The carry pass
    needs no VQ search: it adds the transmitted row-(chunk-1) residuals."""
    cfg = cfg or m.cfg
    if cfg.ar_chunk_tok < 2:
        return decode_from_codes(m, a, codes, cfg=cfg)
    with fp32_exact(a.dtype == torch.float32):
        head, chunk = m.head, cfg.ar_chunk_tok
        qa, _ = m.audio_dac.quantizer.quantize(m.audio_dac.encoder(a, cfg.dac))
        B, C, T = qa.shape
        T = min(T, codes.shape[1])
        n, Tp = _chunks(T, chunk)
        codes_p = F.pad(codes[:, :T], (0, 0, 0, Tp - T))
        qD = rvq_decode(head.vq_books, codes_p).to(qa.dtype)    # [B, D, Tp]
        up = _chunk_rows(_proj(head.proj_up, qD), n, chunk)      # [B * n, C, chunk]

        def tail(z_pred, rows):
            return z_pred + up[..., rows], None

        z_hat, _ = _two_pass(head, cfg, qa, T, tail)
        return m.tactile_dac.decoder(_unchunk(z_hat, B, T), cfg.dac)
