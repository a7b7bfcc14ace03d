"""Head residual VQ: quantize, encode and decode, and its EMA training.

Port of the JAX package's ``ops/rvq.py`` over one stacked codebook tensor
``books [n_books, K, D]``. The nearest code is ``argmax(x . e - 0.5 ||e||^2)``
with the first index winning ties, computed in true fp32 whatever the
compute dtype: the indices are the transmitted bitstream. (Callers on the
card keep TF32 off, see ``eval/serving.py``.)

Training: ``rvq_quantize`` adds the reference's straight-through estimator
when autograd records (its gradient toward z is ``n_books_use * I``, the
quirk the trained checkpoints were shaped by; ``ste_scale="unit"`` gives
``I``); the books learn by EMA only (``ema_update``, and
``ema_update_with_reinit`` with EMA cluster sizes and dead-code reseeding
from the batch), drawing from an explicit ``torch.Generator``;
``usage_stats`` measures per-book code usage.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _nearest(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    scores = x @ emb.T - 0.5 * torch.sum(emb * emb, dim=1)[None, :]
    return torch.argmax(scores, dim=1)


def _flatten_bdt(z: torch.Tensor) -> torch.Tensor:
    """[B, D, T] -> [B * T, D] fp32."""
    B, D, T = z.shape
    return z.transpose(1, 2).reshape(B * T, D).float()


def rvq_quantize(books: torch.Tensor, z: torch.Tensor,
                 n_books_use: Optional[int] = None, ste_scale: str = "reference",
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z [B, D, T] -> (q_sum [B, D, T] in z's dtype, indices [B, T, n_use] int32).
    When autograd records z, the value stays q_sum and the gradient toward z
    is ``n_use * I`` (``ste_scale="reference"``) or ``I`` (``"unit"``); the
    books get none."""
    n_books = books.shape[0]
    use = n_books if n_books_use is None else min(n_books_use, n_books)
    B, D, T = z.shape
    with torch.no_grad():
        residual = _flatten_bdt(z)
        q_sum = torch.zeros_like(residual)
        idxs = []
        for emb in books[:use].float():
            idx = _nearest(residual, emb)
            q = emb[idx]
            residual = residual - q
            q_sum = q_sum + q
            idxs.append(idx)
        out = q_sum.reshape(B, T, D).transpose(1, 2).to(z.dtype)
    if torch.is_grad_enabled() and z.requires_grad:
        mult = float(use) if ste_scale == "reference" else 1.0
        out = out + mult * (z - z.detach())
    return out, torch.stack(idxs, dim=1).reshape(B, T, use).to(torch.int32)


def rvq_encode(books: torch.Tensor, z: torch.Tensor,
               n_books_use: Optional[int] = None) -> torch.Tensor:
    """Code indices only: [B, T, n_use] int32."""
    return rvq_quantize(books, z, n_books_use)[1]


def rvq_decode(books: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """indices [B, T, n_use] -> q_sum [B, D, T] (fp32)."""
    n_use = indices.shape[-1]
    per_book = torch.stack([books[i].float()[indices[..., i].long()]
                            for i in range(n_use)], dim=2)       # [B, T, n, D]
    return per_book.sum(dim=2).transpose(1, 2)


def _segment_sum(w: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """sum of w's rows per index: w [N] or [N, D], idx [N] -> [K] or [K, D]."""
    out = w.new_zeros((K,) + tuple(w.shape[1:]))
    return out.index_add_(0, idx, w)


def _weights(valid: Optional[torch.Tensor], N: int, device) -> torch.Tensor:
    if valid is None:
        return torch.ones(N, device=device)
    return valid.reshape(N).float()


@torch.no_grad()
def ema_update(books: torch.Tensor, z_tokens: torch.Tensor,
               valid: Optional[torch.Tensor] = None, decay: float = 0.99,
               ema_mode: str = "reference") -> torch.Tensor:
    """One EMA codebook step without cluster sizes -> new books [n, K, D].
    z_tokens [B, D, T] (detached residual projections), valid [B, T] bool
    (padded tokens left out). ``ema_mode="reference"``: every book's targets
    are the original tokens (the reference's quirk); ``"residual"``: that
    book's running residual. A code that no token hit keeps its value."""
    X = _flatten_bdt(z_tokens)
    w = _weights(valid, X.shape[0], X.device)
    K = books.shape[1]
    target, out = X, []
    for emb in books.float():
        idx = _nearest(target, emb)
        counts = _segment_sum(w, idx, K)
        sums = _segment_sum(target * w[:, None], idx, K)
        means = sums / (counts[:, None] + 1e-9)
        out.append(torch.where((counts > 0)[:, None], decay * emb + (1.0 - decay) * means,
                               emb))
        if ema_mode == "residual":
            target = target - emb[idx]
    return torch.stack(out)


@torch.no_grad()
def track_counts_and_reinit(emb: torch.Tensor, cnt: torch.Tensor, target: torch.Tensor,
                            batch_counts: torch.Tensor, gen: Optional[torch.Generator], *,
                            decay: float, dead_frac: float, uniform_share,
                            p: Optional[torch.Tensor] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EMA cluster sizes and dead-code reseeding of one book -> (emb, cnt).

    All-zero ``cnt`` adopts ``batch_counts`` wholesale (the first step's
    data-dependent init). Then a code whose count is below
    ``dead_frac * uniform_share`` becomes a row of ``target`` drawn with
    probabilities ``p`` (uniform when None) from ``gen``, plus a jitter of
    ``1e-3 * std(target)`` (population std) times a normal draw, and its
    count becomes the uniform share. With ``dead_frac <= 0`` nothing is
    drawn."""
    K, N = emb.shape[0], target.shape[0]
    new_cnt = torch.where(cnt.sum() <= 0.0, batch_counts,
                          decay * cnt + (1.0 - decay) * batch_counts)
    if dead_frac <= 0.0:
        return emb, new_cnt
    dead = new_cnt < dead_frac * uniform_share
    probs = torch.ones(N, device=target.device) if p is None else p
    samp = torch.multinomial(probs, K, replacement=True, generator=gen)
    seeds = target[samp]
    noise = torch.randn(seeds.shape, generator=gen, device=seeds.device, dtype=seeds.dtype)
    seeds = seeds + 1e-3 * torch.std(target, correction=0) * noise
    new_emb = torch.where(dead[:, None], seeds, emb)
    new_cnt = torch.where(dead, torch.as_tensor(uniform_share, dtype=new_cnt.dtype,
                                                device=new_cnt.device), new_cnt)
    return new_emb, new_cnt


@torch.no_grad()
def ema_update_with_reinit(books: torch.Tensor, counts: torch.Tensor,
                           z_tokens: torch.Tensor, gen: Optional[torch.Generator],
                           valid: Optional[torch.Tensor] = None, decay: float = 0.99,
                           ema_mode: str = "residual", dead_frac: float = 0.1,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EMA update + cluster sizes + dead-code reinit -> (books, counts).

    counts [n, K] (zeros at init). Book i's targets are the running residual
    after books < i (``"residual"``) or the original tokens
    (``"reference"``); the next book's residual subtracts the pre-update
    codes, which the quantization saw. The uniform share is valid tokens / K;
    reseeds draw valid tokens only, from ``gen`` (book by book)."""
    X = _flatten_bdt(z_tokens)
    N = X.shape[0]
    w = _weights(valid, N, X.device)
    K = books.shape[1]
    n_tokens = torch.sum(w)
    uniform_share = n_tokens / K
    p = w / torch.clamp_min(n_tokens, 1.0)
    residual, new_books, new_counts = X, [], []
    for emb, cnt in zip(books.float(), counts.float()):
        target = X if ema_mode == "reference" else residual
        idx = _nearest(target, emb)
        batch_counts = _segment_sum(w, idx, K)
        sums = _segment_sum(target * w[:, None], idx, K)
        means = sums / (batch_counts[:, None] + 1e-9)
        e = torch.where((batch_counts > 0)[:, None], decay * emb + (1.0 - decay) * means,
                        emb)
        residual = residual - emb[idx]
        e, c = track_counts_and_reinit(e, cnt, target, batch_counts, gen, decay=decay,
                                       dead_frac=dead_frac, uniform_share=uniform_share,
                                       p=p)
        new_books.append(e)
        new_counts.append(c)
    return torch.stack(new_books), torch.stack(new_counts)


@torch.no_grad()
def usage_stats(codes: torch.Tensor, n_embed: int,
                valid: Optional[torch.Tensor] = None) -> dict:
    """Per-book code usage of transmitted indices codes [B, T, n] (valid [T]
    or [B, T] bool): {"bits": [n] measured entropy in bits/token,
    "used_frac": [n] share of codes hit, "counts": [n, K]}."""
    B, T, n_books = codes.shape
    w = torch.ones(B, T, device=codes.device) if valid is None else \
        torch.broadcast_to(valid.float(), (B, T))
    w_flat = w.reshape(-1).repeat(n_books)
    offsets = torch.arange(n_books, device=codes.device) * n_embed
    idx_flat = (codes.long() + offsets).permute(2, 0, 1).reshape(-1)
    counts = _segment_sum(w_flat, idx_flat, n_books * n_embed).reshape(n_books, n_embed)
    total = torch.clamp_min(counts.sum(1, keepdim=True), 1e-9)
    probs = counts / total
    bits = -torch.sum(torch.where(probs > 0, probs * torch.log2(torch.clamp_min(probs, 1e-30)),
                                  0.0), dim=1)
    used = (counts > 0).float().mean(1)
    return {"bits": bits, "used_frac": used, "counts": counts}
