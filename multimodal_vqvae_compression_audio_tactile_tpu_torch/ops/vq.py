"""Fused residual-VQ lookup (K2): the CUDA kernel's wrapper and its plain
version.

Port of the JAX package's ``ops/vq_pallas.py`` (``rvq_lookup_fused``,
``rvq_quantize_fused``): the whole residual VQ in one launch, inference
semantics (plain ``q_sum``, no straight-through). Per book, in order: the
fp32 score ``r . e - 0.5 ||e||^2``, the first index of the highest score, the
code gathered, ``q_sum += q``, ``r -= q``. The scores are summed over the code
dimension in a fixed order with separately rounded products and sums, in the
kernel (``csrc/rvq_lookup.cu``) and in ``rvq_lookup_ref`` alike, so the two
give the same indices and bit-equal ``q_sum``.

A launch takes ``pick_tokens(N)`` tokens a block, so that the grid fills the
card where N allows; ``plan`` gives the rest of its shape (threads, codes a
shared-memory stage, dynamic shared memory), which the kernel works out.

As in the JAX package, the serving path does not call this module: its AR
roll quantizes with ``ops/rvq.py::rvq_quantize``, which picks the same codes
up to the order of fp32 sums.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .resunit import SMS, _f32

# Kernel launches made by ``rvq_lookup_fused`` (one per call); reset it to 0
# before a run to count that run's launches.
launches = 0

MAX_DIM = 512     # at 16 tokens a block, two stages of 40 codes still fit
TOKEN_TILES = (16, 8, 4, 2, 1)    # tokens a block, in order of preference


def pick_tokens(N: int) -> int:
    """Tokens a block for N tokens: the most of ``TOKEN_TILES`` whose grid
    still fills the card's ``SMS`` multiprocessors, else 1 (every token its
    own block). More tokens a block read each book fewer times."""
    for tn in TOKEN_TILES:
        if -(-N // tn) >= SMS:
            return tn
    return 1


def _use(books: torch.Tensor, n_books_use: Optional[int]) -> int:
    n_books = books.shape[0]
    return n_books if n_books_use is None else min(n_books_use, n_books)


def rvq_lookup_ref(books: torch.Tensor, x: torch.Tensor,
                   n_books_use: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: x [N, D], books [n_books, K, D] -> (q_sum [N, D]
    fp32, idx [N, use] int32), with the kernel's order of fp32 sums."""
    r = x.float()
    q_sum = torch.zeros_like(r)
    idxs = []
    for emb in books[:_use(books, n_books_use)].float():
        dot = torch.zeros(r.shape[0], emb.shape[0], device=r.device)
        half_norm = torch.zeros(emb.shape[0], device=r.device)
        for d in range(emb.shape[1]):
            dot = dot + r[:, d:d + 1] * emb[None, :, d]
            half_norm = half_norm + emb[:, d] * emb[:, d]
        idx = torch.argmax(dot - 0.5 * half_norm, dim=1)    # first index on ties
        q = emb[idx]
        r = r - q
        q_sum = q_sum + q
        idxs.append(idx)
    return q_sum, torch.stack(idxs, dim=1).to(torch.int32)


# (library name, source under csrc/)
LIBRARY = ("rvq", "rvq_lookup.cu")
_SIGNATURES = {"rvq_lookup": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               "rvq_plan": [ctypes.c_int] * 3 + [ctypes.c_void_p]}


def _lib() -> ctypes.CDLL:
    return _build.load(*LIBRARY, _SIGNATURES)


def plan(N: int, K: int, D: int) -> dict:
    """The kernel's launch for N tokens against books of K codes of D: grid,
    tokens and threads a block, codes a stage, stages a book and dynamic
    shared memory (asks the built library, so on the card's machine only)."""
    tn = pick_tokens(N)
    out = (ctypes.c_int * 3)()
    if _lib().rvq_plan(tn, K, D, out) != 0:
        raise ValueError(f"rvq_lookup: no launch for K={K}, D={D}")
    threads, kc, smem = out
    return {"grid": -(-N // tn), "tokens_per_block": tn, "threads": threads,
            "codes_per_stage": kc, "stages_per_book": -(-K // kc), "smem_bytes": smem}


def rvq_lookup_fused(books: torch.Tensor, x: torch.Tensor,
                     n_books_use: Optional[int] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, D], books [n_books, K, D] -> (q_sum [N, D] fp32, idx [N, use]
    int32). CUDA tensors go through the kernel, CPU tensors through
    ``rvq_lookup_ref``."""
    global launches
    dev = x.device
    if dev.type == "cpu":
        return rvq_lookup_ref(books, x, n_books_use)
    if dev.type != "cuda":
        raise ValueError(f"rvq_lookup_fused: unsupported device {dev}")
    if x.dim() != 2 or books.dim() != 3 or books.shape[2] != x.shape[1]:
        raise ValueError(f"rvq_lookup_fused: x {tuple(x.shape)} and books "
                         f"{tuple(books.shape)} do not match")
    if books.device != dev:
        raise ValueError("rvq_lookup_fused: books and x on different devices")
    N, D = x.shape
    n_books, K = books.shape[:2]
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"rvq_lookup_fused: code dim {D} not in [1, {MAX_DIM}]")
    use = _use(books, n_books_use)
    if N == 0 or K == 0 or use < 1:
        raise ValueError("rvq_lookup_fused: no tokens, codes or books")
    xf = _f32(x)
    bf = _f32(books if use == n_books else books[:use])
    q_sum = xf.new_empty((N, D))
    idx = xf.new_empty((N, use), dtype=torch.int32)
    # the current stream's raw handle, as PyTorch's own generated kernels take
    # it, without building a Stream object on every call
    rc = _lib().rvq_lookup(xf.data_ptr(), bf.data_ptr(), q_sum.data_ptr(), idx.data_ptr(),
                           N, K, D, use, pick_tokens(N),
                           torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"rvq_lookup launch failed: CUDA error {rc}")
    launches += 1
    return q_sum, idx


def rvq_quantize_fused(books: torch.Tensor, z_bdt: torch.Tensor,
                       n_books_use: Optional[int] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z [B, D, T] -> (q [B, D, T] in z's dtype, idx [B, T, use] int32), the
    ``[B, D, T]`` wrapper of ``rvq_lookup_fused``."""
    B, D, T = z_bdt.shape
    x = z_bdt.transpose(1, 2).reshape(B * T, D)
    q, idx = rvq_lookup_fused(books, x, n_books_use)
    return (q.reshape(B, T, D).transpose(1, 2).to(z_bdt.dtype),
            idx.reshape(B, T, -1))
