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

As in the JAX package, the serving path does not call this module: its AR
roll quantizes with ``ops/rvq.py::rvq_quantize``, which picks the same codes
up to the order of fp32 sums.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

# Kernel launches made by ``rvq_lookup_fused`` (one per call); reset it to 0
# before a run to count that run's launches.
launches = 0

MAX_DIM = 512     # the kernel keeps 96 rows of D + 1 floats in shared memory


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
_SIGNATURES = {"rvq_lookup": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
               + [ctypes.c_void_p]}


def _lib() -> ctypes.CDLL:
    return _build.load(*LIBRARY, _SIGNATURES)


def rvq_lookup_fused(books: torch.Tensor, x: torch.Tensor,
                     n_books_use: Optional[int] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, D], books [n_books, K, D] -> (q_sum [N, D] fp32, idx [N, use]
    int32). CUDA tensors go through the kernel, CPU tensors through
    ``rvq_lookup_ref``."""
    global launches
    if x.device.type == "cpu":
        return rvq_lookup_ref(books, x, n_books_use)
    if x.device.type != "cuda":
        raise ValueError(f"rvq_lookup_fused: unsupported device {x.device}")
    if x.dim() != 2 or books.dim() != 3 or books.shape[2] != x.shape[1]:
        raise ValueError(f"rvq_lookup_fused: x {tuple(x.shape)} and books "
                         f"{tuple(books.shape)} do not match")
    if books.device != x.device:
        raise ValueError("rvq_lookup_fused: books and x on different devices")
    N, D = x.shape
    K = books.shape[1]
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"rvq_lookup_fused: code dim {D} not in [1, {MAX_DIM}]")
    use = _use(books, n_books_use)
    if N == 0 or use < 1:
        raise ValueError("rvq_lookup_fused: no tokens or no books")
    xf = x.detach().float().contiguous()
    bf = books.detach()[:use].float().contiguous()
    q_sum = torch.empty(N, D, dtype=torch.float32, device=x.device)
    idx = torch.empty(N, use, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().rvq_lookup(xf.data_ptr(), bf.data_ptr(), q_sum.data_ptr(),
                           idx.data_ptr(), N, K, D, use, stream)
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
