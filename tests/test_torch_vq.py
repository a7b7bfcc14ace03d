"""The port's fused residual-VQ lookup (K2) against the JAX package.

``rvq_lookup_ref`` and ``rvq_quantize_fused`` (which a CPU tensor sends to the
plain version) are held against the TPU kernel run in interpret mode
(``vq_pallas.rvq_quantize_fused(interpret=True)``) and against the port's
``ops/rvq.py::rvq_quantize``, on the CPU: indices exactly equal, q_sum within
1e-6 (the codes are the same, so only the sums' rounding can differ). The
CUDA kernel is held against the plain version on the card in
``test_torch_vq_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.ops.vq_pallas import (
    rvq_quantize_fused as jax_rvq_quantize_fused)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import rvq, vq


def _books(seed, n_books, K, D, dup=False):
    """N(0, 1) / sqrt(D) books; with ``dup`` each book's second half repeats
    its first, so every score has an exact tie and the first index must win."""
    b = np.random.default_rng(seed).standard_normal((n_books, K, D)).astype(np.float32)
    b /= np.sqrt(D)
    if dup:
        b[:, K // 2:] = b[:, :K // 2]
    return b


def _z(seed, B, D, T):
    return np.random.default_rng(seed).standard_normal((B, D, T)).astype(np.float32)


CASES = [
    # (n_books, K, D, B, T, n_books_use, duplicated rows)
    (4, 32, 16, 2, 10, None, False),     # tests/test_rvq.py's setup
    (3, 128, 96, 1, 75, 2, False),       # D = 96, n_books_use < n_books, N = 75
    (8, 128, 96, 1, 16, None, False),    # one AR chunk of the head RVQ at batch 1
    (10, 512, 96, 4, 75, None, False),   # K = 512, 10 books
    (4, 64, 96, 2, 30, None, True),      # forced exact ties
    (8, 128, 96, 1, 1, None, False),     # N = 1
    (8, 128, 96, 1, 17, None, False),    # one token more than an AR chunk
    (2, 128, 96, 1, 2113, None, False),  # 132 blocks of 16 tokens and one token more
    (3, 512, 96, 1, 16, 2, True),        # K = 512 (streamed), n_books_use < n_books, ties
    (2, 100, 7, 3, 11, None, False),     # K and D off every tile
]


@pytest.mark.parametrize("n_books,K,D,B,T,use,dup", CASES)
def test_matches_pallas_interpret_and_rvq_quantize(n_books, K, D, B, T, use, dup):
    books = _books(K + D, n_books, K, D, dup)
    z = _z(T, B, D, T)
    q_pal, idx_pal = jax_rvq_quantize_fused(jnp.asarray(books), jnp.asarray(z),
                                            n_books_use=use, interpret=True)
    with torch.no_grad():
        q, idx = vq.rvq_quantize_fused(torch.from_numpy(books), torch.from_numpy(z), use)
        q_rvq, idx_rvq = rvq.rvq_quantize(torch.from_numpy(books), torch.from_numpy(z), use)
    n_use = n_books if use is None else use
    assert idx.shape == (B, T, n_use) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_pal))
    np.testing.assert_array_equal(idx.numpy(), idx_rvq.numpy())
    np.testing.assert_allclose(q.numpy(), np.asarray(q_pal), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), q_rvq.numpy(), rtol=1e-6, atol=1e-6)
    if dup:
        assert int(idx.max()) < K // 2      # every tie went to the first index


@pytest.mark.parametrize("n,tokens", [(1, 1), (16, 1), (131, 1), (264, 2), (300, 2),
                                      (1056, 8), (2112, 16), (2400, 16), (10 ** 6, 16)])
def test_token_tile_fills_the_card_where_n_allows(n, tokens):
    """The kernel's tokens a block: the most whose grid reaches the H100's 132
    multiprocessors, else one token a block."""
    assert vq.pick_tokens(n) == tokens
    assert -(-n // tokens) >= vq.SMS or tokens == 1


def test_lookup_ref_is_the_cpu_path_and_counts_nothing():
    books = torch.from_numpy(_books(1, 3, 32, 16))
    x = torch.from_numpy(_z(2, 1, 40, 16)[0])
    before = vq.launches
    q, idx = vq.rvq_lookup_fused(books, x, n_books_use=2)
    q_ref, idx_ref = vq.rvq_lookup_ref(books, x, n_books_use=2)
    assert torch.equal(q, q_ref) and torch.equal(idx, idx_ref)
    assert q.dtype == torch.float32 and idx.shape == (40, 2)
    assert vq.launches == before


def test_bf16_input_scores_in_fp32():
    """q comes back in z's dtype; the codes are those of z widened to fp32."""
    books = torch.from_numpy(_books(3, 2, 32, 16))
    z = torch.from_numpy(_z(4, 1, 16, 12)).bfloat16()
    q, idx = vq.rvq_quantize_fused(books, z)
    _, idx32 = vq.rvq_quantize_fused(books, z.float())
    assert q.dtype == torch.bfloat16 and torch.equal(idx, idx32)


def test_meta_tensor_raises():
    books = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError):
        vq.rvq_lookup_fused(books, torch.empty(3, 4, device="meta"))
