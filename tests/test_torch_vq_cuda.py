"""The fused residual-VQ lookup kernel (K2) on the card, against its plain
version: the same indices and bit-equal q_sum, ties and ``n_books_use``
included, at every tokens-a-block instance, with books streamed in several
stages, codes of D off the 16-byte pieces and books off 16-byte alignment.

Marked ``cuda``: each test skips without a card. The file imports neither jax
nor the JAX package, so it also runs on a machine with the card, which has
neither; there, run it without the repository's conftest (which sets up jax):

    python -m pytest --noconftest tests/test_torch_vq_cuda.py -q
"""

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import rvq, vq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _books(seed, n_books, K, D, dup):
    b = np.random.default_rng(seed).standard_normal((n_books, K, D)).astype(np.float32)
    b /= np.sqrt(D)
    if dup:
        b[:, K // 2:] = b[:, :K // 2]       # every score tied with an earlier one
    return torch.from_numpy(b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_books,K,D,N,use,dup", [
    (8, 128, 96, 16, None, False),      # one AR chunk of the head RVQ at batch 1
    (10, 512, 96, 2400, None, False),   # batch 32 x 75 tokens, K = 512
    (3, 128, 96, 75, 2, False),         # n_books_use < n_books
    (4, 64, 96, 300, None, True),       # exact ties
    (4, 32, 16, 20, None, False),       # small D, K below one staged chunk
    (2, 100, 7, 33, None, False),       # odd D, K off the chunk
    (8, 128, 96, 1, None, False),       # N = 1
    (8, 128, 96, 17, None, False),      # one token more than an AR chunk
    (4, 128, 96, 2113, None, False),    # 132 blocks of 16 tokens and a ragged one
    (8, 512, 96, 16, None, False),      # K = 512 streams through the ring
    (4, 512, 96, 300, None, True),      # ties across stages
    (3, 512, 96, 75, 2, False),         # n_books_use < n_books, streamed
    (2, 100, 7, 2113, None, False),     # K and D off every tile, 16 tokens a block
    (2, 128, 512, 2113, None, False),   # D = MAX_DIM: 40 codes a stage
    (2, 64, 98, 40, None, False),       # D % 4 != 0: 4-byte copies and a tail
    (3, 128, 96, 600, None, False),     # 4 tokens a block
    (3, 128, 96, 1100, None, False),    # 8 tokens a block
])
def test_kernel_matches_plain_on_card(cuda, n_books, K, D, N, use, dup):
    books = _books(K + N, n_books, K, D, dup).to(cuda)
    x = torch.randn(N, D, generator=torch.Generator().manual_seed(N)).to(cuda)
    before = vq.launches
    q, idx = vq.rvq_lookup_fused(books, x, use)
    assert vq.launches == before + 1
    q_ref, idx_ref = vq.rvq_lookup_ref(books, x, use)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_ref.to(idx.dtype))
    assert torch.equal(q, q_ref)
    if dup:
        assert int(idx.max()) < K // 2
    # the serving path's matmul-based quantizer picks the same codes
    q_rvq, idx_rvq = rvq.rvq_quantize(books, x.T[None], use)
    assert torch.equal(idx, idx_rvq[0])


@pytest.mark.cuda
def test_quantize_wrapper_shapes(cuda):
    books = _books(1, 8, 128, 96, False).to(cuda)
    z = torch.randn(2, 96, 16, device=cuda).bfloat16()
    q, idx = vq.rvq_quantize_fused(books, z)
    assert q.shape == z.shape and q.dtype == torch.bfloat16
    assert idx.shape == (2, 16, 8) and idx.dtype == torch.int32


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    books = _books(2, 2, 16, 8, False).to(cuda)
    with pytest.raises(ValueError):
        vq.rvq_lookup_fused(books, torch.randn(4, 9, device=cuda))      # D differs
    with pytest.raises(ValueError):
        vq.rvq_lookup_fused(books.cpu(), torch.randn(4, 8, device=cuda))


@pytest.mark.cuda
def test_kernel_takes_books_off_16_byte_alignment(cuda):
    """Books 4 bytes off a 16-byte boundary go through the 4-byte copies."""
    K, D = 128, 96
    flat = torch.zeros(3 * K * D + 1)
    flat[1:] = _books(7, 3, K, D, False).reshape(-1)
    books = flat.to(cuda)[1:].view(3, K, D)
    assert books.data_ptr() % 16 == 4
    x = torch.randn(16, D, generator=torch.Generator().manual_seed(5)).to(cuda)
    q, idx = vq.rvq_lookup_fused(books, x)
    q_ref, idx_ref = vq.rvq_lookup_ref(books, x)
    assert torch.equal(idx, idx_ref) and torch.equal(q, q_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,grid,tokens,stages", [
    (16, 128, 96, 16, 1, 1),            # one AR chunk: one book a stage
    (2400, 512, 96, 150, 16, 4),
    (2113, 128, 512, 133, 16, 4),
])
def test_plan(cuda, n, k, d, grid, tokens, stages):
    p = vq.plan(n, k, d)
    assert (p["grid"], p["tokens_per_block"], p["stages_per_book"]) == (grid, tokens, stages)
    assert p["threads"] == 160 and p["smem_bytes"] <= 227 * 1024
