"""The fused residual-VQ lookup kernel (K2) on the card, against its plain
version: the same indices and bit-equal q_sum, ties and ``n_books_use``
included.

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
