"""The training half of the port's head RVQ against the JAX package's
``ops/rvq.py``, on the CPU: the straight-through gradient (``n_use * I``,
the reference quirk, and ``I``), ``usage_stats`` (counts and used share
exact; the entropy, a sum over the K codes that XLA and PyTorch order
differently, within 1e-6), ``ema_update`` and
``ema_update_with_reinit`` (live codes within 1e-6; reseeded codes are rows
of the target plus a jitter of ``1e-3 * std`` with the population std, and
their counts the uniform share), and the first-step adoption of the batch
counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.ops import rvq as jrvq
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import rvq


def _books_tokens(seed, n=3, K=16, D=8, B=2, T=20):
    rng = np.random.default_rng(seed)
    books = (rng.standard_normal((n, K, D)) / np.sqrt(D)).astype(np.float32)
    z = (0.5 * rng.standard_normal((B, D, T))).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[:, -3:] = False
    return books, z, valid


@pytest.mark.parametrize("ste_scale,use", [("reference", None), ("reference", 2),
                                           ("unit", None)])
def test_straight_through_gradient_matches_jax(ste_scale, use):
    books, z, _ = _books_tokens(0)
    w = np.random.default_rng(1).standard_normal(z.shape).astype(np.float32)
    zt = torch.from_numpy(z).requires_grad_(True)
    q, idx = rvq.rvq_quantize(torch.from_numpy(books), zt, n_books_use=use, ste_scale=ste_scale)
    (q * torch.from_numpy(w)).sum().backward()

    def f(zz):
        qq, _ = jrvq.rvq_quantize(jnp.asarray(books), zz, n_books_use=use,
                                  ste_scale=ste_scale)
        return jnp.sum(qq * w)
    jg = jax.grad(f)(jnp.asarray(z))
    jq, jidx = jrvq.rvq_quantize(jnp.asarray(books), jnp.asarray(z), n_books_use=use)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(jq))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
    n_use = books.shape[0] if use is None else use
    assert np.allclose(zt.grad.numpy(), (n_use if ste_scale == "reference" else 1) * w)


def test_quantize_adds_no_estimator_without_autograd():
    """Serving (no grad recorded) gets the plain value, with no graph."""
    books, z, _ = _books_tokens(2)
    zt = torch.from_numpy(z).requires_grad_(True)
    with torch.no_grad():
        q, _ = rvq.rvq_quantize(torch.from_numpy(books), zt)
    assert q.grad_fn is None
    q2, _ = rvq.rvq_quantize(torch.from_numpy(books), torch.from_numpy(z))
    assert q2.grad_fn is None and torch.equal(q, q2)


@pytest.mark.parametrize("with_valid", [False, True])
def test_usage_stats_match_jax_exactly(with_valid):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 16, (2, 20, 3)).astype(np.int32)
    codes[..., 2] = 5                                     # one book uses one code
    valid = (np.arange(20) < 17) if with_valid else None
    got = rvq.usage_stats(torch.from_numpy(codes), 16,
                          None if valid is None else torch.from_numpy(valid))
    ref = jrvq.usage_stats(jnp.asarray(codes), 16, None if valid is None else jnp.asarray(valid))
    for k in ("used_frac", "counts"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(got["bits"].numpy(), np.asarray(ref["bits"]), rtol=1e-6)


@pytest.mark.parametrize("mode", ["reference", "residual"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_ema_update_matches_jax(mode, with_valid):
    books, z, valid = _books_tokens(4)
    v = valid if with_valid else None
    got = rvq.ema_update(torch.from_numpy(books), torch.from_numpy(z),
                         None if v is None else torch.from_numpy(v), decay=0.9, ema_mode=mode)
    ref = jrvq.ema_update(jnp.asarray(books), jnp.asarray(z),
                          None if v is None else jnp.asarray(v), decay=0.9, ema_mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert not np.array_equal(got.numpy(), books)


@pytest.mark.parametrize("mode", ["reference", "residual"])
@pytest.mark.parametrize("counts0", ["zeros", "warm"])
def test_ema_update_with_reinit_no_reseed_matches_jax(mode, counts0):
    """dead_frac 0: no draw; the EMA and the counts (first step: the batch's
    counts adopted wholesale) against JAX."""
    books, z, valid = _books_tokens(5)
    counts = (np.zeros((3, 16), np.float32) if counts0 == "zeros"
              else np.random.default_rng(6).uniform(0, 3, (3, 16)).astype(np.float32))
    got_b, got_c = rvq.ema_update_with_reinit(
        torch.from_numpy(books), torch.from_numpy(counts), torch.from_numpy(z), None,
        valid=torch.from_numpy(valid), decay=0.95, ema_mode=mode, dead_frac=0.0)
    ref_b, ref_c = jrvq.ema_update_with_reinit(
        jnp.asarray(books), jnp.asarray(counts), jnp.asarray(z), jax.random.key(0),
        valid=jnp.asarray(valid), decay=0.95, ema_mode=mode, dead_frac=0.0)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=0, atol=1e-6)
    if counts0 == "zeros":
        assert got_c.sum(1).tolist() == [float(valid.sum())] * 3


@pytest.mark.parametrize("mode", ["reference", "residual"])
def test_ema_update_with_reinit_reseeds_dead_codes(mode):
    """dead_frac 0.5 with a few hot codes: the codes that stay live equal
    JAX's; the dead ones (the same set in both) are rows of their book's
    target plus a jitter of 1e-3 * std (population std), drawn from valid
    tokens only, with the uniform share as their count; the same generator
    seed gives the same reseeds."""
    books, z, valid = _books_tokens(7)
    counts = np.full((3, 16), 0.01, np.float32)
    counts[:, :4] = 5.0                                    # codes 0-3 live
    args = dict(valid=torch.from_numpy(valid), decay=0.9, ema_mode=mode, dead_frac=0.5)
    got_b, got_c = rvq.ema_update_with_reinit(
        torch.from_numpy(books), torch.from_numpy(counts), torch.from_numpy(z),
        torch.Generator().manual_seed(11), **args)
    again_b, _ = rvq.ema_update_with_reinit(
        torch.from_numpy(books), torch.from_numpy(counts), torch.from_numpy(z),
        torch.Generator().manual_seed(11), **args)
    assert torch.equal(got_b, again_b)
    ref_b, ref_c = jrvq.ema_update_with_reinit(
        jnp.asarray(books), jnp.asarray(counts), jnp.asarray(z), jax.random.key(3),
        valid=jnp.asarray(valid), decay=0.9, ema_mode=mode, dead_frac=0.5)
    ref_b, ref_c = np.asarray(ref_b), np.asarray(ref_c)
    n_valid = float(valid.sum())
    share = n_valid / 16
    dead = np.isclose(ref_c, share) & (counts < 1.0)
    assert dead.any() and (~dead).any()
    np.testing.assert_array_equal(np.isclose(got_c.numpy(), share) & (counts < 1.0), dead)
    np.testing.assert_allclose(got_b.numpy()[~dead], ref_b[~dead], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_c.numpy()[~dead], ref_c[~dead], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_c.numpy()[dead], share, rtol=1e-6)

    # each book's targets: the tokens, or the residual after the earlier books
    X = z.transpose(0, 2, 1).reshape(-1, z.shape[1]).astype(np.float32)
    vflat = valid.reshape(-1)
    target = X.copy()
    for i in range(books.shape[0]):
        tgt = X if mode == "reference" else target
        std = float(np.std(tgt))
        for k in np.flatnonzero(dead[i]):
            d = np.abs(tgt[vflat] - got_b.numpy()[i, k]).max(axis=1)
            assert d.min() <= 6e-3 * std          # a valid row plus a 1e-3 * std jitter
        scores = tgt @ books[i].T - 0.5 * np.sum(books[i] ** 2, axis=1)
        target = target - books[i][np.argmax(scores, axis=1)]
