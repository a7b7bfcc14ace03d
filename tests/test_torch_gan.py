"""The port's discriminators and GAN losses against the JAX package's, on the CPU.

The default ``GanConfig`` (MPD periods 2, 3, 5, 7, 11; MS-STFT sizes 256,
512, 1024), the JAX package's random init carried across by
``convert.disc_from_jax``, waveforms from numpy seeds:

- every conv's JAX ``padding="SAME"`` (strided and dilated, so padded
  unevenly) against XLA's, and ``disc_apply``'s logits and every feature
  map at T 2048 and at an odd T (the MPD's reflect pad to a multiple of the
  period): within 1e-5 of each map's largest;
- hinge and least-squares ``disc_loss``/``gen_adv_loss`` and
  ``feature_matching_loss`` (0 on identical inputs): 1e-6;
- ``gan_losses``' gradient toward the fake: within 1e-4 of its largest,
  with no discriminator leaf reached;
- the discriminators' and the usage counts' checkpoint bytes: equal to
  flax's for the same trees.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import GanConfig as JGanConfig
from multimodal_vqvae_compression_audio_tactile_tpu.losses import gan as jgan
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import GanConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses import gan
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import checkpoint

GCFG, JGCFG = GanConfig(), JGanConfig()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Six test workers share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rtol * max(np.max(np.abs(ref)), 1e-30)


def waves(seed, T, B=2):
    """(real, fake) [B, 1, T]: noisy tones and, as the JAX package's own GAN
    tests take, independent noise. A fake that tracks the real signal puts
    some feature elements of the two within fp32 rounding of each other,
    where L1's derivative flips sign on a rounding difference: one such
    element of 2.4M moved the feature-matching gradient by 8e-4 of its
    largest."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 24000.0
    real = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 2000, (B, 1, 1)) * t) \
        + 0.05 * rng.standard_normal((B, 1, T))
    fake = 0.3 * rng.standard_normal((B, 1, T))
    return real.astype(np.float32), fake.astype(np.float32)


@pytest.fixture(scope="module")
def discs():
    jp = jgan.disc_init(jax.random.key(0), JGCFG)
    d = convert.disc_from_jax(jax.tree.map(np.asarray, jp), GCFG)
    apply = jax.jit(lambda p, x: jgan.disc_apply(p, JGCFG, x))
    return jp, d, apply


@pytest.mark.parametrize("size,k,stride,dil", [
    (683, 5, 3, 1), (13, 5, 3, 1), (38, 3, 1, 1), (257, 3, 1, 1), (9, 9, 2, 1),
    (257, 3, 1, 2), (257, 3, 1, 4), (17, 9, 2, 1), (5, 3, 1, 1)])
def test_same_padding_matches_xla(size, k, stride, dil):
    """A strided or dilated conv pads as XLA's SAME: output length and values."""
    rng = np.random.default_rng(size * 7 + k)
    x = rng.standard_normal((1, 2, size, 3)).astype(np.float32)
    w = rng.standard_normal((4, 2, k, 1)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, 1), "SAME", rhs_dilation=(dil, 1),
        dimension_numbers=("NCHW", "OIHW", "NCHW"), precision=jax.lax.Precision.HIGHEST)
    c = gan.Conv2d(2, 4, (k, 1))
    with torch.no_grad():
        c.w.copy_(torch.from_numpy(w))
        c.b.zero_()
        got = gan.conv2d(c, torch.from_numpy(x), stride=(stride, 1), dilation=(dil, 1))
    assert got.shape[2] == -(-size // stride)
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("T", [2048, 1999])
def test_disc_apply_matches_jax(discs, T):
    jp, d, apply = discs
    real, _ = waves(T, T)
    jl, jf = apply(jp, jnp.asarray(real))
    with torch.no_grad():
        pl, pf = gan.disc_apply(d, GCFG, torch.from_numpy(real))
    assert len(pl) == len(jl) == len(GCFG.periods) + len(GCFG.fft_sizes)
    for i, (a, b) in enumerate(zip(pl, jl)):
        _close(a.numpy(), b, 1e-5)
        assert len(pf[i]) == len(jf[i])
        for fa, fb in zip(pf[i], jf[i]):
            _close(fa.numpy(), fb, 1e-5)


@pytest.mark.parametrize("kind", ["hinge", "lsgan"])
def test_adversarial_losses_match_jax(kind):
    rng = np.random.default_rng(1)
    shapes = [(2, 1, 13, 2), (2, 1, 9, 3), (2, 1, 129, 5)]
    r = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    f = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tr, tf = [torch.from_numpy(x) for x in r], [torch.from_numpy(x) for x in f]
    jr, jf = [jnp.asarray(x) for x in r], [jnp.asarray(x) for x in f]
    np.testing.assert_allclose(float(gan.disc_loss(tr, tf, kind)),
                               float(jgan.disc_loss(jr, jf, kind)), rtol=1e-6)
    np.testing.assert_allclose(float(gan.gen_adv_loss(tf, kind)),
                               float(jgan.gen_adv_loss(jf, kind)), rtol=1e-6)


def test_feature_matching_matches_jax(discs):
    jp, d, apply = discs
    real, fake = waves(3, 2048)
    _, jrf = apply(jp, jnp.asarray(real))
    _, jff = apply(jp, jnp.asarray(fake))
    with torch.no_grad():
        _, rf = gan.disc_apply(d, GCFG, torch.from_numpy(real))
        _, ff = gan.disc_apply(d, GCFG, torch.from_numpy(fake))
    np.testing.assert_allclose(float(gan.feature_matching_loss(rf, ff)),
                               float(jgan.feature_matching_loss(jrf, jff)), rtol=1e-6)
    assert float(gan.feature_matching_loss(rf, rf)) == 0.0


def test_gan_losses_gradient_toward_the_fake(discs):
    jp, d, _ = discs
    real, fake = waves(4, 2048)

    def jobj(f):
        adv, fm = jgan.gan_losses(jp, JGCFG, jnp.asarray(real), f)
        return adv + fm
    jg = np.asarray(jax.jit(jax.grad(jobj))(jnp.asarray(fake)))
    tf = torch.from_numpy(fake).requires_grad_(True)
    adv, fm = gan.gan_losses(d, GCFG, torch.from_numpy(real), tf)
    (g,) = torch.autograd.grad(adv + fm, tf)
    _close(g.numpy(), jg, 1e-4)
    assert np.any(jg != 0)
    assert all(p.grad is None for p in d.parameters())


def test_disc_init_draws_the_jax_distribution():
    d = gan.disc_init(GCFG, torch.Generator().manual_seed(0))
    assert set(convert.disc_template(GCFG)) == {p for p, _, _ in convert.disc_leaves(d)}
    for p, t, _ in convert.disc_leaves(d):
        fan_in = np.prod(convert.disc_template(GCFG)[p[:-1] + ("w",)][1:])
        bound = 1.0 / np.sqrt(fan_in)
        assert float(t.abs().max()) <= bound
        if t.numel() >= 64:
            assert float(t.abs().max()) > 0.9 * bound, p


def test_checkpoint_bytes_equal_flax(discs, tmp_path):
    """disc_last.msgpack and vq_counts.msgpack, written by each package from
    the same trees, are the same bytes; each reads back in the other."""
    jp, d, _ = discs
    jckpt.save_checkpoint(str(tmp_path / "j.msgpack"), jp, 3, {})
    checkpoint.save_checkpoint(str(tmp_path / "p.msgpack"), convert.disc_tree(d), 3, {})
    assert (tmp_path / "j.msgpack").read_bytes() == (tmp_path / "p.msgpack").read_bytes()
    back = convert.load_disc(str(tmp_path / "j.msgpack"), GCFG)
    for a, b in zip(back.parameters(), d.parameters()):
        assert torch.equal(a, b)

    counts = np.random.default_rng(0).uniform(0, 50, (4, 32)).astype(np.float32)
    jckpt.save_checkpoint(str(tmp_path / "jc.msgpack"), jnp.asarray(counts), 2, {})
    checkpoint.save_checkpoint(str(tmp_path / "pc.msgpack"), torch.from_numpy(counts), 2, {})
    assert (tmp_path / "jc.msgpack").read_bytes() == (tmp_path / "pc.msgpack").read_bytes()
    np.testing.assert_array_equal(
        checkpoint.load_vq_counts(str(tmp_path / "jc.msgpack"), (4, 32)), counts)
    with pytest.raises(ValueError):
        checkpoint.load_vq_counts(str(tmp_path / "jc.msgpack"), (4, 16))
    restored, ep, _ = jckpt.load_checkpoint(str(tmp_path / "pc.msgpack"),
                                            jnp.zeros((4, 32), jnp.float32))
    assert ep == 2 and np.array_equal(np.asarray(restored), counts)
    assert os.path.getsize(tmp_path / "p.msgpack") > 4 * sum(p.numel() for p in d.parameters())
