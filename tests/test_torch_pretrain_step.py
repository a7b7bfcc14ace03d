"""One pretraining step of each kind against the JAX package's, on the CPU.

The trained tiny backbone of ``artifacts/evidence_tiny`` (``last.msgpack``
and its ``vq_counts.msgpack``: the log-mel term is badly conditioned on a
random decoder, ROADMAP.md "Not faults"), carried across by
``convert.dac_from_jax``; one batch of noisy tones from a numpy seed; the
generator's optimizer as ``pretrain_backbone`` builds it, with one warm-up
step so that the first step runs at the full 2e-4; JAX's steps with
``base_rng=None`` and the port's with ``base_seed=None`` (every example
through every book, no dropout draw). The GAN steps run two MPD periods and
two STFT sizes (the default ensemble is held to the JAX package's in
``tests/test_torch_gan.py``).

- ``pretrain_step``, ``warmup_step`` and ``gan_step``: the returned losses
  within 1e-5 relative; every backbone leaf (and, after a GAN step, every
  discriminator leaf) within 1e-5 of the JAX package's. Adam's first step
  moves an element by about ``lr * sign(g)``, so an element whose gradient
  sits at the fp32 floor (below 1e-4 of its leaf's largest; 5 of 328082
  elements here, every one of them off JAX's gradient by over 20%) may step
  the other way: those are held to Adam's own bound, ``2 * lr``, and must
  stay under 0.1% of the elements (for the discriminators the floor is
  1e-3 of the leaf's largest: their gradients agree to ~7e-4 only, the
  difference of a real and a fake term that nearly cancel);
- the reconstruction step's usage counts within 1e-6 relative, and no code
  reseeded by either package (the run's counts are warm);
- a warm-up step leaves the discriminators bit-equal; a GAN step leaves no
  gradient of the generator's loss on them.

Slow: ``pretrain_backbone`` for both recipes, resumed from the same
backbone with ``start_epoch=1`` and quantizer dropout off, 3 epochs in each
package: ``hist`` within 1e-4, the same files, each read by the JAX
package's loader.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import DacConfig as JDacConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import GanConfig as JGanConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import (
    TrainConfig as JTrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu.losses import gan as jgan
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu.train import pretrain_backbone as jpb
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    DacConfig, GanConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses import gan
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import checkpoint
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import pretrain_backbone as pb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = os.path.join(ROOT, "artifacts", "evidence_tiny", "backbone")
CFG, JCFG = DacConfig().tiny(), JDacConfig().tiny()
GAN_KW = dict(periods=(2, 3), fft_sizes=(256, 512))
GCFG, JGCFG = GanConfig(**GAN_KW), JGanConfig(**GAN_KW)
TCFG = TrainConfig(batch=2, epochs=2, adam_b1=0.8, adam_b2=0.99)
JTCFG = JTrainConfig(batch=2, epochs=2, adam_b1=0.8, adam_b2=0.99)
LR, TOTAL, WARMUP = 2e-4, 10, 1
# |g| below this share of its leaf's largest sits at the fp32 floor. The
# discriminators' gradients agree to ~7e-4 of their largest only: their
# hinge gradient is the difference of a real and a fake term that nearly
# cancel when the backbone reconstructs well, and the STFT discriminators
# take two packages' FFTs.
NOISE_FLOOR, DISC_NOISE_FLOOR = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Six test workers share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tones(seed, B=2, T=3200):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 24000.0
    x = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 2000, (B, 1, 1)) * t) \
        + 0.05 * rng.standard_normal((B, 1, T))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def start():
    tree, _, _ = checkpoint.load_checkpoint(os.path.join(BACKBONE, "last.msgpack"),
                                            convert.dac_template(CFG))
    jp = jax.tree.map(jnp.asarray, tree)
    counts = checkpoint.load_vq_counts(os.path.join(BACKBONE, "vq_counts.msgpack"),
                                       (CFG.n_codebooks, CFG.codebook_size))
    jd = jgan.disc_init(jax.random.key(1), JGCFG)
    return jp, counts, jd


def jax_tx(lr_or_schedule, b1, b2, **kw):
    return optax.apply_if_finite(optax.chain(
        optax.clip_by_global_norm(JTCFG.grad_clip),
        optax.adamw(lr_or_schedule, b1=b1, b2=b2, **kw)), max_consecutive_errors=10**6)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def leaves_close(leaves, jtree, lr, floor=NOISE_FLOOR):
    """Every leaf within 1e-5 of the JAX tree's, but the elements whose
    gradient sits at the floor, which are held to 2 * lr."""
    n_noise = n_all = 0
    for p, t, kind in leaves:
        got, g = t.detach(), t.grad
        if kind == "t01":
            got, g = got.transpose(0, 1), g.transpose(0, 1)
        got, g, ref = got.numpy(), g.numpy(), _at(jtree, p)
        noise = np.abs(g) <= floor * np.abs(g).max()
        off = np.abs(got - ref) > 1e-5
        name = "/".join(map(str, p))
        assert not (off & ~noise).any(), name
        np.testing.assert_allclose(got[noise], ref[noise], rtol=0, atol=2 * lr + 1e-5,
                                   err_msg=name)
        n_noise += int(off.sum())
        n_all += off.size
    assert n_noise <= 1e-3 * n_all


def port_state(jp, counts=None, jd=None):
    m = convert.dac_from_jax(jax.tree.map(np.asarray, jp), CFG)
    opt = pb.generator_optimizer(m, TCFG, pb.warmup_cosine_lr(LR, TOTAL, WARMUP,
                                                              TCFG.lr_min_frac))
    d = None if jd is None else convert.disc_from_jax(jax.tree.map(np.asarray, jd), GCFG)
    return pb.PretrainState(m, opt, vq_counts=None if counts is None
                            else torch.from_numpy(counts.copy()),
                            d=d, d_opt=None if d is None else pb.disc_optimizer(d, TCFG, GCFG))


def test_pretrain_step_matches_jax(start):
    jp, counts, _ = start
    x = tones(0)
    tx = jax_tx(jpb.warmup_cosine_lr(LR, TOTAL, WARMUP, JTCFG.lr_min_frac), 0.8, 0.99,
                weight_decay=JTCFG.weight_decay)
    jstep, _ = jpb.make_pretrain_step(JCFG, JTCFG, tx)
    P = jax.tree.map(jnp.array, jp)
    jst, jout = jstep(jpb.PretrainState(P, tx.init(P), jnp.zeros((), jnp.int32),
                                        jnp.asarray(counts)), jnp.asarray(x))

    st = port_state(jp, counts)
    step, _ = pb.make_pretrain_step(CFG, TCFG)
    out = step(st, torch.from_numpy(x), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5)
    assert st.step == 1 and int(st.opt.count) == 1
    # warm counts: after one decay every code stays above the reseed line
    # (0.1 x the uniform share of 20 tokens), so neither package reseeds one
    assert 0.99 * counts.min() > 0.1 * x.shape[0] * 10 / CFG.codebook_size
    leaves_close(convert.dac_leaves(st.m), jax.tree.map(np.asarray, jst.params), LR)
    np.testing.assert_allclose(st.vq_counts.numpy(), np.asarray(jst.vq_counts), rtol=1e-6)


@pytest.mark.parametrize("kind", ["warmup", "gan"])
def test_gan_recipe_steps_match_jax(start, kind):
    jp, _, jd = start
    x = tones(1)
    tx = jax_tx(jpb.warmup_cosine_lr(LR, TOTAL, WARMUP, JTCFG.lr_min_frac), 0.8, 0.99,
                weight_decay=JTCFG.weight_decay)
    tx_d = jax_tx(JGCFG.disc_lr, JGCFG.disc_b1, JGCFG.disc_b2)
    jgan_step, jwarm, _ = jpb.make_gan_pretrain_step(JCFG, JTCFG, JGCFG, tx, tx_d)
    P, D = jax.tree.map(jnp.array, jp), jax.tree.map(jnp.array, jd)
    jst, jout = (jgan_step if kind == "gan" else jwarm)(
        jpb.GanPretrainState(P, tx.init(P), D, tx_d.init(D), jnp.zeros((), jnp.int32)),
        jnp.asarray(x))

    st = port_state(jp, jd=jd)
    gan_step, warmup_step, _ = pb.make_gan_pretrain_step(CFG, TCFG, GCFG)
    d0 = [p.detach().clone() for p in st.d.parameters()]
    if kind == "warmup":
        out = warmup_step(st, torch.from_numpy(x), None)
        assert all(torch.equal(a, b) for a, b in zip(d0, st.d.parameters()))
        assert all(p.grad is None for p in st.d.parameters())
    else:
        # the generator's gradient reaches no discriminator leaf: D's .grad
        # holds the discriminator loss's gradient alone
        real = torch.from_numpy(x)
        with torch.no_grad():
            y = pb._recon(st.m, CFG, real, None, 0.25, 1.0, False)["y"]
        d_copy = convert.disc_from_jax(jax.tree.map(np.asarray, jd), GCFG)
        rl, _ = gan.disc_apply(d_copy, GCFG, real)
        fl, _ = gan.disc_apply(d_copy, GCFG, y)
        d_grads = torch.autograd.grad(gan.disc_loss(rl, fl, GCFG.loss_kind),
                                      list(d_copy.parameters()))
        out = gan_step(st, real, None)
        for p, g in zip(st.d.parameters(), d_grads):
            torch.testing.assert_close(p.grad, g, rtol=1e-4, atol=1e-4 * float(g.abs().max()))
        leaves_close(convert.disc_leaves(st.d), jax.tree.map(np.asarray, jst.d_params),
                     GCFG.disc_lr, DISC_NOISE_FLOOR)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-7)
    leaves_close(convert.dac_leaves(st.m), jax.tree.map(np.asarray, jst.params), LR)


# ------------------------------------------------------------- whole runs

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both recipes in both packages, 3 epochs each from the trained tiny
    backbone (epoch 1 the GAN recipe's warm-up)."""
    tr = [tones(10 + i) for i in range(2)]
    va = [tones(20)]
    # the start: the backbone, its counts and one JAX-initialised
    # discriminator ensemble, which both packages resume
    begin = tmp_path_factory.mktemp("start")
    for name in ("last.msgpack", "vq_counts.msgpack"):
        shutil.copy(os.path.join(BACKBONE, name), begin / name)
    jckpt.save_checkpoint(str(begin / "disc_last.msgpack"),
                          jgan.disc_init(jax.random.key(5), JGCFG), 0, {})
    out = {}
    for recipe in ("recon", "gan"):
        for side in ("jax", "port"):
            d = str(tmp_path_factory.mktemp(f"{recipe}_{side}"))
            kw = dict(train_batches=lambda ep: iter(tr), val_batches=lambda: iter(va),
                      out_dir=d, seed=3, steps_per_epoch=2, nq_dropout=False,
                      resume_from=str(begin / "last.msgpack"), start_epoch=1,
                      log=lambda s: None)
            if side == "jax":
                g = None if recipe == "recon" else JGanConfig(**GAN_KW, start_epoch=2)
                hist = jpb.pretrain_backbone(JCFG, JTrainConfig(epochs=3, batch=2), gan=g,
                                             **kw)
            else:
                g = None if recipe == "recon" else GanConfig(**GAN_KW, start_epoch=2)
                hist = pb.pretrain_backbone(CFG, TrainConfig(epochs=3, batch=2), gan=g,
                                            device="cpu", **kw)
            out[recipe, side] = (d, hist)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("recipe", ["recon", "gan"])
def test_pretrain_backbone_matches_jax(runs, recipe):
    (jd, jh), (pd, ph) = runs[recipe, "jax"], runs[recipe, "port"]
    assert sorted(ph) == sorted(jh) == ["train", "val"]
    for k in jh:
        np.testing.assert_allclose(ph[k], jh[k], rtol=1e-4, err_msg=k)
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    template = jdac.dac_init(jax.random.key(0), JCFG)
    for name in ("last.msgpack", "best.msgpack"):
        jt, jep, jhist = jckpt.load_checkpoint(os.path.join(jd, name), template)
        pt, pep, phist = jckpt.load_checkpoint(os.path.join(pd, name), template)
        assert pep == jep and sorted(phist) == sorted(jhist)
        for a, b in zip(jax.tree.leaves(pt), jax.tree.leaves(jt)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-4)
    if recipe == "recon":
        z = jnp.zeros((CFG.n_codebooks, CFG.codebook_size), jnp.float32)
        pc, _, _ = jckpt.load_checkpoint(os.path.join(pd, "vq_counts.msgpack"), z)
        jc, _, _ = jckpt.load_checkpoint(os.path.join(jd, "vq_counts.msgpack"), z)
        np.testing.assert_allclose(np.asarray(pc), np.asarray(jc), rtol=1e-5)
    else:
        dt = jgan.disc_init(jax.random.key(0), JGCFG)
        pdisc, _, _ = jckpt.load_checkpoint(os.path.join(pd, "disc_last.msgpack"), dt)
        assert jax.tree.structure(pdisc) == jax.tree.structure(dt)
