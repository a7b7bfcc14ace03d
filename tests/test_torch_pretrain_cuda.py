"""Backbone pretraining on the card.

- The serving ``Encoder.forward`` in grad mode raises on the card (its
  stacks go through K1, which has no backward), while
  ``Encoder.forward_train`` (plain stacks) gives the same latents within
  1e-5 and trains.
- One tiny step of each kind (reconstruction, GAN warm-up, GAN) on the card
  against the same step on the CPU, from the trained tiny backbone of
  ``artifacts/evidence_tiny``: the returned losses within 1e-5 relative;
  the backbone's gradients within 1e-3 of each leaf's largest (1.8e-4
  measured), the discriminators' within 1e-2 (2.9e-3 measured: their
  hinge gradient is the difference of a real and a fake term that nearly
  cancel when the backbone reconstructs well, so the gap of the two terms'
  rounding stands against a small difference); every leaf within 1e-5 of
  the CPU's, but the elements whose gradient lies within that gap, which
  Adam's first step may move the other way, held to 2 * lr.
- The launches: a train step of each kind launches no kernel; the eval step
  launches K1 48 times (the encoder's and the decoder's 4 fp32 stacks),
  and K2 and K3 never.
- ``pretrain_backbone`` (both recipes) and the script on the card, tiny,
  two epochs: every file written.

Marked ``cuda``: each test skips without a card. The file imports neither
jax nor the JAX package; on the machine with the card run it without the
repository's conftest:

    python -m pytest --noconftest tests/test_torch_pretrain_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    DacConfig, GanConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses import gan
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm, vq
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts import (
    pretrain_backbone as script)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import checkpoint
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import pretrain_backbone as pb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = os.path.join(ROOT, "artifacts", "evidence_tiny", "backbone")
CFG = DacConfig().tiny()
GCFG = GanConfig(periods=(2, 3), fft_sizes=(256, 512))
TCFG = TrainConfig(batch=2, epochs=2, adam_b1=0.8, adam_b2=0.99)
LR = 2e-4
KERNELS = (resunit, resunit_tm, vq)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def tones(seed, B=2, T=3200):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 24000.0
    x = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 2000, (B, 1, 1)) * t) \
        + 0.05 * rng.standard_normal((B, 1, T))
    return torch.from_numpy(x.astype(np.float32))


def state(dev, with_counts=False, with_disc=False):
    m = convert.load_dac(os.path.join(BACKBONE, "last.msgpack"), CFG).to(dev)
    opt = pb.generator_optimizer(m, TCFG, pb.warmup_cosine_lr(LR, 10, 1, 0.1))
    counts = None
    if with_counts:
        counts = torch.from_numpy(checkpoint.load_vq_counts(
            os.path.join(BACKBONE, "vq_counts.msgpack"), (4, 32))).to(dev)
    d = d_opt = None
    if with_disc:
        d = gan.disc_init(GCFG, torch.Generator().manual_seed(1)).to(dev)
        d_opt = pb.disc_optimizer(d, TCFG, GCFG)
    return pb.PretrainState(m, opt, vq_counts=counts, d=d, d_opt=d_opt)


def launches():
    return tuple(k.launches for k in KERNELS)


def step_fn(kind):
    if kind == "recon":
        return pb.make_pretrain_step(CFG, TCFG)[0]
    gan_step, warmup_step, _ = pb.make_gan_pretrain_step(CFG, TCFG, GCFG)
    return gan_step if kind == "gan" else warmup_step


def leaves_close(got_leaves, ref_leaves, lr, grad_tol):
    """The card's leaves against the CPU's after one step: the gradients
    within ``grad_tol`` of each leaf's largest, and every leaf within 1e-5
    but where the gradient lies within the two gradients' largest gap, so
    that Adam's first step (about lr * g / |g|) may go another way: there
    within 2 * lr, at most 0.1% of the elements."""
    n_off = n_all = 0
    for (p, t, _), (_, r, _) in zip(got_leaves, ref_leaves):
        name = "/".join(map(str, p))
        got, ref, g, g_ref = t.detach().cpu(), r.detach(), t.grad.cpu(), r.grad
        gap = float((g - g_ref).abs().max())
        assert gap <= grad_tol * float(g_ref.abs().max()), name
        noise = g_ref.abs() <= gap
        off = (got - ref).abs() > 1e-5
        assert not bool((off & ~noise).any()), name
        assert bool(((got - ref)[noise].abs() <= 2 * lr + 1e-5).all()), name
        n_off += int(off.sum())
        n_all += off.numel()
    assert n_off <= 1e-3 * n_all


@pytest.mark.cuda
def test_serving_encoder_refuses_grad_and_forward_train_trains(cuda):
    m = convert.load_dac(os.path.join(BACKBONE, "last.msgpack"), CFG).to(cuda)
    x = tones(0).to(cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        m.encoder(x)
    with fp32_exact():
        with torch.no_grad():
            ref = m.encoder(x)
        before = launches()
        z = m.encoder.forward_train(x)
        assert launches() == before
        torch.testing.assert_close(z.detach(), ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
        z.square().mean().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               and bool(p.grad.abs().sum() > 0) for p in m.encoder.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["recon", "warmup", "gan"])
def test_one_step_on_the_card_equals_the_cpu(cuda, kind):
    x = tones(1)
    outs, states = {}, {}
    for dev in ("cpu", cuda):
        st = state(dev, with_counts=kind == "recon", with_disc=kind != "recon")
        with fp32_exact(dev != "cpu"):
            before = launches()
            outs[dev] = step_fn(kind)(st, x.to(dev), None).cpu()
            assert launches() == before, "a train step launched a kernel"
        states[dev] = st
    torch.testing.assert_close(outs[cuda], outs["cpu"], rtol=1e-5, atol=1e-7)
    leaves_close(convert.dac_leaves(states[cuda].m), convert.dac_leaves(states["cpu"].m), LR,
                 1e-3)
    if kind == "recon":
        torch.testing.assert_close(states[cuda].vq_counts.cpu(), states["cpu"].vq_counts,
                                   rtol=1e-6, atol=1e-6)
    if kind == "gan":
        leaves_close(convert.disc_leaves(states[cuda].d), convert.disc_leaves(states["cpu"].d),
                     GCFG.disc_lr, 1e-2)


@pytest.mark.cuda
def test_eval_step_launches_k1_48_times(cuda):
    st = state(cuda)
    _, eval_step = pb.make_pretrain_step(CFG, TCFG)
    x = tones(2).to(cuda)
    with fp32_exact():
        for k in KERNELS:
            k.launches = 0
        total = eval_step(st.m, x)
        assert launches() == (48, 0, 0)
        with torch.no_grad():       # the same loss through the plain stacks
            plain = pb._recon(st.m, CFG, x, None, 0.25, 1.0, True)["total"]
    assert bool(torch.isfinite(total))
    assert abs(float(total) - float(plain)) <= 1e-5 * abs(float(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["recon", "gan"])
def test_pretrain_backbone_on_the_card(cuda, tmp_path, recipe):
    batches = [tones(10 + i).numpy() for i in range(2)]
    hist = pb.pretrain_backbone(CFG, TrainConfig(epochs=2, batch=2), lambda ep: iter(batches),
                                lambda: iter(batches[:1]), str(tmp_path), steps_per_epoch=2,
                                gan=GCFG if recipe == "gan" else None, log=lambda s: None)
    assert len(hist["train"]) == 2 and all(np.isfinite(hist["train"] + hist["val"]))
    want = {"last.msgpack", "best.msgpack", "hist.json",
            "vq_counts.msgpack" if recipe == "recon" else "disc_last.msgpack"}
    assert want <= set(os.listdir(tmp_path))
    convert.load_dac(str(tmp_path / "last.msgpack"), CFG)


@pytest.mark.cuda
@pytest.mark.parametrize("gan_flag", [[], ["--gan", "--gan-start-epoch", "2"]])
def test_script_on_the_card(cuda, tmp_path, gan_flag):
    hist = script.main(["--tiny", "--stream", "2", "--epochs", "2", "--batch", "2",
                        "--out-dir", str(tmp_path)] + gan_flag)
    assert len(hist["val"]) == 2 and all(np.isfinite(hist["val"]))
    assert {"last.msgpack", "best.msgpack", "hist.json"} <= set(os.listdir(tmp_path))
