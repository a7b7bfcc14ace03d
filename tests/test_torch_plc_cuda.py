"""The concealment path on the card: K1 at the tiny evaluator's widths, and
``conceal`` / the evaluator's model calls on the card against the same calls
on the CPU (the plain path).

- K1 at the eight stack shapes of the tiny config at 1 s: the encoder's
  C 8/16/32/64 and the decoder's C 8/4/2/1 (``decoder_dim`` 16 halving per
  block), fp32 bit-equal to its plain version (run with TF32 off), bf16
  within 2e-2, each with its launch count.
- ``StreamingConcealer`` at the tiny config, fp32, on the card against the
  CPU within 1e-4 of the output's scale (cuDNN's convolutions outside the
  stacks sum in another order; TF32 is off in fp32), with 48 K1 launches a
  call; bf16 with 56, and under ``tail_kernel`` 28 K3 and 28 K1.
- A trained evidence head's ``forward_step`` and ``forward_zero_fill`` on a
  corpus pair, card against CPU; the DSP keeps a CUDA tensor on the card.

Marked ``cuda``: each test skips without a card. The file imports neither jax
nor the JAX package; on a machine with the card run it without the
repository's conftest (which sets up jax):

    python -m pytest --noconftest tests/test_torch_plc_cuda.py -q
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert, dsp
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingConcealer
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(ROOT, "artifacts", "evidence_tiny")
# (C, T, trailing snake) of every stack of the tiny config at 1 s
TINY_STACKS = [(8, 24000, True), (16, 12000, True), (32, 3000, True), (64, 600, True),
               (8, 600, False), (4, 3000, False), (2, 12000, False), (1, 24000, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def _units(c, seed, dev):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(7 * c)
    units = [resunit.ResUnit(c) for _ in resunit.DILATIONS]
    with torch.no_grad():
        for u in units:
            for p in (u.conv1.weight, u.conv1.bias, u.conv2.weight, u.conv2.bias):
                p.copy_(torch.from_numpy(rng.uniform(-bound, bound, p.shape).astype(np.float32)))
            for s in (u.snake1, u.snake2):
                s.alpha.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return [u.to(dev) for u in units]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,t,post", TINY_STACKS)
def test_k1_at_tiny_widths(cuda, dtype, c, t, post):
    units = _units(c, c + t, cuda)
    x = torch.randn(1, c, t, generator=torch.Generator().manual_seed(c)).to(cuda, dtype)
    pa = torch.full((c,), 0.9, device=cuda) if post else None
    with torch.no_grad():
        before = resunit.launches
        got = resunit.resunit_stack(units, x, resunit.DILATIONS, pa)
        launched = resunit.launches - before
        with fp32_exact():            # the plain version's cuDNN convolutions in true fp32
            ref = resunit.resunit_stack_ref(units, x, resunit.DILATIONS, pa)
    torch.cuda.synchronize()
    assert launched == resunit.stack_launches(3, dtype)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert torch.equal(got, ref)
    else:
        assert _rel(got, ref) <= 2e-2


def _tiny_plc(cfg=None):
    return plc.plc_init(cfg or CodecConfig().tiny(), torch.Generator().manual_seed(3), 2)


def _received(m, seed, batch=2):
    rng = np.random.default_rng(seed)
    a, tc = (0.3 * rng.standard_normal((2, batch, 1, 24000))).astype(np.float32)
    mk = masks.make_token_loss_mask(np.random.default_rng(seed + 1), batch, 75, 2, 0.5)
    with torch.no_grad():
        zt = m.tactile_dac.encoder(torch.from_numpy(tc)).numpy()
    return a, zt * ~mk[:, None, :], mk


@pytest.mark.cuda
def test_concealer_on_card_matches_cpu_fp32(cuda):
    m = _tiny_plc()
    a, zt, mk = _received(m, 5)
    cpu = StreamingConcealer(copy.deepcopy(m), batch=2, mask_embed=True, fast=False,
                             compute_dtype=torch.float32, device="cpu")
    card = StreamingConcealer(m, batch=2, mask_embed=True, fast=False,
                              compute_dtype=torch.float32)
    torch.cuda.synchronize()
    resunit.launches = 0
    y = card.conceal(a, zt, mk)
    torch.cuda.synchronize()
    assert resunit.launches == 8 * resunit.stack_launches(3, torch.float32) == 48
    assert y.device.type == "cuda" and y.shape == (2, 1, 24000)
    assert _rel(y, cpu.conceal(a, zt, mk)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [False, True], ids=["default", "tail_kernel"])
def test_concealer_bf16_launches(cuda, tail):
    cfg = CodecConfig().tiny()
    cfg = dataclasses.replace(cfg, dac=dataclasses.replace(cfg.dac, tail_kernel=tail))
    m = _tiny_plc(cfg)
    a, zt, mk = _received(m, 6)
    sc = StreamingConcealer(m, batch=2, mask_embed=True)
    torch.cuda.synchronize()
    resunit.launches = resunit_tm.launches = 0
    y = sc.conceal(a, zt, mk)
    torch.cuda.synchronize()
    per = resunit.stack_launches(3, torch.bfloat16)
    # every tiny stack is narrow: under tail_kernel all 8 go to K3
    assert (resunit.launches, resunit_tm.launches) == ((0, 8 * per) if tail else (8 * per, 0))
    assert bool(torch.isfinite(y).all())


@pytest.mark.cuda
def test_evidence_head_on_card_matches_cpu(cuda):
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils.wav_io import load_wav_mono

    m_cpu = convert.load_plc(os.path.join(EVIDENCE, "backbone", "best.msgpack"),
                             os.path.join(EVIDENCE, "plc_uniform"), CodecConfig().tiny(), 2)
    m_gpu = copy.deepcopy(m_cpu).to(cuda)
    a_raw, sr_a = load_wav_mono(os.path.join(EVIDENCE, "corpus", "audio", "pair_0003.wav"))
    t_raw, sr_t = load_wav_mono(os.path.join(EVIDENCE, "corpus", "tactile", "pair_0003.wav"))
    a = dsp.resample(a_raw, sr_a, 24000)[None]
    tc = dsp.resample(t_raw / np.abs(t_raw).max(), sr_t, 24000)[None]
    L = min(a.shape[-1], tc.shape[-1])
    a, tc = a[..., :L].clamp(-1, 1), tc[..., :L].clamp(-1, 1)
    mk = torch.from_numpy(masks.make_token_loss_mask(np.random.default_rng(7001), 1,
                                                     L // 320, 2, 0.5))
    for fn in (lambda mm, *x: plc.forward_step(mm, *x, mask_embed=True),
               plc.forward_zero_fill):
        ref = fn(m_cpu, a, tc, mk).y_hat
        got = fn(m_gpu, a.to(cuda), tc.to(cuda), mk.to(cuda)).y_hat
        assert _rel(got, ref) <= 1e-4


@pytest.mark.cuda
def test_dsp_keeps_a_card_tensor_on_the_card(cuda):
    x = torch.randn(2, 3000, generator=torch.Generator().manual_seed(0))
    for fn in (lambda v: dsp.resample(v, 3000, 24000), lambda v: dsp.mel_mag(v)):
        got = fn(x.to(cuda))
        assert got.device.type == "cuda"
        assert _rel(got, fn(x)) <= 1e-5
