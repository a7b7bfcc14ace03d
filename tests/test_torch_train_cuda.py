"""The codec-head training path on the card.

- F4: a K1 or K3 call that autograd would record raises (the kernels have
  no backward; the result used to come back detached, cutting the
  gradient), while the same call under ``no_grad`` runs, and the serving
  decoder in grad mode raises where the training decoder trains.
- One tiny-configuration train step on the card (encoders through K1 in
  fp32, decoder through the plain stacks with autograd) equals the same
  step on the CPU: loss within 1e-5, every head gradient within 1e-4 of
  its leaf's largest element.
- ``train_codec`` on the card, tiny, two epochs: last/best/hist written.
- The latent cache: its build launches K1 (the two frozen encoders' 8 fp32
  stacks: 48 launches a batch); a cached train step and a cached eval step
  launch no kernel at all, and the cached step on the card equals the same
  step on the CPU (loss within 1e-5, gradients within 1e-4 of a leaf's
  largest); ``train_codec(cache=...)`` on the card writes the run.

Marked ``cuda``: each test skips without a card. The file imports neither
jax nor the JAX package; on the machine with the card run it without the
repository's conftest:

    python -m pytest --noconftest tests/test_torch_train_cuda.py -q
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, DacConfig, PredictorConfig, RVQConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm, vq
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import latent_cache as lc
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import loop

CFG = CodecConfig(dac=DacConfig().tiny(), predictor=PredictorConfig(dim=64, heads=8),
                  rvq=RVQConfig(code_dim=16, n_books=2, n_embed=16, dead_frac=0.0),
                  ar_chunk_tok=4)
CFG_EMA1 = dataclasses.replace(CFG, rvq=dataclasses.replace(CFG.rvq, ema_warm_epochs=1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _units(c, dev):
    torch.manual_seed(c)
    return [resunit.ResUnit(c).to(dev) for _ in resunit.DILATIONS]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_first", "time_major"])
def test_kernels_refuse_a_recorded_call(cuda, layout):
    units = _units(16, cuda)
    x = torch.randn(1, 16, 300, device=cuda)
    fn = resunit.resunit_stack if layout == "channels_first" else resunit_tm.resunit_stack_tm
    counter = resunit if layout == "channels_first" else resunit_tm
    xin = x if layout == "channels_first" else x.transpose(1, 2).contiguous()
    before = counter.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(units, xin)
    with pytest.raises(RuntimeError, match="no backward"):
        fn([u.requires_grad_(False) for u in units], xin.clone().requires_grad_(True))
    assert counter.launches == before                  # nothing was launched
    with torch.no_grad():
        y = fn(units, xin)
    assert counter.launches == before + 6 and y.grad_fn is None
    y2 = fn(units, xin)                                # frozen weights, plain x: fine
    assert torch.equal(y, y2)


@pytest.mark.cuda
def test_serving_decoder_refuses_grad_and_training_decoder_trains(cuda):
    m = allpred_ar.codec_init(CFG, torch.Generator().manual_seed(0)).to(cuda)
    z = torch.randn(1, 64, 15, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        m.tactile_dac.decoder(z)
    before = resunit.launches
    y = m.tactile_dac.decoder.forward_train(z)
    y.square().mean().backward()
    assert resunit.launches == before
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in m.tactile_dac.decoder.parameters())


def _batch(seed, B=2, T=4800):
    rng = np.random.default_rng(seed)
    a = (0.2 * rng.standard_normal((B, 1, T))).astype(np.float32)
    tc = np.clip(0.5 * a + 0.05 * rng.standard_normal((B, 1, T)), -1, 1).astype(np.float32)
    return a, tc


def _one_step(m, dev, a, tc):
    m = copy.deepcopy(m).to(dev)
    m.audio_dac.requires_grad_(False)
    m.tactile_dac.requires_grad_(False)
    tcfg = TrainConfig(epochs=2, batch=2)
    state = loop.TrainState(m, loop.AdamW(loop.adamw_params(m.head), tcfg, 1))
    step, _ = loop.make_step_fns(CFG, tcfg)
    before = resunit.launches
    with fp32_exact(dev.type == "cuda"):
        metrics = step(state, torch.from_numpy(a).to(dev), torch.from_numpy(tc).to(dev), None,
                       do_ema=True)
    grads = {n: p.grad.cpu() for n, p in m.head.named_parameters() if p.grad is not None}
    return metrics.cpu(), grads, resunit.launches - before, m.head.vq_books.detach().cpu()


@pytest.mark.cuda
def test_train_step_on_card_equals_cpu(cuda):
    m = allpred_ar.codec_init(CFG, torch.Generator().manual_seed(1))
    a, tc = _batch(2)
    got, g_got, launched, books = _one_step(m, cuda, a, tc)
    ref, g_ref, _, books_ref = _one_step(m, torch.device("cpu"), a, tc)
    assert launched == 2 * 4 * 6                       # two encoders, 4 fp32 stacks each
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    assert g_got.keys() == g_ref.keys() and "vq_books" not in g_got
    for n in g_ref:
        err = float((g_got[n] - g_ref[n]).abs().max() / g_ref[n].abs().max().clamp_min(1e-30))
        assert err <= 1e-4, (n, err)
    assert not torch.equal(books, m.head.vq_books.detach())       # the EMA step ran


@pytest.mark.cuda
def test_train_codec_on_card_writes_the_run(cuda, tmp_path):
    rng = np.random.default_rng(3)
    batches = [_batch(int(s)) for s in rng.integers(0, 100, 2)]
    m = allpred_ar.codec_init(CFG, torch.Generator().manual_seed(2))
    hist = loop.train_codec(CFG_EMA1, TrainConfig(epochs=2, batch=2, best_after_epoch=0),
                            {"audio": m.audio_dac, "tactile": m.tactile_dac},
                            train_batches=lambda ep: iter(batches),
                            val_batches=lambda: iter(batches[:1]), out_dir=str(tmp_path),
                            log=lambda s: None)
    assert hist["ema"] == [0.0, 1.0] and all(np.isfinite(hist["train"]))
    for f in ("last.msgpack", "best.msgpack", "hist.json"):
        assert os.path.exists(tmp_path / f)



def _launches() -> tuple:
    return resunit.launches, resunit_tm.launches, vq.launches


def _cached_step(m, cache, dev, launched):
    m = copy.deepcopy(m).to(dev)
    m.audio_dac.requires_grad_(False)
    m.tactile_dac.requires_grad_(False)
    cache = cache.to(dev)
    tcfg = TrainConfig(epochs=2, batch=2)
    state = loop.TrainState(m, loop.AdamW(loop.adamw_params(m.head), tcfg, 1))
    step, eval_step = loop.make_step_fns(CFG, tcfg)
    qa, zt, tc = lc.gather_crops(cache, torch.tensor([1, 0], device=dev),
                                 torch.tensor([2, 0], device=dev), 10, CFG.dac.hop)
    before = _launches()
    with fp32_exact(dev.type == "cuda"):
        metrics = step(state, (qa, zt), tc, None, do_ema=True)
        with torch.no_grad():
            eval_step(m, (qa, zt), tc)
    launched.append([x - y for x, y in zip(_launches(), before)])
    grads = {n: p.grad.cpu() for n, p in m.head.named_parameters() if p.grad is not None}
    return metrics.cpu(), grads


@pytest.mark.cuda
def test_cache_build_launches_k1_and_a_cached_step_none(cuda):
    m = allpred_ar.codec_init(CFG, torch.Generator().manual_seed(4))
    batches = [_batch(10), _batch(11)]
    bb = {"audio": copy.deepcopy(m.audio_dac), "tactile": copy.deepcopy(m.tactile_dac)}
    before = resunit.launches
    cache = lc.build_latent_cache(bb, CFG, iter(batches))
    assert resunit.launches - before == 2 * 2 * 4 * 6       # 2 batches, 2 encoders x 4 stacks
    assert cache.qa.device.type == "cuda" and cache.qa.shape == (4, 64, 15)
    ref_cache = lc.build_latent_cache({k: copy.deepcopy(v) for k, v in bb.items()}, CFG,
                                      iter(batches), device="cpu")
    assert _rel(cache.qa, ref_cache.qa) <= 1e-5 and _rel(cache.zt, ref_cache.zt) <= 1e-5
    launched = []
    got, g_got = _cached_step(m, cache, cuda, launched)
    ref, g_ref = _cached_step(m, cache, torch.device("cpu"), launched)
    assert launched[0] == [0, 0, 0]
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    assert g_got.keys() == g_ref.keys()
    for n in g_ref:
        err = float((g_got[n] - g_ref[n]).abs().max() / g_ref[n].abs().max().clamp_min(1e-30))
        assert err <= 1e-4, (n, err)


@pytest.mark.cuda
def test_train_codec_on_the_cache_on_card(cuda, tmp_path):
    m = allpred_ar.codec_init(CFG, torch.Generator().manual_seed(5))
    bb = {"audio": m.audio_dac, "tactile": m.tactile_dac}
    cache = lc.build_latent_cache(bb, CFG, iter([_batch(20), _batch(21), _batch(22)]))
    before = _launches()
    hist = loop.train_codec(CFG_EMA1, TrainConfig(epochs=2, batch=2, best_after_epoch=0), bb,
                            None, None, str(tmp_path), cache=cache, cache_train_rows=[0, 1, 2, 3],
                            cache_val_rows=[4, 5], seg_tok=10, val_steps=1, log=lambda s: None)
    assert [x - y for x, y in zip(_launches(), before)] == [0, 0, 0]
    assert hist["ema"] == [0.0, 1.0] and all(np.isfinite(hist["train"] + hist["val"]))
    for f in ("last.msgpack", "best.msgpack", "hist.json"):
        assert os.path.exists(tmp_path / f)


def _rel(got, ref):
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))
