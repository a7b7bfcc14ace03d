"""The PLC trainer on the card.

- One ``make_plc_train_step`` waveform step with the frozen encoders through
  K1 (48 fp32 launches: two encoders, 4 stacks each) against the same step
  with every stack through the plain versions (no launch): loss within 1e-6
  relative, every head gradient within 1e-4 of its leaf's largest; at the
  tiny configuration and at full width.
- A cached step and the decoder-free latent step on cached latents launch no
  kernel.
- ``train_plc`` (one decoder-free epoch, one full) and
  ``finetune_inpaint_decoder`` on the card, tiny: the run's files, only the
  decoder copy changed.

Marked ``cuda``: each test skips without a card. The file imports neither
jax nor the JAX package; on the machine with the card run it without the
repository's conftest:

    python -m pytest --noconftest tests/test_torch_plc_train_cuda.py -q
"""

import contextlib
import copy
import os

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, LossConfig, PLCConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar, dac
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm, vq
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import train
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train.loop import AdamW

TCFG = TrainConfig(batch=2, seg_sec=4800 / 24000, best_after_epoch=0,
                   loss=LossConfig(w_plc_latent=1.0, w_plc_masked=0.5))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_stacks():
    dac.resunit_stack = resunit.resunit_stack_ref
    try:
        yield
    finally:
        dac.resunit_stack = resunit.resunit_stack


def _launches() -> list:
    return [resunit.launches, resunit_tm.launches, vq.launches]


def _model(cfg, dev):
    m = plc.plc_init(cfg, torch.Generator().manual_seed(3), n_layers=2).to(dev)
    m.requires_grad_(False)
    m.head.requires_grad_(True)
    with torch.no_grad():
        m.head.mask_embed.normal_(0, 0.5, generator=torch.Generator(dev).manual_seed(1))
    return m


def _inputs(dev, T=4800, B=2):
    rng = np.random.default_rng(5)
    a, tc = (torch.from_numpy((0.3 * rng.standard_normal((B, 1, T))).astype(np.float32)).to(dev)
             for _ in range(2))
    mk = torch.from_numpy(masks.make_token_loss_mask(rng, B, T // 320, 2, 0.5)).to(dev)
    return a, tc, mk


def _step(m, x, tc, mk, cfg, which=0):
    head = copy.deepcopy(m.head)
    state = train.PLCTrainState(head, AdamW(list(head.parameters()), TCFG, 1))
    fn = train.make_plc_train_step(cfg, TCFG, mask_embed=True)[which]
    before = _launches()
    with fp32_exact():
        metrics = fn(state, {"audio": m.audio_dac, "tactile": m.tactile_dac}, x, tc, mk, None)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in head.named_parameters()
             if p.grad is not None}
    return metrics, grads, [x - y for x, y in zip(_launches(), before)]


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_k1_plc_step_equals_the_plain_stack_step(cuda, width):
    cfg = CodecConfig().tiny() if width == "tiny" else CodecConfig()
    m = _model(cfg, cuda)
    a, tc, mk = _inputs(cuda, T=4800 if width == "tiny" else 24000)
    got, g_got, n_k1 = _step(m, a, tc, mk, cfg)
    with plain_stacks():
        ref, g_ref, n_plain = _step(m, a, tc, mk, cfg)
    assert n_k1 == [48, 0, 0] and n_plain == [0, 0, 0]
    assert abs(float(got[0]) / float(ref[0]) - 1.0) <= 1e-6
    assert g_got.keys() == g_ref.keys() and len(g_got) > 0
    for n, g in g_ref.items():
        assert bool(torch.isfinite(g_got[n]).all())
        err = float((g_got[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
        assert err <= 1e-4, (n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 2], ids=["full_step", "latent_step"])
def test_cached_plc_steps_launch_no_kernel(cuda, which):
    cfg = CodecConfig().tiny()
    m = _model(cfg, cuda)
    a, tc, mk = _inputs(cuda)
    with torch.no_grad(), fp32_exact():
        qa, zt = allpred_ar.backbone_latents(m, a, tc, cfg)
    metrics, grads, n = _step(m, (qa, zt), tc, mk, cfg, which)
    assert n == [0, 0, 0] and bool(torch.isfinite(metrics).all()) and grads


@pytest.mark.cuda
def test_train_plc_and_decoder_ft_on_card(cuda, tmp_path):
    cfg = CodecConfig().tiny()
    m = _model(cfg, torch.device("cpu"))
    batches = [_inputs(torch.device("cpu"))[:2]]
    bb = {"audio": m.audio_dac, "tactile": m.tactile_dac}
    pcfg = PLCConfig(mask_embed=True, n_layers=2)
    hist = train.train_plc(cfg, TrainConfig(epochs=2, **{k: getattr(TCFG, k) for k in (
        "batch", "seg_sec", "best_after_epoch", "loss")}), pcfg, bb, lambda ep: iter(batches),
        lambda: iter(batches), str(tmp_path), latent_pretrain_epochs=1, log=lambda s: None)
    assert len(hist["train"]) == 2 and all(np.isfinite(hist["val"]))
    for f in ("last.msgpack", "best.msgpack", "hist.json", "meta.json"):
        assert os.path.exists(tmp_path / f)
    assert train.plc_config_from_meta(str(tmp_path)) == pcfg
    before = {k: v.clone() for k, v in m.state_dict().items()}
    dh = train.finetune_inpaint_decoder(cfg, TCFG, pcfg, bb, m.head, lambda ep: iter(batches),
                                        lambda: iter(batches), str(tmp_path), epochs=1,
                                        log=lambda s: None)
    assert len(dh["train"]) == 1 and os.path.exists(tmp_path / "dec_plc.msgpack")
    for k, v in m.state_dict().items():
        assert torch.equal(v.cpu(), before[k].cpu()), k
