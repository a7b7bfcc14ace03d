"""``StreamingConcealer`` against the JAX package's, on the CPU.

The port's concealer and the JAX package's on the same weights and numpy
inputs, fp32 with ``fast=False`` (as ``tests/test_serving.py``'s concealer
test), in the default layout and under each layout flag: ``time_major`` and
``poly_upsample`` given to both constructors, ``tail_kernel`` and
``time_major_enc`` in the config of both (the JAX package reads them from
``cfg``, the port from its modules' config). The waveforms agree within 1e-4
of their scale. In bf16 the predictor's output stays within docs/PARITY.md's
continuous-latent 2.5e-2 of fp32. ``throughput_frames_per_sec`` of both
serving classes reports the JAX package's keys; the default device is the
card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.eval.serving import (
    StreamingConcealer as JStreamingConcealer)
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.plc import model as jplc
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import (
    StreamingCodec, StreamingConcealer)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc

from test_torch_plc import HEADS, BACKBONE, _close, _jax_params, _jax_trained
from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)

FRAME = 3200
LAYOUTS = [
    {},
    dict(time_major=True, time_major_enc=True, tail_kernel=True, poly_upsample=True),
    dict(tail_kernel=True),
    dict(time_major=True, time_major_enc=True),
    dict(poly_upsample=True),
]
CTOR = ("time_major", "poly_upsample")      # constructor flags; the others ride in cfg


def _with_cfg_flags(cfg, flags):
    cfg_flags = {k: v for k, v in flags.items() if k not in CTOR}
    return dataclasses.replace(cfg, dac=dataclasses.replace(cfg.dac, **cfg_flags))


@pytest.fixture(scope="module")
def params():
    jp, jcfg = _jax_params(2)
    return jp, jcfg


@pytest.mark.parametrize("flags", LAYOUTS, ids=lambda f: "+".join(sorted(f)) or "default")
def test_concealer_matches_jax(params, flags):
    jp, jcfg = params
    jcfg = _with_cfg_flags(jcfg, flags)
    m = convert.plc_params_from_jax(jax.tree.map(np.asarray, jp),
                                    _with_cfg_flags(CodecConfig().tiny(), flags), 2)
    ctor = {k: v for k, v in flags.items() if k in CTOR}
    rng = np.random.default_rng(7)
    a, tc = (0.4 * rng.standard_normal((2, 2, 1, FRAME))).astype(np.float32)
    zt = np.asarray(jdac.encode(jp.tactile_dac, jcfg.dac, jnp.asarray(tc)))
    mk = masks.make_token_loss_mask(np.random.default_rng(3), 2, FRAME // 320, 2, 0.5)
    zt = zt * ~mk[:, None, :]
    jsc = JStreamingConcealer(jp, jcfg, batch=2, frame_sec=FRAME / 24000, mask_embed=True,
                              compute_dtype=jnp.float32, fast=False, **ctor)
    sc = StreamingConcealer(m, batch=2, frame_sec=FRAME / 24000, mask_embed=True,
                            compute_dtype=torch.float32, fast=False, device="cpu", **ctor)
    for k in ("time_major", "time_major_enc", "tail_kernel", "poly_upsample"):
        assert getattr(sc.cfg.dac, k) == getattr(jsc.cfg.dac, k), k
    y = sc.conceal(a, zt, mk)
    assert y.dtype == torch.float32 and y.shape == (2, 1, FRAME)
    _close(y, jsc.conceal(a, zt, mk), 1e-4)
    # the model-level conceal is what the concealer serves
    _close(y, plc.conceal(m, torch.from_numpy(a), torch.from_numpy(zt),
                          torch.from_numpy(mk), mask_embed=True,
                          cfg=sc.cfg), 1e-6)


def test_concealer_flags_default_off_and_shapes_checked(params):
    jp, _ = params
    m = convert.plc_params_from_jax(jax.tree.map(np.asarray, jp), CodecConfig().tiny(), 2)
    for fast in (True, False):
        sc = StreamingConcealer(m, batch=1, frame_sec=FRAME / 24000, fast=fast, device="cpu")
        assert not any(getattr(sc.cfg.dac, k) for k in
                       ("time_major", "time_major_enc", "tail_kernel", "poly_upsample"))
        assert sc.cfg.dac.precision == ("default" if fast else "highest")
    with pytest.raises(ValueError, match="expected"):
        sc.conceal(np.zeros((1, 1, FRAME - 1), np.float32),
                   np.zeros((1, 64, 10), np.float32), np.zeros((1, 10), bool))
    with pytest.raises(ValueError, match="compute_dtype"):
        StreamingConcealer(m, batch=1, frame_sec=FRAME / 24000, device="cpu",
                           compute_dtype=torch.float16)


@pytest.mark.parametrize("weights", ["tiny", "plc_uniform"])
def test_bf16_predictor_within_parity_gate(params, weights):
    """The bf16 predictor's output against fp32 on the same latents, lost
    tokens included: docs/PARITY.md's continuous-latent 2.5e-2."""
    if weights == "tiny":
        jp, jcfg = params
        m = convert.plc_params_from_jax(jax.tree.map(np.asarray, jp), CodecConfig().tiny(), 2)
    else:
        m = convert.load_plc(BACKBONE, HEADS[weights], CodecConfig().tiny(), 2)
    rng = np.random.default_rng(5)
    a, tc = (torch.from_numpy(0.4 * rng.standard_normal((2, 2, 1, 24000)).astype(np.float32)))
    mk = torch.from_numpy(masks.make_token_loss_mask(np.random.default_rng(4), 2, 75, 2, 0.5))
    z = {}
    for dt in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            qa, _ = m.audio_dac.quantizer.quantize(m.audio_dac.encoder(a.to(dt)))
            zt = m.tactile_dac.encoder(tc.to(dt))
        z[dt], _ = plc.predict_latents(m.head, m.cfg, qa, zt, mk, mask_embed=True)
    assert z[torch.bfloat16].dtype == torch.bfloat16
    ref = z[torch.float32]
    err = float((z[torch.bfloat16].float() - ref).abs().max() / ref.abs().max())
    assert err < 2.5e-2


def test_throughput_reports_jax_keys(params):
    jp, _ = params
    m = convert.plc_params_from_jax(jax.tree.map(np.asarray, jp), CodecConfig().tiny(), 2)
    sc = StreamingConcealer(m, batch=2, frame_sec=FRAME / 24000, device="cpu")
    stats = sc.throughput_frames_per_sec(repeats=2)
    assert set(stats) == {"batch", "conceal_frames_per_sec", "conceal_ms_per_batch"}
    assert stats["batch"] == 2 and stats["conceal_frames_per_sec"] > 0
    codec = allpred_ar.codec_init(CodecConfig().tiny(), torch.Generator().manual_seed(0))
    stats = StreamingCodec(codec, batch=1, frame_sec=0.2, device="cpu").throughput_frames_per_sec(
        repeats=2)
    assert set(stats) == {"batch", "encode_frames_per_sec", "decode_frames_per_sec",
                          "encode_ms_per_batch", "decode_ms_per_batch"}
    assert min(stats["encode_frames_per_sec"], stats["decode_frames_per_sec"]) > 0


def test_default_device_is_the_card(monkeypatch):
    m = plc.plc_init(CodecConfig().tiny(), torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingConcealer(m, batch=1, frame_sec=FRAME / 24000)


def test_evidence_head_concealer_matches_jax():
    jp, jcfg, p = _jax_trained(HEADS["plc_category"])
    m = convert.load_plc(BACKBONE, HEADS["plc_category"], CodecConfig().tiny(), p.n_layers)
    rng = np.random.default_rng(9)
    a, tc = (0.3 * rng.standard_normal((2, 1, 1, 24000))).astype(np.float32)
    zt = np.asarray(jdac.encode(jp.tactile_dac, jcfg.dac, jnp.asarray(tc)))
    mk = masks.make_category_token_loss_mask(np.random.default_rng(2), 1, 75, 75.0,
                                             category="medium")
    zt = zt * ~mk[:, None, :]
    jsc = JStreamingConcealer(jp, jcfg, batch=1, mask_embed=p.mask_embed,
                              compute_dtype=jnp.float32, fast=False)
    sc = StreamingConcealer(m, batch=1, mask_embed=p.mask_embed,
                            compute_dtype=torch.float32, fast=False, device="cpu")
    _close(sc.conceal(a, zt, mk), jsc.conceal(a, zt, mk), 1e-4)
    _close(sc.conceal(a, zt, mk), jplc.conceal(jp, jcfg, jnp.asarray(a), jnp.asarray(zt),
                                               jnp.asarray(mk), mask_embed=True), 1e-4)
