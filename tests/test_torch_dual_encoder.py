"""``CodecConfig.vmap_dual_encoder`` in the port against the JAX package.

- ``backbone_latents`` and ``encode_latents`` with the option on, at
  ``CodecConfig().tiny()`` with the inputs of ``tests/test_dual_encoder.py``,
  against the JAX package's vmapped path (rtol 1e-5, atol 1e-6, its own
  tolerance; codes identical) and bit-equal to the port's own sequential
  path; also under ``tail_kernel`` (narrow stacks through the grouped plain
  K3) and with ``time_major_enc``, which the grouped path ignores, as JAX's
  does.
  The round-5 weights at 1 s (slow; codes identical, the latent stream
  within 1e-5 of its scale, as the sequential r5 parity).
- The grouped plain stacks (K1's and K3's plain versions over two weight
  sets) equal two single plain stacks bit for bit.
- After ``load_state_dict`` and after ``.to`` the dual path follows the
  new weights; a latent cache built right after a backbone was loaded and
  the PLC forward equal the sequential path's.
- A call that autograd would record raises.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import CodecConfig as JCodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu_torch.convert import load_codec, params_from_jax
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar, dac
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import latent_cache as lc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(ROOT, "artifacts", "r5")
DUAL = dict(vmap_dual_encoder=True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, T=3200):
    rng = np.random.default_rng(seed)
    return [(0.4 * rng.standard_normal((2, 1, T))).astype(np.float32) for _ in range(2)]


def _models(key):
    jcfg = JCodecConfig().tiny()
    jp = jar.codec_init(jax.random.key(key), jcfg)
    return jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), CodecConfig().tiny())


def _dual(cfg, **kw):
    return dataclasses.replace(cfg, **DUAL, dac=dataclasses.replace(cfg.dac, **kw))


def _latents(m, cfg, a, tc):
    with torch.no_grad():
        return allpred_ar.backbone_latents(m, torch.from_numpy(a), torch.from_numpy(tc), cfg)


@pytest.mark.parametrize("layout", [{}, {"tail_kernel": True}, {"time_major_enc": True}])
def test_backbone_latents_match_jax_and_the_sequential_path(layout):
    jp, jcfg, m = _models(0)
    a, tc = _inputs(3)
    jqa, jzt = jar.backbone_latents(jp, dataclasses.replace(jcfg, **DUAL), jnp.asarray(a),
                                    jnp.asarray(tc))
    cfg = CodecConfig().tiny()
    qa, zt = _latents(m, _dual(cfg, **layout), a, tc)
    np.testing.assert_allclose(qa.numpy(), np.asarray(jqa), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(zt.numpy(), np.asarray(jzt), rtol=1e-5, atol=1e-6)
    # the sequential path in the same layout, channels-first (the dual path
    # ignores time_major_enc)
    seq = dataclasses.replace(cfg, dac=dataclasses.replace(
        cfg.dac, tail_kernel=layout.get("tail_kernel", False)))
    qa0, zt0 = _latents(m, seq, a, tc)
    assert torch.equal(qa, qa0) and torch.equal(zt, zt0)


def test_encode_latents_codes_identical():
    jp, jcfg, m = _models(1)
    a, tc = _inputs(4)
    jz, jcodes = jar.encode_latents(jp, dataclasses.replace(jcfg, **DUAL), jnp.asarray(a),
                                    jnp.asarray(tc))
    cfg = CodecConfig().tiny()
    z, codes = allpred_ar.encode_latents(m, torch.from_numpy(a), torch.from_numpy(tc),
                                         cfg=_dual(cfg))
    _, codes0 = allpred_ar.encode_latents(m, torch.from_numpy(a), torch.from_numpy(tc), cfg=cfg)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(codes.numpy(), codes0.numpy())
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_r5_weights_one_second():
    backbone = os.path.join(R5, "backbone_best.msgpack")
    head = os.path.join(R5, "rvqB8_K128", "best.msgpack")
    jcfg = dataclasses.replace(JCodecConfig().with_rvq(8, 128), **DUAL)
    bb, _, _ = jckpt.load_checkpoint(backbone, jdac.dac_init(jax.random.key(0), jcfg.dac))
    hd, _, _ = jckpt.load_checkpoint(head, jar.head_init(jax.random.key(0), jcfg))
    jp = jar.CodecParams(bb, bb, hd)
    cfg = CodecConfig().with_rvq(8, 128)
    m = load_codec(backbone, head, cfg)
    rng = np.random.default_rng(5)
    a, tc = [(0.1 * rng.standard_normal((1, 1, 24000))).astype(np.float32) for _ in range(2)]
    jz, jcodes = jar.encode_latents(jp, jcfg, jnp.asarray(a), jnp.asarray(tc))
    z, codes = allpred_ar.encode_latents(m, torch.from_numpy(a), torch.from_numpy(tc),
                                         cfg=_dual(cfg))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    # full width: within 1e-5 of the latent stream's scale, the tolerance of
    # the port's sequential r5 parity (tests/test_torch_allpred_ar.py)
    jz = np.asarray(jz)
    assert float(np.abs(z.numpy() - jz).max()) <= 1e-5 * float(np.abs(jz).max())


def _stack_sets(seed, C):
    g = torch.Generator().manual_seed(seed)
    sets = []
    for _ in range(2):
        units = [resunit.ResUnit(C) for _ in resunit.DILATIONS]
        with torch.no_grad():
            for u in units:
                for p in u.parameters():
                    p.copy_(0.3 * torch.randn(p.shape, generator=g) + (p.dim() == 1) * 1.0)
        sets.append(units)
    return sets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_grouped_plain_stack_equals_two_single_stacks(kernel, dtype):
    C, T, B = 16, 200, 3
    sets = _stack_sets(7, C)
    x = torch.randn(B, 2, C, T, generator=torch.Generator().manual_seed(8)).to(dtype)
    post = torch.rand(2 * C, generator=torch.Generator().manual_seed(9)) + 0.5
    if kernel == "k3":
        x = x.transpose(2, 3).contiguous()
    fn = resunit.resunit_stack_ref if kernel == "k1" else resunit_tm.resunit_stack_tm_ref
    with torch.no_grad():
        got = fn(sets, x.flatten(0, 1), resunit.DILATIONS, post).unflatten(0, (B, 2))
        for g in range(2):
            one = fn(sets[g], x[:, g].contiguous(), resunit.DILATIONS, post[g * C:(g + 1) * C])
            assert torch.equal(got[:, g], one)


def test_dual_follows_the_weights_after_load_state_dict_and_to():
    _, _, m = _models(0)
    _, _, m2 = _models(2)
    a, tc = _inputs(3)
    cfg = CodecConfig().tiny()
    _latents(m, _dual(cfg), a, tc)
    m.tactile_dac.load_state_dict(m2.tactile_dac.state_dict())
    qa, zt = _latents(m, _dual(cfg), a, tc)
    qa0, zt0 = _latents(m, cfg, a, tc)
    assert torch.equal(zt, zt0) and torch.equal(qa, qa0)
    m.to(torch.float64).to(torch.float32)            # new storage, same values
    qa1, zt1 = _latents(m, _dual(cfg), a, tc)
    assert torch.equal(zt1, zt) and torch.equal(qa1, qa)


def test_latent_cache_after_a_load_follows_the_new_weights():
    _, _, m = _models(0)
    _, _, m2 = _models(2)
    cfg = CodecConfig().tiny()
    bb = {"audio": m.audio_dac, "tactile": m.tactile_dac}
    batches = [tuple(_inputs(s, T=4800)) for s in (10, 11)]
    lc.build_latent_cache(bb, _dual(cfg), iter(batches), device="cpu")
    m.audio_dac.load_state_dict(m2.audio_dac.state_dict())
    got = lc.build_latent_cache(bb, _dual(cfg), iter(batches), device="cpu")
    ref = lc.build_latent_cache(bb, cfg, iter(batches), device="cpu")
    assert torch.equal(got.qa, ref.qa) and torch.equal(got.zt, ref.zt)


def test_plc_forward_takes_the_grouped_path():
    cfg = CodecConfig().tiny()
    m = plc.plc_init(cfg, torch.Generator().manual_seed(3), n_layers=1)
    a, tc = (torch.from_numpy(x) for x in _inputs(6, T=4800))
    mask = torch.from_numpy(masks.make_token_loss_mask(np.random.default_rng(1), 2, 15, 2, 0.5))
    with torch.no_grad():
        got = plc.forward_step(m, a, tc, mask, cfg=_dual(cfg))
        ref = plc.forward_step(m, a, tc, mask, cfg=cfg)
    assert torch.equal(got.y_hat, ref.y_hat)


def test_a_recorded_call_raises():
    _, _, m = _models(0)
    a, tc = (torch.from_numpy(x) for x in _inputs(3))
    with pytest.raises(RuntimeError, match="no backward"):
        dac.dual_encode(m.audio_dac.encoder, m.tactile_dac.encoder, a, tc)
    frozen = copy.deepcopy(m).requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        dac.dual_encode(frozen.audio_dac.encoder, frozen.tactile_dac.encoder,
                        a.requires_grad_(True), tc)
