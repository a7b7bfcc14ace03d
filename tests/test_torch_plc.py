"""The port's packet-loss concealment against the JAX package's, on the CPU.

- ``plc/masks.py``: every generator bit-equal to the JAX package's for the
  same ``numpy.random.Generator`` state.
- ``plc/model.py``: ``conceal``, ``forward_step``, ``forward_zero_fill``,
  ``predict_latents`` and ``forward_step_latents`` on the same weights and
  numpy inputs, fp32 (JAX at HIGHEST): latents within 1e-5 and waveforms
  within 1e-4 of the output's scale (the tolerances of
  ``tests/test_torch_allpred_ar.py``); on ``CodecConfig().tiny()`` at the
  JAX package's random init with 1 and 2 predictor blocks and the mask
  token on and off (set to a random vector, so that it counts), and on the
  trained heads of ``artifacts/evidence_tiny``. ``_interp_latent`` with
  ``t_in != t_out`` directly and inside the predictor path.
- The strict PLC loader reads both evidence heads and raises on a missing,
  extra and mis-shaped leaf; ``plc_config_from_meta`` reads meta.json as the
  JAX package does.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import CodecConfig as JCodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import PLCConfig as JPLCConfig
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.plc import masks as jmasks
from multimodal_vqvae_compression_audio_tactile_tpu.plc import model as jplc
from multimodal_vqvae_compression_audio_tactile_tpu.plc.train import (
    plc_config_from_meta as jplc_config_from_meta)
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig, PLCConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc.train import plc_config_from_meta
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(ROOT, "artifacts", "evidence_tiny")
BACKBONE = os.path.join(EVIDENCE, "backbone", "best.msgpack")
HEADS = {"plc_uniform": os.path.join(EVIDENCE, "plc_uniform"),
         "plc_category": os.path.join(EVIDENCE, "plc_category")}
FRAME = 3200          # 10 tokens


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tiny-width forward is thousands of small ops; with one torch
    thread a test worker does not spin against the other workers for the
    cores (tenfold slower otherwise when six workers share a host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) + 1e-12
    assert float(np.max(np.abs(got - ref))) / scale <= tol


# ---------------------------------------------------------------- masks

@pytest.mark.parametrize("seed", [0, 7, 7001])
@pytest.mark.parametrize("t_lat,packet_tok,p", [(75, 2, 0.5), (74, 3, 0.25), (10, 2, 0.9),
                                                (1, 2, 0.5), (0, 2, 0.5), (75, 0, 0.5)])
def test_uniform_mask_bit_equal(seed, t_lat, packet_tok, p):
    got = masks.make_token_loss_mask(np.random.default_rng(seed), 3, t_lat, packet_tok, p)
    ref = jmasks.make_token_loss_mask(np.random.default_rng(seed), 3, t_lat, packet_tok, p)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("category", [None, "low", "medium", "high"])
@pytest.mark.parametrize("t_lat", [75, 30, 0])
def test_category_mask_bit_equal(category, t_lat):
    for seed in range(5):
        got = masks.make_category_token_loss_mask(np.random.default_rng(seed), 4, t_lat,
                                                  75.0, PLCConfig(), category=category)
        ref = jmasks.make_category_token_loss_mask(np.random.default_rng(seed), 4, t_lat,
                                                   75.0, JPLCConfig(), category=category)
        np.testing.assert_array_equal(got, ref)


def test_sample_category_seeds_and_statistics_equal():
    g, jg = np.random.default_rng(3), np.random.default_rng(3)
    assert [masks.sample_category(g) for _ in range(200)] == \
        [jmasks.sample_category(jg) for _ in range(200)]
    assert masks.CATEGORIES == jmasks.CATEGORIES
    for args in ((7000, 3), (7000, 2, 1), (0, 1, 2)):
        assert masks.eval_mask_seed(*args) == jmasks.eval_mask_seed(*args)
    mk = masks.make_category_token_loss_mask(np.random.default_rng(1), 6, 75, 75.0)
    assert masks.mask_statistics(mk) == jmasks.mask_statistics(mk)


# ---------------------------------------------------------------- model

def _jax_params(n_layers, seed=0):
    jcfg = JCodecConfig().tiny()
    base = jar.codec_init(jax.random.key(seed), jcfg)
    head = jplc.plc_head_init(jax.random.key(seed + 1), jcfg, n_layers=n_layers)
    # a mask token that counts: the init's is zeros
    head = dict(head, mask_embed=jnp.asarray(
        np.random.default_rng(seed).normal(0, 0.5, jcfg.predictor.dim).astype(np.float32)))
    return jar.CodecParams(base.audio_dac, base.tactile_dac, head), jcfg


def _port(jp, n_layers, cfg=None):
    return convert.plc_params_from_jax(jax.tree.map(np.asarray, jp),
                                       cfg or CodecConfig().tiny(), n_layers)


@pytest.fixture(scope="module", params=[1, 2], ids=["layers1", "layers2"])
def tiny_pair(request):
    jp, jcfg = _jax_params(request.param)
    return jp, jcfg, _port(jp, request.param)


def _inputs(seed, frame=FRAME, batch=2):
    rng = np.random.default_rng(seed)
    a, tc = (0.4 * rng.standard_normal((2, batch, 1, frame))).astype(np.float32)
    mk = masks.make_token_loss_mask(np.random.default_rng(seed + 1), batch,
                                    frame // 320, 2, 0.5)
    mk[:, 0] = True                                  # at least one lost token
    return a, tc, mk


def _t(x):
    return torch.from_numpy(np.array(x))


def _check_model(jp, jcfg, m, a, tc, mk, mask_embed):
    """Every entry point of the port against the JAX package's."""
    ja, jtc, jmk = jnp.asarray(a), jnp.asarray(tc), jnp.asarray(mk)
    jout = jplc.forward_step(jp, jcfg, ja, jtc, jmk, mask_embed=mask_embed)
    out = plc.forward_step(m, _t(a), _t(tc), _t(mk), mask_embed=mask_embed)
    _close(out.z_pred, jout.z_pred, 1e-5)
    _close(out.z_tgt, jout.z_tgt, 1e-5)
    _close(out.y_hat, jout.y_hat, 1e-4)
    np.testing.assert_array_equal(out.tgt.numpy(), np.asarray(jout.tgt))
    np.testing.assert_array_equal(out.latent_mask.numpy(), np.asarray(jout.latent_mask))

    jzt = jdac.encode(jp.tactile_dac, jcfg.dac, jtc)
    zt = jzt * ~jmk[:, None, :]                      # what the receiver holds
    _close(plc.conceal(m, _t(a), _t(zt), _t(mk), mask_embed=mask_embed),
           jplc.conceal(jp, jcfg, ja, zt, jmk, mask_embed=mask_embed), 1e-4)

    j0 = jplc.forward_zero_fill(jp, jcfg, ja, jtc, jmk)
    _close(plc.forward_zero_fill(m, _t(a), _t(tc), _t(mk)).y_hat, j0.y_hat, 1e-4)

    jqa, jzt_full = jar.backbone_latents(jp, jcfg, ja, jtc)
    jz, jm3 = jplc.predict_latents(jp.head, jcfg, jqa, jzt_full, jmk, mask_embed=mask_embed)
    z, m3 = plc.predict_latents(m.head, m.cfg, _t(jqa), _t(jzt_full), _t(mk),
                                mask_embed=mask_embed)
    _close(z, jz, 1e-5)
    np.testing.assert_array_equal(m3.numpy(), np.asarray(jm3))
    jl = jplc.forward_step_latents(jp.head, jp.tactile_dac, jcfg, jqa, jzt_full, jtc, jmk,
                                   mask_embed=mask_embed)
    lat = plc.forward_step_latents(m.head, m.tactile_dac, m.cfg, _t(jqa), _t(jzt_full),
                                   _t(tc), _t(mk), mask_embed=mask_embed)
    _close(lat.y_hat, jl.y_hat, 1e-4)
    _close(lat.z_pred, jl.z_pred, 1e-5)


@pytest.mark.parametrize("mask_embed", [False, True], ids=["embed_off", "embed_on"])
def test_tiny_init_matches_jax(tiny_pair, mask_embed):
    jp, jcfg, m = tiny_pair
    _check_model(jp, jcfg, m, *_inputs(11), mask_embed)


def test_mask_token_counts_only_when_enabled(tiny_pair):
    """The random mask token moves the concealed output with the flag on and
    leaves it alone with the flag off (so both cases above test something)."""
    _, _, m = tiny_pair
    a, tc, mk = (_t(x) for x in _inputs(12))
    off = plc.forward_step(m, a, tc, mk).y_hat
    on = plc.forward_step(m, a, tc, mk, mask_embed=True).y_hat
    with torch.no_grad():
        saved = m.head.mask_embed.clone()
        m.head.mask_embed.zero_()
        off_zero = plc.forward_step(m, a, tc, mk).y_hat
        m.head.mask_embed.copy_(saved)
    assert torch.equal(off, off_zero) and not torch.allclose(on, off)


def test_all_false_mask_decodes_the_received_latents(tiny_pair):
    """No token lost: ``conceal`` is the tactile decoder of the received
    stream, and ``forward_zero_fill`` equals ``forward_step``."""
    _, _, m = tiny_pair
    a, tc, _ = (_t(x) for x in _inputs(13))
    none = torch.zeros(2, FRAME // 320, dtype=torch.bool)
    with torch.no_grad():
        zt = m.tactile_dac.encoder(tc)
        ref = m.tactile_dac.decoder(zt)
    assert torch.equal(plc.conceal(m, a, zt, none, mask_embed=True), ref)
    assert torch.equal(plc.forward_zero_fill(m, a, tc, none).y_hat,
                       plc.forward_step(m, a, tc, none, mask_embed=True).y_hat)


@pytest.mark.parametrize("t_in,t_out", [(10, 10), (7, 10), (10, 7), (75, 74), (1, 5), (4, 1)])
def test_interp_latent_matches_jax(t_in, t_out):
    x = np.random.default_rng(t_in * 100 + t_out).standard_normal((2, 3, t_in)).astype(np.float32)
    got = plc._interp_latent(torch.from_numpy(x), t_out)
    ref = jplc._interp_latent(jnp.asarray(x), t_out)
    assert got.shape == (2, 3, t_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mask_embed", [False, True], ids=["embed_off", "embed_on"])
def test_predictor_with_audio_latents_of_another_length(tiny_pair, mask_embed):
    """The audio latents resampled to the tactile length inside the model."""
    jp, jcfg, m = tiny_pair
    rng = np.random.default_rng(21)
    qa = rng.standard_normal((2, 64, 13)).astype(np.float32)
    zt = rng.standard_normal((2, 64, 10)).astype(np.float32)
    mk = rng.random((2, 10)) < 0.5
    jz, _ = jplc.predict_latents(jp.head, jcfg, jnp.asarray(qa), jnp.asarray(zt),
                                 jnp.asarray(mk), mask_embed=mask_embed)
    z, _ = plc.predict_latents(m.head, m.cfg, _t(qa), _t(zt), _t(mk), mask_embed=mask_embed)
    _close(z, jz, 1e-5)


def _jax_trained(head_dir):
    jcfg = JCodecConfig().tiny()
    p = jplc_config_from_meta(head_dir)
    bb, _, _ = jckpt.load_checkpoint(BACKBONE, jdac.dac_init(jax.random.key(0), jcfg.dac))
    hd, _, _ = jckpt.load_checkpoint(os.path.join(head_dir, "best.msgpack"),
                                     jplc.plc_head_init(jax.random.key(0), jcfg, p.n_layers))
    return jar.CodecParams(bb, bb, hd), jcfg, p


@pytest.mark.parametrize("head", sorted(HEADS))
def test_evidence_heads_match_jax(head):
    jp, jcfg, p = _jax_trained(HEADS[head])
    m = convert.load_plc(BACKBONE, HEADS[head], CodecConfig().tiny(), p.n_layers)
    assert p.mask_embed and p.n_layers == 2
    assert float(m.head.mask_embed.detach().abs().max()) > 0     # trained
    _check_model(jp, jcfg, m, *_inputs(31, frame=9600, batch=1), p.mask_embed)


# ---------------------------------------------------------------- loader

@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_head_template_is_the_jax_tree(n_layers):
    jhead = jplc.plc_head_init(jax.random.key(0), JCodecConfig().tiny(), n_layers)
    jtree = {p: tuple(np.shape(v)) for p, v in checkpoint.flatten(
        jax.tree.map(np.asarray, jhead))}
    assert convert.plc_head_template(CodecConfig().tiny(), n_layers) == jtree


@pytest.mark.parametrize("head", sorted(HEADS))
def test_strict_loader_reads_the_evidence_heads_exactly(head):
    """Every leaf of the loaded head equals the checkpoint's (layouts
    undone), and best.msgpack is the one read."""
    m = convert.load_plc(BACKBONE, HEADS[head], CodecConfig().tiny(), 2)
    tree, _, _ = checkpoint.load_checkpoint(os.path.join(HEADS[head], "best.msgpack"))
    arrays = dict(checkpoint.flatten(tree))
    for p, t, kind in convert.plc_head_leaves(m.head):
        np.testing.assert_array_equal(convert._to_torch(arrays[p], kind).numpy(),
                                      t.detach().numpy())


def test_loader_falls_back_to_last(tmp_path):
    import shutil
    run = tmp_path / "run"
    run.mkdir()
    shutil.copy(os.path.join(HEADS["plc_uniform"], "last.msgpack"), run / "last.msgpack")
    m = convert.load_plc(BACKBONE, str(run), CodecConfig().tiny(), 2)
    ref = convert.load_plc(BACKBONE, os.path.join(HEADS["plc_uniform"], "last.msgpack"),
                           CodecConfig().tiny(), 2)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 ref.state_dict().values()))


def test_strict_loader_raises_on_mis_shaped_leaf():
    with pytest.raises(ValueError, match="does not match"):     # 2 blocks stored
        convert.load_plc(BACKBONE, HEADS["plc_uniform"], CodecConfig().tiny(), 1)
    wide = dataclasses.replace(CodecConfig().tiny(), predictor=dataclasses.replace(
        CodecConfig().tiny().predictor, mlp_mul=4))
    tree, _, _ = checkpoint.load_checkpoint(os.path.join(HEADS["plc_uniform"], "best.msgpack"))
    with pytest.raises(ValueError, match="shapes"):
        checkpoint.check_tree(tree, convert.plc_head_template(wide, 2))


@pytest.mark.parametrize("edit", ["missing", "extra"])
def test_strict_loader_raises_on_missing_or_extra_leaf(edit):
    cfg = CodecConfig().tiny()
    tree, _, _ = checkpoint.load_checkpoint(os.path.join(HEADS["plc_uniform"], "best.msgpack"))
    if edit == "missing":
        del tree["mask_embed"]
    else:
        tree["predict_extra"][0]["ffn_in"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.check_tree(tree, convert.plc_head_template(cfg, 2))
    bb, _, _ = checkpoint.load_checkpoint(BACKBONE)
    with pytest.raises(ValueError):
        convert.plc_params_from_jax({"audio_dac": bb, "tactile_dac": bb, "head": tree},
                                    cfg, 2)


def test_config_from_meta_matches_jax(tmp_path):
    import json
    for head in HEADS.values():
        assert dataclasses.asdict(plc_config_from_meta(head)) == \
            dataclasses.asdict(jplc_config_from_meta(head))
    meta = {"plc": {"packet_tok": 3, "packet_loss_prob": 0.25, "mask_embed": True,
                    "n_layers": 3, "cat_burst_ms": [[10.0, 20.0]], "unknown": 1}}
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    got = plc_config_from_meta(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(jplc_config_from_meta(str(tmp_path)))
    assert got.cat_burst_ms == ((10.0, 20.0),) and got.n_layers == 3
    assert plc_config_from_meta(str(tmp_path / "none")) == PLCConfig()
