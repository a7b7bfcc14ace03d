"""The port's PLC trainer and inpainting-decoder fine-tune against the JAX
package's, on the CPU.

Tiny configuration (``CodecConfig().tiny()``), a 2-block PLC head with the
learned mask token, the JAX package's random init carried across, inputs
from numpy seeds (0.133-s signals: 10 tokens), masks from numpy generators
(equal in both packages), no dropout:

- both masked losses within 1e-6 relative of JAX's;
- one ``make_plc_train_step`` step per input kind (waveforms or cached
  latents) and per step (the full loss, the decoder-free latent one): the
  metrics within 1e-5 relative and every head gradient within rtol 1e-4,
  atol 1e-6, with the L1 and STFT terms (the mel-cosine term's own gap
  between the packages on near-silent mel bins is shown in
  ``tests/test_torch_latent_cache.py``); with the full loss, the total
  within 1e-4;
- the latent step lowers the masked latent error it is to lower;
- ``train_plc`` for two epochs (the first decoder-free) from one JAX-written
  head on both sides: ``hist`` within 1e-4 relative, ``meta.json`` equal;
  then resumed to a third epoch; the port's checkpoints load in the JAX
  package's strict loader;
- ``finetune_inpaint_decoder`` for one epoch on both sides: ``hist`` within
  1e-4, the two fine-tuned decoders within Adam's bound of 2 lr a step;
  only the copy of the decoder changes;
- ``dec_ft`` reaches the concealed decode only, and a file's row with it
  matches JAX's (1e-3 dB, 1e-4 ST-SIM);
- the scripts on the evidence corpus.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import CodecConfig as JCodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import LossConfig as JLossConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import PLCConfig as JPLCConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.plc import eval_uniform as jeval_uniform
from multimodal_vqvae_compression_audio_tactile_tpu.plc import model as jplc
from multimodal_vqvae_compression_audio_tactile_tpu.plc import train as jtrain
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    LossConfig, PLCConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models.dac import Decoder
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import eval_uniform, masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import train
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train.loop import AdamW
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils.wav_io import write_wav

from test_torch_latent_cache import _capture_grads
from test_torch_plc import BACKBONE, EVIDENCE, _inputs, _t
from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)
from test_torch_plc_eval import CORPUS, DB_TOL, STSIM_TOL
from test_torch_train import port_cfg

JCFG = dataclasses.replace(JCodecConfig().tiny(), predictor=dataclasses.replace(
    JCodecConfig().tiny().predictor, dropout=0.0))
CFG = port_cfg(JCFG)
WEIGHTS = dict(w_plc_latent=1.0, w_plc_masked=0.5)
PCFG, JPCFG = PLCConfig(mask_embed=True, n_layers=2), JPLCConfig(mask_embed=True, n_layers=2)


@pytest.fixture(scope="module")
def models():
    """The JAX codec backbones and a 2-block head with a mask token that
    counts; the port's copy."""
    base = jar.codec_init(jax.random.key(0), JCFG)
    head = jplc.plc_head_init(jax.random.key(1), JCFG, n_layers=2)
    head = dict(head, mask_embed=jnp.asarray(
        np.random.default_rng(0).normal(0, 0.5, JCFG.predictor.dim).astype(np.float32)))
    jp = jar.CodecParams(base.audio_dac, base.tactile_dac, head)
    m = convert.plc_params_from_jax(jax.tree.map(np.asarray, jp), CFG, 2)
    m.requires_grad_(False)
    m.head.requires_grad_(True)
    return jp, m


def _bb(m):
    return {"audio": m.audio_dac, "tactile": m.tactile_dac}


def _jbb(jp):
    return {"audio": jp.audio_dac, "tactile": jp.tactile_dac}


def _fresh_head(m):
    head = plc.PLCHead(CFG, 2)
    head.load_state_dict(m.head.state_dict())
    return head


def _grads_close(jgrads, head, rtol, atol):
    for p, t, kind in convert.plc_head_leaves(head):
        ref = jgrads
        for k in p:
            ref = ref[k]
        g = torch.zeros_like(t) if t.grad is None else t.grad
        g = g.T if kind == "t" else g
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=rtol, atol=atol,
                                   err_msg="/".join(map(str, p)))


# ---------------------------------------------------------------- losses

def test_masked_losses_match_jax():
    rng = np.random.default_rng(0)
    zp, zt = rng.standard_normal((2, 2, 8, 10)).astype(np.float32)
    m = rng.random((2, 1, 10)) < 0.5
    got = float(train.masked_latent_rel_mse(_t(zp), _t(zt), _t(m)))
    ref = float(jtrain.masked_latent_rel_mse(jnp.asarray(zp), jnp.asarray(zt), jnp.asarray(m)))
    assert abs(got / ref - 1.0) <= 1e-6
    assert float(train.masked_latent_rel_mse(_t(zt), _t(zt), _t(m))) == 0.0
    y, t = rng.standard_normal((2, 2, 1, 40)).astype(np.float32)
    got = float(train.masked_time_rel_mse(_t(y), _t(t), _t(m), 4))
    ref = float(jtrain.masked_time_rel_mse(jnp.asarray(y), jnp.asarray(t), jnp.asarray(m), 4))
    assert abs(got / ref - 1.0) <= 1e-6
    sm = np.repeat(m, 4, axis=-1)
    want = (((y - t) ** 2) * sm).sum() / ((t ** 2) * sm).sum()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    y1 = np.ones((1, 1, 8), np.float32)
    y2 = y1.copy()
    y2[..., 4:] = 99.0                     # error only in token 1's span
    m0 = np.array([[[True, False]]])
    assert float(train.masked_time_rel_mse(_t(y2), _t(y1), _t(m0), 4)) == 0.0


@pytest.mark.parametrize("mode", ["uniform", "category"])
def test_make_mask_matches_jax(mode):
    for seed in range(3):
        got = train._make_mask(np.random.default_rng(seed), 4, 75, PCFG, mode, 75.0)
        ref = jtrain._make_mask(np.random.default_rng(seed), 4, 75, JPCFG, mode, 75.0)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- one step

@pytest.mark.parametrize("step,inputs,loss", [
    ("full", "waveform", "l1_stft"), ("full", "cached", "l1_stft"),
    ("latent", "waveform", "l1_stft"), ("latent", "cached", "l1_stft"),
    ("full", "waveform", "full_loss"), ("full", "cached", "full_loss")])
def test_plc_step_matches_jax(models, step, inputs, loss):
    jp, m = models
    weights = dict(WEIGHTS, **({"w_melcos": 0.0} if loss == "l1_stft" else {}))
    a, tc, mk = _inputs(21)
    ja, jtc, jmk = jnp.asarray(a), jnp.asarray(tc), jnp.asarray(mk)
    jsteps = jtrain.make_plc_train_step(JCFG, JTrainConfig(batch=2, loss=JLossConfig(**weights)),
                                        _capture_grads(), mask_embed=True)
    jqa, jzt = jar.backbone_latents(jp, JCFG, ja, jtc)
    jx = (jqa, jzt) if inputs == "cached" else ja
    jstate = jtrain.PLCTrainState(jax.tree.map(jnp.array, jp.head),
                                  jax.tree.map(jnp.zeros_like, jp.head), jnp.zeros((), jnp.int32))
    jstate, jmetrics = jsteps[0 if step == "full" else 2](jstate, _jbb(jp), jx, jtc, jmk, None)

    tcfg = TrainConfig(batch=2, loss=LossConfig(**weights))
    steps = train.make_plc_train_step(CFG, tcfg, mask_embed=True)
    head = _fresh_head(m)
    state = train.PLCTrainState(head, AdamW(list(head.parameters()), tcfg, 1))
    x = (_t(jqa), _t(jzt)) if inputs == "cached" else _t(a)
    metrics = steps[0 if step == "full" else 2](state, _bb(m), x, _t(tc), _t(mk), None)
    assert state.step == 1 and int(state.opt.count) == 1
    if loss == "full_loss":
        np.testing.assert_allclose(float(metrics[0]), float(jmetrics[0]), rtol=1e-4)
        return
    np.testing.assert_allclose(metrics.numpy(), np.asarray(jmetrics), rtol=1e-5, atol=1e-7)
    _grads_close(jax.tree.map(np.asarray, jstate.opt_state), head, 1e-4, 1e-6)
    if step == "latent":
        assert float(metrics[2]) == 0.0
    assert all(p.grad is None for p in m.tactile_dac.parameters())


def test_eval_step_matches_jax(models):
    jp, m = models
    a, tc, mk = _inputs(22)
    tcfg = TrainConfig(batch=2, loss=LossConfig(w_melcos=0.0, **WEIGHTS))
    jtcfg = JTrainConfig(batch=2, loss=JLossConfig(w_melcos=0.0, **WEIGHTS))
    _, jeval, _ = jtrain.make_plc_train_step(JCFG, jtcfg, _capture_grads(), mask_embed=True)
    _, peval, _ = train.make_plc_train_step(CFG, tcfg, mask_embed=True)
    ref = jeval(jp.head, _jbb(jp), jnp.asarray(a), jnp.asarray(tc), jnp.asarray(mk))
    got = peval(m.head, _bb(m), _t(a), _t(tc), _t(mk))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    assert got.grad_fn is None


def test_latent_step_trains_the_same_objective(models):
    """As the JAX package's ``test_latent_only_step_trains_same_objective``:
    15 decoder-free steps lower the masked latent error; the decoder and
    the encoders are untouched."""
    jp, m = models
    a, tc, mk = _inputs(23)
    tcfg = TrainConfig(batch=2, lr=3e-3, epochs=1, loss=LossConfig(w_plc_latent=1.0))
    _, _, latent_step = train.make_plc_train_step(CFG, tcfg, mask_embed=True)
    head = _fresh_head(m)
    state = train.PLCTrainState(head, AdamW(list(head.parameters()), tcfg, 100))
    with torch.no_grad():
        qa, zt = plc._audio_latents(m, _t(a), CFG), m.tactile_dac.encoder(_t(tc), CFG.dac)

    def err():
        z, mm = plc.predict_latents(head, CFG, qa, zt, _t(mk), mask_embed=True)
        return float(train.masked_latent_rel_mse(z, zt, mm))

    before = {k: v.clone() for k, v in m.tactile_dac.state_dict().items()}
    e0 = err()
    for _ in range(15):
        metrics = latent_step(state, _bb(m), _t(a), _t(tc), _t(mk), None)
    assert float(metrics[2]) == 0.0 and err() < e0
    assert all(torch.equal(v, before[k]) for k, v in m.tactile_dac.state_dict().items())


# ---------------------------------------------------------------- train_plc

TRAIN = [_inputs(30)[:2], _inputs(31)[:2]]
VAL = [_inputs(32)[:2]]
TCFG = dict(batch=2, seg_sec=3200 / 24000, best_after_epoch=0)


@pytest.fixture(scope="module")
def plc_runs(models, tmp_path_factory):
    """JAX's and the port's ``train_plc`` (uniform, 2 epochs, the first
    decoder-free) from one JAX-written head (a resumable epoch-0
    checkpoint), same batches."""
    jp, m = models
    out = {}
    kw = dict(train_batches=lambda ep: iter(TRAIN), val_batches=lambda: iter(VAL),
              mode="uniform", seed=5, resume=True, latent_pretrain_epochs=1,
              log=lambda s: None)
    for side in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(side))
        jckpt.save_checkpoint(os.path.join(d, "last.msgpack"), jp.head, 0, {})
        if side == "jax":
            hist = jtrain.train_plc(JCFG, JTrainConfig(epochs=2, loss=JLossConfig(**WEIGHTS),
                                                       **TCFG), JPCFG, _jbb(jp), out_dir=d, **kw)
        else:
            hist = train.train_plc(CFG, TrainConfig(epochs=2, loss=LossConfig(**WEIGHTS), **TCFG),
                                   PCFG, _bb(m), out_dir=d, device="cpu", **kw)
        out[side] = (d, hist)
    return out


def test_train_plc_matches_jax(plc_runs):
    (jd, jh), (pd, ph) = plc_runs["jax"], plc_runs["port"]
    assert sorted(ph) == sorted(jh)
    for k in jh:
        assert len(ph[k]) == len(jh[k]) == 2, k
        np.testing.assert_allclose(ph[k], jh[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert ph["tmse"][0] == 0.0                       # the decoder-free epoch
    with open(os.path.join(pd, "meta.json")) as f, open(os.path.join(jd, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    assert train.plc_config_from_meta(pd) == PCFG


def test_port_plc_checkpoints_load_in_jax(models, plc_runs):
    jp, _ = models
    pd, _ = plc_runs["port"]
    jd, _ = plc_runs["jax"]
    for name in ("last.msgpack", "best.msgpack"):
        tree, ep, hist = jckpt.load_checkpoint(os.path.join(pd, name), jp.head)
        jtree, jep, jhist = jckpt.load_checkpoint(os.path.join(jd, name), jp.head)
        assert ep == jep and sorted(hist) == sorted(jhist)
        head = convert.load_plc_head(os.path.join(pd, name), CFG, 2)
        for p, t, kind in convert.plc_head_leaves(head):
            ref = tree
            for k in p:
                ref = ref[k]
            t = t.detach()
            np.testing.assert_array_equal((t.T if kind == "t" else t).numpy(), np.asarray(ref))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=2 * 2 * 2e-4)


def test_train_plc_resumes(models, plc_runs):
    _, m = models
    d, hist = plc_runs["port"]
    logs = []
    hist2 = train.train_plc(CFG, TrainConfig(epochs=3, loss=LossConfig(**WEIGHTS), **TCFG), PCFG,
                            _bb(m), lambda ep: iter(TRAIN), lambda: iter(VAL), d, seed=5,
                            resume=True, latent_pretrain_epochs=1, log=logs.append,
                            device="cpu")
    assert any("resume" in s and "epoch 2" in s for s in logs)
    assert len(hist2["train"]) == 3 and hist2["train"][:2] == hist["train"]
    assert len(hist2["val_masked_snr_db"]) == 3


# ---------------------------------------------------------------- decoder fine-tune

@pytest.fixture(scope="module")
def decft_runs(models, tmp_path_factory):
    jp, m = models
    out = {}
    kw = dict(train_batches=lambda ep: iter(TRAIN), val_batches=lambda: iter(VAL),
              mode="uniform", seed=5, epochs=1, log=lambda s: None)
    for side in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(side))
        if side == "jax":
            # copies: the JAX fine-tune's jitted step donates the decoder it
            # takes from the backbone
            bb = jax.tree.map(jnp.array, _jbb(jp))
            hist = jtrain.finetune_inpaint_decoder(JCFG, JTrainConfig(**TCFG), JPCFG, bb,
                                                   jp.head, out_dir=d, **kw)
        else:
            before = {k: v.clone() for k, v in m.state_dict().items()}
            hist = train.finetune_inpaint_decoder(CFG, TrainConfig(**TCFG), PCFG, _bb(m), m.head,
                                                  out_dir=d, device="cpu", **kw)
            for k, v in m.state_dict().items():
                assert torch.equal(v, before[k]), k      # backbones and head as they were
        out[side] = (d, hist)
    return out


def test_decoder_ft_matches_jax(models, decft_runs):
    jp, m = models
    (jd, jh), (pd, ph) = decft_runs["jax"], decft_runs["port"]
    assert sorted(ph) == sorted(jh)
    for k in jh:
        np.testing.assert_allclose(ph[k], jh[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == ["dec_plc.msgpack",
                                                               "dec_plc_last.msgpack"]
    # one Adam step each: within 2 lr of each other (noise-floor gradients)
    tree, ep, _ = jckpt.load_checkpoint(os.path.join(pd, "dec_plc.msgpack"),
                                        jp.tactile_dac["decoder"])
    jtree, jep, _ = jckpt.load_checkpoint(os.path.join(jd, "dec_plc.msgpack"),
                                          jp.tactile_dac["decoder"])
    assert ep == jep == 1
    moved = 0.0
    for a, b, c in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree),
                       jax.tree.leaves(jp.tactile_dac["decoder"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=2 * 2e-4 + 1e-6)
        moved = max(moved, float(np.abs(np.asarray(a) - np.asarray(c)).max()))
    assert moved > 0.0


def test_decoder_ft_writes_a_decoder_that_loads(models, decft_runs):
    """Only decoder leaves change: the written decoder differs from the
    stock one, and the codec's other leaves are what they were."""
    _, m = models
    pd, _ = decft_runs["port"]
    dec = convert.load_decoder(os.path.join(pd, "dec_plc.msgpack"), CFG.dac)
    diffs = [float((a - b).abs().max()) for (_, a, _), (_, b, _) in
             zip(convert.decoder_leaves(dec), convert.decoder_leaves(m.tactile_dac.decoder))]
    assert max(diffs) > 0.0


# ---------------------------------------------------------------- dec_ft in the evaluator

def test_dec_ft_reaches_the_concealed_decode_only(models, tmp_path):
    """As the JAX package's ``test_eval_uses_ft_decoder_for_conceal_only``: a
    perturbed decoder changes the concealed metrics and leaves the
    zero-fill floor as it was; the rows equal JAX's."""
    jp, m = models
    rng = np.random.default_rng(3)
    ap, tp = str(tmp_path / "a.wav"), str(tmp_path / "t.wav")
    write_wav(ap, (0.3 * rng.standard_normal(12000)).astype(np.float32), 24000, subtype="FLOAT")
    write_wav(tp, (0.3 * rng.standard_normal(12000)).astype(np.float32), 24000, subtype="FLOAT")
    mask_fn = lambda t_lat: (np.arange(t_lat) % 3 == 0)      # noqa: E731
    jdec = jax.tree.map(lambda x: x + np.float32(0.01), jp.tactile_dac["decoder"])
    dec = Decoder(CFG.dac)
    convert._load(convert.decoder_leaves(dec), jax.tree.map(np.asarray, jdec))
    row0 = eval_uniform.eval_plc_file(m, ap, tp, mask_fn, 1.0, mask_embed=True, device="cpu")
    row1 = eval_uniform.eval_plc_file(m, ap, tp, mask_fn, 1.0, mask_embed=True, dec_ft=dec,
                                      device="cpu")
    assert row0["psnr_masked_zero_db"] == row1["psnr_masked_zero_db"]
    assert row0["stsim_global_zero"] == row1["stsim_global_zero"]
    assert row0["psnr_masked_db"] != row1["psnr_masked_db"]
    assert np.isnan(row0["psnr_masked_stockdec_db"])
    assert row1["psnr_masked_stockdec_db"] == row0["psnr_masked_db"]
    ref = jeval_uniform.eval_plc_file(jp, JCFG, ap, tp, mask_fn, 1.0, mask_embed=True,
                                      dec_ft=jdec)
    for k, v in ref.items():
        if isinstance(v, str):
            assert row1[k] == v
        else:
            tol = STSIM_TOL if "stsim" in k else 1e-5 if "mae" in k else DB_TOL
            assert abs(row1[k] - v) <= tol, k


# ---------------------------------------------------------------- entry points

def test_plc_entry_points_need_the_card(models, monkeypatch, tmp_path):
    _, m = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_plc(CFG, TrainConfig(**TCFG), PCFG, _bb(m), lambda ep: iter(TRAIN),
                        lambda: iter(VAL), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.finetune_inpaint_decoder(CFG, TrainConfig(**TCFG), PCFG, _bb(m), m.head,
                                       lambda ep: iter(TRAIN), lambda: iter(VAL), str(tmp_path))


def test_plc_scripts_run_on_the_evidence_corpus(monkeypatch, tmp_path):
    """``train_plc`` (with the decoder fine-tune), ``build_latent_cache``,
    ``train_plc_decft`` on that cache and ``eval_plc`` (which takes
    ``dec_plc.msgpack`` unless ``--no-dec-ft``), on the evidence corpus and
    backbone, the tiny configuration in place of the full width, on the
    CPU."""
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts import (
        build_latent_cache, eval_plc, train_plc, train_plc_decft)
    for mod in (train_plc, train_plc_decft, eval_plc):
        monkeypatch.setattr(mod, "CodecConfig", lambda: CodecConfig().tiny())
    run = str(tmp_path / "run")
    common = ["--audio-dir", CORPUS[0], "--tact-dir", CORPUS[1], "--backbone", BACKBONE, "--cpu"]
    hist = train_plc.main(["--out-dir", run, "--epochs", "1", "--batch", "4",
                           "--plc-layers", "2", "--decoder-ft-epochs", "1", *common])
    assert len(hist["train"]) == 1
    # one epoch: no best (best_after_epoch 6), the fine-tune takes the last head
    assert {"last.msgpack", "meta.json", "dec_plc.msgpack"} <= set(os.listdir(run))
    cache = str(tmp_path / "cache.npz")
    build_latent_cache.main(["--out", cache, "--max-pairs", "6", "--tiny", *common])
    dh = train_plc_decft.main(["--run-dir", run, "--backbone", BACKBONE, "--cache-file", cache,
                               "--epochs", "1", "--batch", "2", "--pairs", "4", "--val-pairs",
                               "2", "--cpu"])
    assert len(dh["train"]) == 1 and np.isfinite(dh["train"][0])
    with_ft = eval_plc.main(["--run-dir", run, "--max-files", "2", *common])
    without = eval_plc.main(["--run-dir", run, "--max-files", "2", "--no-dec-ft", *common])
    assert np.isfinite(with_ft["dec_ft_gain_masked_db"])
    assert np.isnan(without["dec_ft_gain_masked_db"])
    assert with_ft["mean_psnr_masked_zero_db"] == without["mean_psnr_masked_zero_db"]
    assert os.path.exists(os.path.join(EVIDENCE, "corpus"))
