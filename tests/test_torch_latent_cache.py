"""The port's latent cache and cached-latent training against the JAX
package's, on the CPU.

Tiny configuration (``tests/test_allpred_ar.py::tiny_codec_cfg``: 64-dim
latents, 2 books of 16 codes, 4-token chunks), the predictor's dropout and
``dead_frac`` 0, the JAX package's random init carried across, inputs from
numpy seeds:

- crop plans (``_crop_range`` with its raise and its whole-file case,
  ``crop_indices``, ``crop_index_arrays``, ``cached_batches``) and
  ``gather_crops`` equal the JAX package's exactly;
- ``build_latent_cache`` within 1e-5 of JAX's; a ``.npz`` written by either
  package loads in the other, equal;
- one cached train step on the same crops: with the L1 and STFT terms, loss
  within 1e-6 relative and every head gradient as ``tests/test_torch_train.py``
  bounds them (rtol 1e-4, atol 1e-6); with the mel-cosine term too, the loss
  within 1e-6 relative beyond the two loss functions' own gap on one
  waveform (on the random decoder's near-silent mel bins, the log-mel
  term's value differs by ~5e-5 relative and its gradient by up to ~5% of a
  leaf's largest between the packages);
- the whole-epoch path equals the per-step loop on the same crops, bit for
  bit;
- ``train_codec(cache=...)`` from one JAX-written head for two epochs on
  both sides (hist within 1e-4 relative, the mel-cosine series 5e-4 for the
  reason above), then resumed to a third epoch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import LossConfig as JLossConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_vqvae_compression_audio_tactile_tpu.losses.losses import codec_loss as jcodec_loss
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu.train import latent_cache as jlc
from multimodal_vqvae_compression_audio_tactile_tpu.train import loop as jloop
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import LossConfig, TrainConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses.losses import codec_loss
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import latent_cache as lc
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import loop

from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)
from test_torch_train import batch, codec_pair, jax_cfg, leaves_close, port_cfg

SEG_TOK = 10
HOP = 320


def _port_cache(jcache) -> lc.LatentCache:
    return lc.LatentCache(*(torch.from_numpy(np.asarray(x).copy()) for x in jcache))


@pytest.fixture(scope="module")
def setup():
    """Both packages' codecs (dropout 0, dead_frac 0, EMA from epoch 2) and
    the JAX cache of 6 pairs of 0.2 s (15 tokens) in three batches."""
    jcfg = jax_cfg(dropout=0.0, dead_frac=0.0, ema_warm=1)
    jp, m = codec_pair(jcfg, seed=5)
    batches = [batch(40 + i) for i in range(3)]
    jcache = jlc.build_latent_cache({"audio": jp.audio_dac, "tactile": jp.tactile_dac}, jcfg,
                                    iter(batches))
    return jcfg, jp, m, batches, jcache


# ---------------------------------------------------------------- crop plans

@pytest.mark.parametrize("total,seg", [(75, 75), (77, 75), (78, 75), (79, 75), (80, 75),
                                       (150, 75), (15, 10), (200, 10)])
def test_crop_range_matches_jax(total, seg):
    assert lc._crop_range(total, seg) == jlc._crop_range(total, seg)


def test_crop_range_whole_file_and_too_short():
    assert lc._crop_range(75, 75) == (0, 1)           # the one exact whole-file crop
    assert lc._crop_range(77, 75) == (0, 3)
    lo, hi = lc._crop_range(150, 75)
    assert (lo, hi) == (lc.EDGE_TOKENS, 150 - 75 - lc.EDGE_TOKENS) and lc.EDGE_TOKENS == 2
    with pytest.raises(ValueError, match="too short"):
        lc._crop_range(74, 75)


@pytest.mark.parametrize("seed,epoch", [(7, 0), (7, 3), (84, 1)])
def test_crop_indices_match_jax(seed, epoch):
    got = list(lc.crop_indices(6, 150, 75, 3, 4, seed, epoch))
    ref = list(jlc.crop_indices(6, 150, 75, 3, 4, seed, epoch))
    assert len(got) == len(ref) == 4
    for (i, t), (ji, jt) in zip(got, ref):
        assert i.dtype == t.dtype == np.int32
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_array_equal(t, np.asarray(jt))


@pytest.mark.parametrize("rows,total,seg", [([0, 1, 2, 3], 15, 10), ([5, 2, 9], 150, 75),
                                            (list(range(8)), 75, 75)])
def test_crop_index_arrays_match_jax(rows, total, seg):
    for seed, epoch in ((7, 1), (84, 0)):
        got = lc.crop_index_arrays(rows, total, seg, 2, 3, seed, epoch)
        ref = jlc.crop_index_arrays(rows, total, seg, 2, 3, seed, epoch)
        for g, r in zip(got, ref):
            assert g.dtype == np.int32 and g.shape == (3, 2)
            np.testing.assert_array_equal(g, r)


def test_gather_crops_matches_jax():
    rng = np.random.default_rng(0)
    arrays = (rng.standard_normal((5, 8, 40)).astype(np.float32),
              rng.standard_normal((5, 8, 40)).astype(np.float32),
              rng.standard_normal((5, 1, 40 * 4)).astype(np.float32))
    idx, tok0 = np.array([4, 0, 4, 2], np.int32), np.array([0, 30, 17, 5], np.int32)
    got = lc.gather_crops(lc.LatentCache(*map(torch.from_numpy, arrays)),
                          torch.from_numpy(idx), torch.from_numpy(tok0), 10, 4)
    ref = jlc.gather_crops(jlc.LatentCache(*map(jnp.asarray, arrays)), jnp.asarray(idx),
                           jnp.asarray(tok0), 10, 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[2].shape == (4, 1, 40)


def test_cached_batches_match_jax(setup):
    jcfg, _, _, _, jcache = setup
    cache = _port_cache(jcache)
    got = list(lc.cached_batches(cache, port_cfg(jcfg), 2, 3, SEG_TOK, 7, 2, indices=[0, 3, 5]))
    ref = list(jlc.cached_batches(jcache, jcfg, 2, 3, SEG_TOK, 7, 2, indices=[0, 3, 5]))
    assert len(got) == len(ref) == 3
    for gb, rb in zip(got, ref):
        for g, r in zip(gb, rb):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------- the cache

def test_build_latent_cache_matches_jax(setup):
    jcfg, _, m, batches, jcache = setup
    cache = lc.build_latent_cache({"audio": m.audio_dac, "tactile": m.tactile_dac},
                                  port_cfg(jcfg), iter(batches), device="cpu")
    assert cache.qa.shape == (6, 64, 15) and cache.tc.shape == (6, 1, 15 * HOP)
    for g, r in zip(cache, jcache):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cache.tc.numpy(), np.asarray(jcache.tc))


def test_cache_file_moves_between_packages(setup, tmp_path):
    _, _, _, _, jcache = setup
    jlc.save_cache(str(tmp_path / "j.npz"), jcache)
    got = lc.load_cache(str(tmp_path / "j.npz"), device="cpu")
    for g, r in zip(got, jcache):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    lc.save_cache(str(tmp_path / "p.npz"), got)
    back = jlc.load_cache(str(tmp_path / "p.npz"))
    for g, r in zip(back, jcache):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_cache_entry_points_need_the_card(monkeypatch, setup, tmp_path):
    jcfg, _, m, batches, jcache = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lc.build_latent_cache({"audio": m.audio_dac, "tactile": m.tactile_dac},
                              port_cfg(jcfg), iter(batches))
    lc.save_cache(str(tmp_path / "c.npz"), _port_cache(jcache))
    with pytest.raises(RuntimeError, match="CUDA"):
        lc.load_cache(str(tmp_path / "c.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train_codec(port_cfg(jcfg), TrainConfig(epochs=1, batch=2),
                         {"audio": m.audio_dac, "tactile": m.tactile_dac}, None, None,
                         str(tmp_path / "run"), cache=_port_cache(jcache), seg_tok=SEG_TOK)


# ---------------------------------------------------------------- cached steps

def _capture_grads() -> optax.GradientTransformation:
    """An optax transform whose state after an update is the gradient and
    whose update is zero: the JAX step's gradients, read exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("loss", ["l1_stft", "full"])
def test_cached_train_step_matches_jax(setup, loss):
    """One cached step on the same crops. ``l1_stft`` (the mel-cosine weight
    0): loss within 1e-6 relative, every head gradient within rtol 1e-4,
    atol 1e-6. ``full``: the loss within 1e-6 relative beyond the two loss
    functions' own gap on the JAX step's waveform; the gradients are not
    compared, the mel-cosine term's own differing by up to ~5% of a leaf's
    largest on these random-decoder outputs (the log of near-silent mel
    bins)."""
    jcfg, jp, m, _, jcache = setup
    weights = dict(w_melcos=0.0) if loss == "l1_stft" else {}
    idx, tok0 = np.array([1, 4], np.int32), np.array([0, 3], np.int32)
    jqa, jzt, jtc = jlc.gather_crops(jcache, jnp.asarray(idx), jnp.asarray(tok0), SEG_TOK, HOP)
    jtcfg = JTrainConfig(epochs=2, batch=2, loss=JLossConfig(**weights))
    jstep, _ = jloop.make_train_step(jcfg, jtcfg, _capture_grads())
    # copies: the jitted step donates its state
    jstate = jloop.TrainState(jax.tree.map(jnp.array, jp.head),
                              jax.tree.map(jnp.zeros_like, jp.head), jnp.zeros((), jnp.int32))
    jstate, jmetrics = jstep(jstate, {"audio": jp.audio_dac, "tactile": jp.tactile_dac},
                             (jqa, jzt), jtc, None, do_ema=False)

    _, m2 = codec_pair(jcfg, seed=5)
    tcfg = TrainConfig(epochs=2, batch=2, loss=LossConfig(**weights))
    state = loop.TrainState(m2, loop.AdamW(loop.adamw_params(m2.head), tcfg, 3))
    step, _ = loop.make_step_fns(port_cfg(jcfg), tcfg)
    crops = [torch.from_numpy(np.array(x)) for x in (jqa, jzt, jtc)]
    metrics = step(state, (crops[0], crops[1]), crops[2], None, do_ema=False)
    floor = 0.0
    if loss == "full":
        jroll = jar.ar_roll(jp.head, jcfg, jqa, jzt)
        y = np.asarray(jdac.decode(jp.tactile_dac, jcfg.dac, jroll.z_run))
        floor = abs(float(codec_loss(torch.from_numpy(y), crops[2])[0])
                    - float(jcodec_loss(jnp.asarray(y), jtc)[0]))
    assert abs(float(metrics[0]) - float(jmetrics[0])) <= 1e-6 * float(jmetrics[0]) + floor
    if loss == "l1_stft":
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jmetrics), rtol=1e-4, atol=1e-6)
        leaves_close(jax.tree.map(np.asarray, jstate.opt_state), m2.head, rtol=1e-4, atol=1e-6,
                     grads=True)
    assert all(p.grad is None for p in m2.tactile_dac.parameters())


def test_cached_epoch_equals_the_per_step_loop(setup):
    """``make_cached_epoch_fns`` runs the step functions over the plan:
    bit-equal heads and metric means."""
    jcfg, _, _, _, jcache = setup
    cfg, tcfg = port_cfg(jcfg), TrainConfig(epochs=2, batch=2)
    cache = _port_cache(jcache)
    idxs, tok0s = (torch.from_numpy(x) for x in lc.crop_index_arrays(
        [0, 1, 2, 3], 15, SEG_TOK, 2, 3, 7, 1))
    states = []
    for _ in range(2):
        _, m = codec_pair(jcfg, seed=5)
        states.append(loop.TrainState(m, loop.AdamW(loop.adamw_params(m.head), tcfg, 3)))
    train_epoch, eval_epoch = loop.make_cached_epoch_fns(cfg, tcfg, SEG_TOK)
    mean_epoch = train_epoch(states[0], cache, idxs, tok0s, 11, do_ema=True)
    step, eval_step = loop.make_step_fns(cfg, tcfg)
    ms = []
    for i, t0 in zip(idxs, tok0s):
        qa, zt, tc = lc.gather_crops(cache, i, t0, SEG_TOK, HOP)
        ms.append(step(states[1], (qa, zt), tc, 11, do_ema=True))
    assert torch.equal(mean_epoch, torch.stack(ms).mean(0))
    for (k, a), b in zip(states[0].head.state_dict().items(),
                         states[1].head.state_dict().values()):
        assert torch.equal(a, b), k
    with torch.no_grad():
        ev = eval_epoch(states[0].m, cache, idxs, tok0s)
        ref = torch.stack([eval_step(states[1].m, lc.gather_crops(cache, i, t0, SEG_TOK, HOP)[:2],
                                     lc.gather_crops(cache, i, t0, SEG_TOK, HOP)[2])
                           for i, t0 in zip(idxs, tok0s)]).mean(0)
    assert torch.equal(ev, ref)


# ---------------------------------------------------------------- train_codec

@pytest.fixture(scope="module")
def cached_runs(setup, tmp_path_factory):
    """JAX's and the port's ``train_codec(cache=...)`` for two epochs from
    one JAX-written head (a resumable epoch-0 checkpoint), same cache."""
    jcfg, jp, m, _, jcache = setup
    out = {}
    kw = dict(steps_per_epoch=3, cache_train_rows=[0, 1, 2, 3], cache_val_rows=[4, 5],
              seg_tok=SEG_TOK, val_steps=1, seed=3, resume=True, log=lambda s: None)
    for side in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(side))
        jckpt.save_checkpoint(os.path.join(d, "last.msgpack"), jp.head, 0, {})
        if side == "jax":
            hist = jloop.train_codec(jcfg, JTrainConfig(epochs=2, batch=2, best_after_epoch=0),
                                     {"audio": jp.audio_dac, "tactile": jp.tactile_dac},
                                     None, None, d, cache=jcache, **kw)
        else:
            hist = loop.train_codec(port_cfg(jcfg), TrainConfig(epochs=2, batch=2,
                                                                best_after_epoch=0),
                                    {"audio": m.audio_dac, "tactile": m.tactile_dac},
                                    None, None, d, cache=_port_cache(jcache), device="cpu",
                                    **kw)
        out[side] = (d, hist)
    return out


def test_train_codec_on_the_cache_matches_jax(cached_runs):
    (_, jh), (_, ph) = cached_runs["jax"], cached_runs["port"]
    assert sorted(ph) == sorted(jh)
    for k in jh:
        assert len(ph[k]) == len(jh[k]) == 2, k
        # the mel-cosine series: the log-mel term's own gap (module docstring)
        np.testing.assert_allclose(ph[k], jh[k], rtol=5e-4 if k == "mel" else 1e-4, atol=1e-6,
                                   err_msg=k)
    assert ph["ema"] == [0.0, 1.0]


def test_train_codec_on_the_cache_resumes(setup, cached_runs):
    """As the JAX package's ``test_train_codec_scan_path_artifacts``: a
    third epoch from ``last.msgpack`` keeps the first two in ``hist``."""
    jcfg, _, m, _, jcache = setup
    d, hist = cached_runs["port"]
    logs = []
    hist2 = loop.train_codec(port_cfg(jcfg), TrainConfig(epochs=3, batch=2, best_after_epoch=0),
                             {"audio": m.audio_dac, "tactile": m.tactile_dac}, None, None, d,
                             steps_per_epoch=3, cache=_port_cache(jcache),
                             cache_train_rows=[0, 1, 2, 3], cache_val_rows=[4, 5],
                             seg_tok=SEG_TOK, val_steps=1, seed=3, resume=True,
                             log=logs.append, device="cpu")
    assert any("[resume]" in s and "epoch 2" in s for s in logs)
    assert len(hist2["train"]) == 3 and hist2["train"][:2] == hist["train"]
    assert np.isfinite(hist2["train"][2])
