"""The port's codec-head training against the JAX package's, on the CPU.

Tiny configuration (``tests/test_allpred_ar.py::tiny_codec_cfg``: 64-dim
latents, 2 books of 16 codes, 4-token chunks), the JAX package's random
init carried across, inputs from numpy seeds, 0.2-s segments (15 tokens:
the last chunk padded):

- one step's loss and every head gradient through the loss with no dropout
  (rtol 1e-4, atol 1e-6);
- two full train steps (AdamW, the optax-form clip, the EMA codebook step,
  ``dead_frac`` 0 so that nothing is drawn): head leaves within 1e-5. Adam
  steps each element by about ``lr * g / |g|``: its step matches to 1e-5
  only where the two packages' gradients agree to ~5%. An element whose
  gradient sits at the fp32 noise floor (the gradients agree to 1e-6
  absolute, not 5% relative, there: 31 of 35601 elements here) is
  held to Adam's own bound, ``2 * lr`` a step;
- ``train_codec`` for two epochs on both sides from the same JAX-written
  head, the predictor's dropout and ``dead_frac`` 0, the EMA on in epoch 2:
  every ``hist`` series within 1e-4 relative, and the final heads;
- the autograd refusal of the K1/K3 wrappers (F4) and the predictor's
  dropout.
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

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_vqvae_compression_audio_tactile_tpu.losses.losses import codec_loss as jcodec_loss
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu.train import loop as jloop
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, DacConfig, PredictorConfig, RVQConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses.losses import codec_loss
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar
from multimodal_vqvae_compression_audio_tactile_tpu_torch.nn import layers
from multimodal_vqvae_compression_audio_tactile_tpu_torch.nn.layers import CrossPredictor
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import loop

from test_allpred_ar import tiny_codec_cfg

SEG = 4800


def port_cfg(jcfg) -> CodecConfig:
    """The port's copy of a JAX CodecConfig (same field values)."""
    d = dataclasses.asdict(jcfg)
    dac = {k: v for k, v in d["dac"].items() if k in {f.name for f in dataclasses.fields(DacConfig)}}
    return CodecConfig(dac=DacConfig(**dac), predictor=PredictorConfig(**d["predictor"]),
                       rvq=RVQConfig(**d["rvq"]), ar_chunk_tok=jcfg.ar_chunk_tok,
                       scale_init=jcfg.scale_init, scale_min=jcfg.scale_min,
                       scale_max=jcfg.scale_max)


def jax_cfg(dropout=0.1, dead_frac=0.1, ema_warm=5):
    c = tiny_codec_cfg()
    return dataclasses.replace(
        c, predictor=dataclasses.replace(c.predictor, dropout=dropout),
        rvq=dataclasses.replace(c.rvq, dead_frac=dead_frac, ema_warm_epochs=ema_warm))


def batch(seed, B=2, T=SEG):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 24000.0
    a = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 900, (B, 1, 1)) * t) \
        + 0.05 * rng.standard_normal((B, 1, T))
    tc = 0.5 * a + 0.05 * rng.standard_normal((B, 1, T))
    return a.astype(np.float32), np.clip(tc, -1, 1).astype(np.float32)


def codec_pair(jcfg, seed=0):
    jp = jar.codec_init(jax.random.key(seed), jcfg)
    m = convert.params_from_jax(jax.tree.map(np.asarray, jp), port_cfg(jcfg))
    m.audio_dac.requires_grad_(False)
    m.tactile_dac.requires_grad_(False)
    return jp, m


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def leaves_close(tree, head, rtol, atol, grads=False, noise=None, noise_atol=None):
    """Every head leaf (or its .grad) in JAX layout against the JAX tree;
    ``noise`` {path: bool mask} marks elements held to ``noise_atol``."""
    for p, t, kind in convert.head_leaves(head):
        if grads and p[0] in ("vq_books", "vq_counts"):
            continue
        got = (t.grad if grads else t).detach()
        got = (got.transpose(0, 1) if kind == "t01" else got.T if kind == "t" else got).numpy()
        ref = _at(tree, p)
        mask = noise.get(p, np.zeros(ref.shape, bool)) if noise else np.zeros(ref.shape, bool)
        name = "/".join(map(str, p))
        np.testing.assert_allclose(got[~mask], ref[~mask], rtol=rtol, atol=atol, err_msg=name)
        if mask.any():
            np.testing.assert_allclose(got[mask], ref[mask], rtol=0, atol=noise_atol,
                                       err_msg=name)


# -------------------------------------------------------------- F4 repair

def test_refuse_autograd_when_a_gradient_would_be_recorded():
    units = [resunit.ResUnit(8) for _ in resunit.DILATIONS]
    x = torch.randn(1, 8, 50)
    with pytest.raises(RuntimeError, match="no backward"):
        resunit.refuse_autograd("resunit_stack", units, x)          # unit weights
    for u in units:
        u.requires_grad_(False)
    resunit.refuse_autograd("resunit_stack", units, x)              # frozen: fine
    with pytest.raises(RuntimeError, match="no backward"):
        resunit.refuse_autograd("resunit_stack", units, x.requires_grad_(True))
    alpha = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="resunit_stack_tm"):
        resunit.refuse_autograd("resunit_stack_tm", units, x.detach(), alpha)
    with torch.no_grad():
        resunit.refuse_autograd("resunit_stack", units, x, alpha)   # nothing recorded


def test_cpu_stacks_stay_differentiable():
    """On the CPU the wrappers are the plain versions, which train."""
    units = [resunit.ResUnit(8) for _ in resunit.DILATIONS]
    x = torch.randn(1, 8, 50, requires_grad=True)
    resunit.resunit_stack(units, x).sum().backward()
    resunit_tm.resunit_stack_tm(units, x.detach().transpose(1, 2).contiguous()).sum().backward()
    assert x.grad is not None and all(u.conv1.weight.grad is not None for u in units)


# -------------------------------------------------------------- dropout

def test_dropout_keeps_its_share_scaled_and_replays_from_a_seed(monkeypatch):
    cfg = PredictorConfig(dim=64, heads=8, dropout=0.25)
    torch.manual_seed(0)
    p = CrossPredictor(cfg)
    captured = []
    linear = layers.linear

    def spy(mod, x):       # the merged attention output, as the out projection gets it
        if mod is p.out:
            captured.append(x.detach())
        return linear(mod, x)
    monkeypatch.setattr(layers, "linear", spy)
    zt, za = torch.randn(4, 64, 16), torch.randn(4, 64, 16)
    with torch.no_grad():
        y0 = p(zt, za)
        y1 = p(zt, za, dropout=torch.Generator().manual_seed(5))
        y2 = p(zt, za, dropout=torch.Generator().manual_seed(5))
        y3 = p(zt, za, dropout=torch.Generator().manual_seed(6))
    plain, dropped = captured[0], captured[1]
    kept = dropped != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    torch.testing.assert_close(dropped[kept], plain[kept] / 0.75, rtol=1e-6, atol=0)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3) and not torch.equal(y0, y1)
    with torch.no_grad():
        assert torch.equal(p(zt, za), y0)                 # no generator: no dropout


# -------------------------------------------------------------- parity

@pytest.fixture(scope="module")
def codecs():
    jcfg = jax_cfg(dead_frac=0.0)
    jp, m = codec_pair(jcfg)
    return jcfg, jp, m


def test_loss_and_head_grads_match_jax(codecs):
    jcfg, jp, m = codecs
    a, tc = batch(1)

    def jloss(head):
        params = jar.CodecParams(jp.audio_dac, jp.tactile_dac, head)
        out = jar.forward_step(params, jcfg, jnp.asarray(a), jnp.asarray(tc))
        return jcodec_loss(out["y_hat"], out["tgt"])[0]
    jv, jg = jax.value_and_grad(jloss)(jp.head)

    m.head.zero_grad(set_to_none=True)
    out = allpred_ar.forward_step(m, torch.from_numpy(a), torch.from_numpy(tc))
    total, _ = codec_loss(out["y_hat"], out["tgt"])
    total.backward()
    np.testing.assert_allclose(float(total), float(jv), rtol=1e-4, atol=1e-6)
    leaves_close(jg, m.head, rtol=1e-4, atol=1e-6, grads=True)
    assert m.head.vq_books.grad is None
    assert all(p.grad is None for p in m.tactile_dac.parameters())


def test_forward_step_returns_training_roll(codecs):
    jcfg, jp, m = codecs
    a, tc = batch(2)
    out = allpred_ar.forward_step(m, torch.from_numpy(a), torch.from_numpy(tc))
    jout = jar.forward_step(jp, jcfg, jnp.asarray(a), jnp.asarray(tc))
    np.testing.assert_array_equal(out["codes"].numpy(), np.asarray(jout["codes"]))
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(jout["valid"]))
    assert out["r_tokens"].grad_fn is None and out["y_hat"].grad_fn is not None
    np.testing.assert_allclose(out["r_tokens"].numpy(), np.asarray(jout["r_tokens"]),
                               rtol=0, atol=1e-5)
    assert out["y_hat"].shape == out["tgt"].shape == (2, 1, SEG)


def test_serving_roll_unchanged_by_training_roll(codecs):
    _, _, m = codecs
    a, tc = batch(3)
    with torch.no_grad():
        qa, zt = allpred_ar.backbone_latents(m, torch.from_numpy(a), torch.from_numpy(tc))
        serve = allpred_ar.ar_roll(m.head, m.cfg, qa, zt)
        train = allpred_ar.ar_roll_train(m.head, m.cfg, qa, zt)
    assert torch.equal(serve.z_run, train.z_run) and torch.equal(serve.codes, train.codes)


def test_two_train_steps_match_jax(codecs):
    jcfg, jp, m0 = codecs
    spe = 2
    jtcfg = JTrainConfig(epochs=3, batch=2)
    tcfg = TrainConfig(epochs=3, batch=2)
    tx = jloop.make_optimizer(jp.head, jtcfg, spe)
    jstep, _ = jloop.make_train_step(jcfg, jtcfg, tx)
    jstate = jloop.TrainState(jp.head, tx.init(jp.head), jnp.zeros((), jnp.int32))
    backbones = {"audio": jp.audio_dac, "tactile": jp.tactile_dac}

    _, m = codec_pair(jcfg)
    state = loop.TrainState(m, loop.AdamW(loop.adamw_params(m.head), tcfg, spe))
    step, _ = loop.make_step_fns(port_cfg(jcfg), tcfg)
    noise: dict = {}
    for i in range(2):
        a, tc = batch(10 + i)

        def jloss(head):
            out = jar.forward_step(jar.CodecParams(jp.audio_dac, jp.tactile_dac, head), jcfg,
                                   jnp.asarray(a), jnp.asarray(tc))
            return jcodec_loss(out["y_hat"], out["tgt"])[0]
        jg = jax.grad(jloss)(jstate.head)
        jstate, jmetrics = jstep(jstate, backbones, jnp.asarray(a), jnp.asarray(tc), None,
                                 do_ema=True)
        metrics = step(state, torch.from_numpy(a), torch.from_numpy(tc), None, do_ema=True)
        for p, t, kind in convert.head_leaves(m.head):
            if t.grad is not None:
                g = t.grad.T if kind == "t" else t.grad
                ref = _at(jg, p)
                noise[p] = noise.get(p, False) | (np.abs(g.numpy() - ref) > 0.05 * np.abs(ref))
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jmetrics), rtol=1e-4, atol=1e-6)
    assert int(state.opt.count) == 2 and state.step == 2
    assert sum(int(v.sum()) for v in noise.values()) < 1e-2 * sum(v.size for v in noise.values())
    leaves_close(jax.tree.map(np.asarray, jstate.head), m.head, rtol=0, atol=1e-5,
                 noise=noise, noise_atol=2 * 2 * tcfg.lr)


def test_non_finite_gradient_skips_the_update(codecs):
    """apply_if_finite: the head, the moments and the count stay put."""
    _, _, m = codecs
    tcfg = TrainConfig(epochs=3)
    opt = loop.AdamW(loop.adamw_params(m.head), tcfg, 2)
    before = {k: v.clone() for k, v in m.head.state_dict().items()}
    for p in opt.params:
        p.grad = torch.ones_like(p)
    grad = next(p.grad for p in opt.params if p.dim() == 2)
    grad[0, 0] = float("nan")
    assert not bool(opt.step())
    assert int(opt.count) == 0 and all(float(mu.abs().sum()) == 0 for mu in opt.mu)
    for k, v in m.head.state_dict().items():
        assert torch.equal(v, before[k]), k
    grad[0, 0] = 0.0
    assert bool(opt.step()) and int(opt.count) == 1


def test_clip_follows_optax():
    """``AdamW.step`` against the JAX package's optimizer (optax's clip, AdamW
    and mask) on the same leaves: gradients whose global norm lies above the
    clip, then below it, then above again. The books' gradient (huge) stays
    out of the norm. Adam's moments carry each step's clipped size into the
    next, so the later updates differ if the clip does."""
    rng = np.random.default_rng(0)
    tcfg = TrainConfig(epochs=3)
    shapes = {"w": (4, 3), "b": (5,)}
    init = {k: rng.standard_normal(s).astype(np.float32) * 1e-3 for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = loop.AdamW(list(params.values()), tcfg, 2)
    jhead = {k: jnp.asarray(v) for k, v in init.items()}
    jhead["vq_books"] = jnp.zeros((2, 3), jnp.float32)
    tx = jloop.make_optimizer(jhead, tcfg, 2)
    jstate = tx.init(jhead)
    for scale in (100.0, 0.01, 30.0):
        grads = {k: rng.standard_normal(s).astype(np.float32) * scale
                 for k, s in shapes.items()}
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
        assert (norm > tcfg.grad_clip) == (scale > 1.0)
        before = {k: p.detach().clone() for k, p in params.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        assert bool(opt.step())
        jgrads = {k: jnp.asarray(v) for k, v in grads.items()}
        jgrads["vq_books"] = jnp.full((2, 3), 1e6, jnp.float32)
        jbefore = jhead
        upd, jstate = tx.update(jgrads, jstate, jhead)
        jhead = dict(optax.apply_updates(jhead, upd), vq_books=jhead["vq_books"])
        for k, p in params.items():
            np.testing.assert_allclose((p.detach() - before[k]).numpy(),
                                       np.asarray(jhead[k] - jbefore[k]), rtol=1e-5, atol=1e-10)
    assert int(opt.count) == 3


def test_schedule_matches_jax():
    jf = jloop.cosine_epoch_lr(2e-4, 5, 0.1, 3)
    pf = loop.cosine_epoch_lr(2e-4, 5, 0.1, 3)
    for s in range(0, 20):
        np.testing.assert_allclose(float(pf(s)), float(jf(s)), rtol=1e-6)


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    """JAX's and the port's train_codec, two epochs from one JAX-written
    head (written as a resumable epoch-0 checkpoint), same batches."""
    jcfg = jax_cfg(dropout=0.0, dead_frac=0.0, ema_warm=1)
    jp, m = codec_pair(jcfg, seed=3)
    tr = [batch(20 + i) for i in range(2)]
    va = [batch(30)]
    out = {}
    for side in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(side))
        jckpt.save_checkpoint(os.path.join(d, "last.msgpack"), jp.head, 0, {})
        kw = dict(train_batches=lambda ep: iter(tr), val_batches=lambda: iter(va), out_dir=d,
                  seed=3, resume=True, log=lambda s: None)
        if side == "jax":
            hist = jloop.train_codec(jcfg, JTrainConfig(epochs=2, batch=2, best_after_epoch=0),
                                     {"audio": jp.audio_dac, "tactile": jp.tactile_dac}, **kw)
        else:
            hist = loop.train_codec(port_cfg(jcfg), TrainConfig(epochs=2, batch=2,
                                                                best_after_epoch=0),
                                    {"audio": m.audio_dac, "tactile": m.tactile_dac},
                                    device="cpu", **kw)
        out[side] = (d, hist)
    return jcfg, out


def test_two_epochs_hist_matches_jax(two_epochs):
    _, out = two_epochs
    (_, jh), (_, ph) = out["jax"], out["port"]
    assert sorted(ph) == sorted(jh)
    for k in jh:
        assert len(ph[k]) == len(jh[k]) == 2, k
        np.testing.assert_allclose(ph[k], jh[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert ph["ema"] == [0.0, 1.0]
    with open(os.path.join(out["port"][0], "hist.json")) as f:
        assert json.load(f) == ph


def test_two_epochs_checkpoints_match_jax(two_epochs):
    """The port's last/best read back by the JAX package's loader, against
    the JAX run's own: same epochs and hist keys, heads within 1e-5."""
    jcfg, out = two_epochs
    template = jar.head_init(jax.random.key(0), jcfg)
    for name in ("last.msgpack", "best.msgpack"):
        jhead, jep, jhist = jckpt.load_checkpoint(os.path.join(out["jax"][0], name), template)
        phead, pep, phist = jckpt.load_checkpoint(os.path.join(out["port"][0], name), template)
        assert pep == jep and sorted(phist) == sorted(jhist)
        for a, b in zip(jax.tree.leaves(phead), jax.tree.leaves(jhead)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-5)
