"""The port's codec-head training over the data-parallel mesh, on gloo ranks.

Tiny configuration (``tests/test_allpred_ar.py::tiny_codec_cfg``), a global
batch of 4 x 3200 samples from a numpy seed, the JAX package's random init
carried across, on 2 and 4 ranks, flat and 2 x 2 hybrid:

- one sharded ``train_codec`` step with the EMA codebook step on and no
  dropout against the JAX package's single-device ``train_step`` on the same
  inputs and weights, with JAX's own sharded-step tolerances
  (``tests/test_parallel.py``): loss ``rel=1e-5``, head leaves ``rtol=1e-3,
  atol=1e-4``; every rank holds the same head;
- two steps with the predictor's dropout and dead-code reseeding on
  (``dead_frac`` 0.1, which the EMA step's first call exercises on zero
  counts) against the port's meshless steps, same tolerances: the dropout
  masks are the global batch's draw, the reseeds the global tokens';
- ``train_codec`` for two epochs on 2 ranks (and on a latent cache) against
  the meshless run: every ``hist`` series within 1e-5 relative, the same
  files written, by rank 0 alone.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_vqvae_compression_audio_tactile_tpu.train import loop as jloop
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import TrainConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models.allpred_ar import Head
from multimodal_vqvae_compression_audio_tactile_tpu_torch.parallel import dryrun
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import latent_cache

from test_torch_parallel import save
from test_torch_train import batch, codec_pair, jax_cfg, leaves_close, port_cfg

SEG = 3200
MESHES = [(2, ("flat",)), (4, ("flat",)), (4, ("hybrid", 2))]


def head_of(cfg, state: dict) -> Head:
    h = Head(cfg)
    h.load_state_dict(state)
    return h


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX package's single-device step and the step specs: no dropout
    against JAX; dropout and reseeding against the meshless port."""
    d = tmp_path_factory.mktemp("codec")
    tcfg = TrainConfig(epochs=2, batch=4, seg_sec=SEG / 24000)
    a, tc = batch(7, B=4, T=SEG)
    jcfg = jax_cfg(dead_frac=0.0)
    jp, m = codec_pair(jcfg)
    jtcfg = JTrainConfig(epochs=2, batch=4, seg_sec=SEG / 24000)
    tx = jloop.make_optimizer(jp.head, jtcfg, steps_per_epoch=1)
    jstep, _ = jloop.make_train_step(jcfg, jtcfg, tx)
    jstate = jloop.TrainState(jp.head, tx.init(jp.head), jnp.zeros((), jnp.int32))
    jstate, jmetrics = jstep(jstate, {"audio": jp.audio_dac, "tactile": jp.tactile_dac},
                             jnp.asarray(a), jnp.asarray(tc), None, do_ema=True)
    vs_jax = {"kind": "codec_step", "cfg": port_cfg(jcfg), "tcfg": tcfg, "modules": m,
              "batches": [(a, tc)], "base_seed": None, "do_ema": True}
    dcfg = jax_cfg(dropout=0.1, dead_frac=0.1)
    _, m2 = codec_pair(dcfg, seed=1)
    drop = {"kind": "codec_step", "cfg": port_cfg(dcfg), "tcfg": tcfg, "modules": m2,
            "batches": [(a, tc), batch(8, B=4, T=SEG)], "base_seed": 3, "do_ema": True,
            "steps_per_epoch": 2}
    return {"dir": d, "specs": {"jax": vs_jax, "drop": drop}, "jstate": jstate,
            "jmetrics": np.asarray(jmetrics), "cfg": port_cfg(jcfg),
            "drop_local": dryrun.run_local(save(d / "drop.pt", drop))}


def _meshed(steps, n, cases) -> dict:
    d = steps["dir"]
    paths = [save(d / f"{k}{n}{mesh[0]}.pt", dict(steps["specs"][k], mesh=mesh))
             for k, mesh in cases]
    return dict(zip(cases, dryrun.run_ranks(n, paths, str(d / f"w{n}"))))


@pytest.fixture(scope="module")
def meshed2(steps):
    return _meshed(steps, 2, [("jax", ("flat",)), ("drop", ("flat",))])


@pytest.fixture(scope="module")
def meshed4(steps):
    return _meshed(steps, 4, [("jax", ("flat",)), ("jax", ("hybrid", 2)),
                              ("drop", ("hybrid", 2))])


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    """``train_codec`` runs, on waveform batches and on a latent cache,
    meshless and on 2 ranks."""
    d = tmp_path_factory.mktemp("entries")
    ecfg = jax_cfg(dropout=0.1, dead_frac=0.1, ema_warm=1)
    _, m3 = codec_pair(ecfg, seed=2)
    bb = {"audio": m3.audio_dac, "tactile": m3.tactile_dac}
    pairs = [batch(20 + i, B=4, T=SEG) for i in range(2)]
    entry = {"kind": "entry", "entry": "train_codec", "cfg": port_cfg(ecfg), "seed": 3,
             "tcfg": TrainConfig(epochs=2, batch=4, seg_sec=SEG / 24000, best_after_epoch=0),
             "backbones": bb, "batches": pairs, "out_dir": str(d / "entry")}
    cache = latent_cache.build_latent_cache(bb, port_cfg(ecfg), pairs, device="cpu")
    specs = {"entry": entry, "cached": dict(entry, cache=cache, seg_tok=8,
                                            out_dir=str(d / "cached"))}
    local = {k: dryrun.run_local(save(d / f"{k}.pt", s)) for k, s in specs.items()}
    paths = [save(d / f"{k}2.pt", dict(s, mesh=("flat",))) for k, s in specs.items()]
    meshed = dict(zip(specs, dryrun.run_ranks(2, paths, str(d / "w2"))))
    return {"dir": d, "local": local, "meshed": meshed}


def ranks_agree(outs, key):
    for out in outs[1:]:
        for k, v in out[key].items():
            assert torch.equal(v, outs[0][key][k]), k


@pytest.mark.parametrize("n,mesh", MESHES, ids=lambda v: str(v))
def test_sharded_step_matches_jax_single_device(steps, request, n, mesh):
    outs = request.getfixturevalue(f"meshed{n}")[("jax", mesh)]
    ranks_agree(outs, "head")
    got = outs[0]
    assert float(got["metrics"][0, 0]) == pytest.approx(float(steps["jmetrics"][0]), rel=1e-5)
    np.testing.assert_allclose(got["metrics"][0].numpy(), steps["jmetrics"], rtol=1e-4,
                               atol=1e-6)
    leaves_close(steps["jstate"].head, head_of(steps["cfg"], got["head"]), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,mesh", [(2, ("flat",)), (4, ("hybrid", 2))], ids=lambda v: str(v))
def test_sharded_steps_with_dropout_and_reseeds_match_meshless(steps, request, n, mesh):
    outs = request.getfixturevalue(f"meshed{n}")[("drop", mesh)]
    ranks_agree(outs, "head")
    ref = steps["drop_local"]
    np.testing.assert_allclose(outs[0]["metrics"].numpy(), ref["metrics"].numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(outs[0]["eval"].numpy(), ref["eval"].numpy(), rtol=1e-5,
                               atol=1e-7)
    for k, v in ref["head"].items():
        np.testing.assert_allclose(outs[0]["head"][k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["entry", "cached"])
def test_train_codec_meshed_run_matches_meshless(entries, kind):
    outs = entries["meshed"][kind]
    ref = entries["local"][kind]
    assert outs[0]["files"] == ref["files"]
    assert {"last.msgpack", "best.msgpack", "hist.json"} <= set(ref["files"])
    for out in outs:
        assert sorted(out["hist"]) == sorted(ref["hist"])
        for k, v in ref["hist"].items():
            np.testing.assert_allclose(out["hist"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    with open(os.path.join(entries["dir"], kind, "hist.json")) as f:
        assert json.load(f) == outs[0]["hist"]
