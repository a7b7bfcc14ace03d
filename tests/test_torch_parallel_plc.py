"""The port's PLC trainer and backbone pretraining over the data-parallel mesh.

Tiny configuration, a global batch of 4 x 3200 samples from a numpy seed,
on 2 ranks (flat) and 4 (2 x 2 hybrid), against the port's meshless steps on
the same weights and inputs, with the JAX package's sharded-step tolerances
(loss and metrics ``rel=1e-5``, leaves ``rtol=1e-3, atol=1e-4``):

- the PLC train step (dropout on), its decoder-free latent step and its eval
  step, on a uniform packet mask sharded beside the batch: the two masked
  terms are ratios of sums over the whole batch, which a mean of per-shard
  ratios would miss (the masks differ from example to example);
- one reconstruction pretraining step with quantizer dropout (per-example
  depths: the losses divide by the global share of active books) and the
  usage tracking with dead-code reseeding on zero counts, and one GAN step
  (feature matching divides two global means);
- ``train_plc`` and ``pretrain_backbone`` for two epochs on 2 ranks against
  the meshless runs: ``hist`` within 1e-5 relative, the same files written.

Adam moves an element by about ``lr`` a step whatever its gradient's size,
so an element whose gradient sits at the fp32 noise floor (where a split
batch's sum order flips its sign) can move by up to ``2 lr`` a step more on
one side than on the other (``tests/test_torch_train.py`` meets the same
against JAX). The discriminators of the GAN step have such elements (2 of
27,648 in one map seen): there, at most 1e-3 of a leaf's elements may miss
the tolerance, each within Adam's bound.
"""

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, DacConfig, GanConfig, PLCConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses import gan
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models.dac import DAC, init_dac_
from multimodal_vqvae_compression_audio_tactile_tpu_torch.parallel import dryrun
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc

from test_torch_parallel import save
from test_torch_train import batch

SEG = 3200


def waves(seed: int) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal((4, 1, SEG))).astype(np.float32)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The step cases' spec files and their meshless results."""
    d = tmp_path_factory.mktemp("plc")
    cfg = CodecConfig().tiny()
    tcfg = TrainConfig(epochs=2, batch=4, seg_sec=SEG / 24000, best_after_epoch=0)
    t_lat = SEG // cfg.dac.hop
    rng = np.random.default_rng(3)

    def plc_spec(seed, latent=False):
        pm = plc.plc_init(cfg, torch.Generator().manual_seed(seed), 2)
        mk = [masks.make_token_loss_mask(rng, 4, t_lat, 2, 0.5) for _ in range(2)]
        return {"kind": "plc_step", "cfg": cfg, "tcfg": tcfg, "mask_embed": True,
                "head": pm.head, "backbones": {"audio": pm.audio_dac, "tactile": pm.tactile_dac},
                "batches": [(*batch(30, B=4, T=SEG), mk[0]), (*batch(31, B=4, T=SEG), mk[1])],
                "base_seed": 4, "latent": latent}

    dcfg = DacConfig().tiny()
    gcfg = GanConfig(periods=(2,), fft_sizes=(64,))

    def pretrain_spec(seed, gan_on=False):
        m = init_dac_(DAC(dcfg), torch.Generator().manual_seed(seed))
        spec = {"kind": "pretrain_step", "cfg": dcfg, "tcfg": tcfg, "m": m,
                "batches": [waves(40), waves(41)], "base_seed": 5,
                "counts": torch.zeros(dcfg.n_codebooks, dcfg.codebook_size)}
        if gan_on:
            spec.update(gan=gcfg, d=gan.disc_init(gcfg, torch.Generator().manual_seed(seed)))
        return spec

    specs = {"plc": plc_spec(1), "latent": plc_spec(2, latent=True),
             "pretrain": pretrain_spec(3), "gan": pretrain_spec(4, gan_on=True)}
    return {"dir": d, "specs": specs,
            "local": {k: dryrun.run_local(save(d / f"{k}.pt", s)) for k, s in specs.items()}}


def _meshed(steps, n, mesh) -> dict:
    d, specs = steps["dir"], steps["specs"]
    paths = [save(d / f"{k}{n}.pt", dict(s, mesh=mesh)) for k, s in specs.items()]
    return dict(zip(specs, dryrun.run_ranks(n, paths, str(d / f"w{n}"))))


@pytest.fixture(scope="module")
def meshed2(steps):
    return _meshed(steps, 2, ("flat",))


@pytest.fixture(scope="module")
def meshed4(steps):
    return _meshed(steps, 4, ("hybrid", 2))


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    """``train_plc`` and ``pretrain_backbone`` runs, meshless and on 2
    ranks."""
    d = tmp_path_factory.mktemp("plc_entries")
    cfg = CodecConfig().tiny()
    tcfg = TrainConfig(epochs=2, batch=4, seg_sec=SEG / 24000, best_after_epoch=0)
    pm = plc.plc_init(cfg, torch.Generator().manual_seed(9), 2)
    specs = {
        "entry_plc": {"kind": "entry", "entry": "train_plc", "cfg": cfg, "tcfg": tcfg,
                      "pcfg": PLCConfig(mask_embed=True, n_layers=2), "seed": 5,
                      "backbones": {"audio": pm.audio_dac, "tactile": pm.tactile_dac},
                      "batches": [batch(50 + i, B=4, T=SEG) for i in range(2)],
                      "out_dir": str(d / "plc_run")},
        "entry_pb": {"kind": "entry", "entry": "pretrain_backbone", "cfg": DacConfig().tiny(),
                     "tcfg": TrainConfig(epochs=2, batch=4), "seed": 6,
                     "batches": [waves(60), waves(61)], "out_dir": str(d / "pb_run")}}
    local = {k: dryrun.run_local(save(d / f"{k}.pt", s)) for k, s in specs.items()}
    paths = [save(d / f"{k}2.pt", dict(s, mesh=("flat",))) for k, s in specs.items()]
    return local, dict(zip(specs, dryrun.run_ranks(2, paths, str(d / "w2"))))


def close_states(got: dict, ref: dict, adam_bound: float = 0.0) -> None:
    """Every leaf within rtol 1e-3, atol 1e-4; with ``adam_bound``, up to
    1e-3 of a leaf's elements within that bound instead (the docstring)."""
    for k, v in ref.items():
        g, r = got[k].numpy(), v.numpy()
        miss = ~np.isclose(g, r, rtol=1e-3, atol=1e-4)
        if adam_bound and miss.mean() <= 1e-3:
            np.testing.assert_allclose(g[miss], r[miss], rtol=0, atol=adam_bound, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4, err_msg=k)


def ranks_agree(outs, key):
    for out in outs[1:]:
        for k, v in out[key].items():
            assert torch.equal(v, outs[0][key][k]), k


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["plc", "latent"])
def test_sharded_plc_step_matches_meshless(steps, request, kind, n):
    outs, ref = request.getfixturevalue(f"meshed{n}")[kind], steps["local"][kind]
    ranks_agree(outs, "head")
    for key in ("metrics", "eval"):
        np.testing.assert_allclose(outs[0][key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-7)
    close_states(outs[0]["head"], ref["head"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["pretrain", "gan"])
def test_sharded_pretrain_step_matches_meshless(steps, request, kind, n):
    outs, ref = request.getfixturevalue(f"meshed{n}")[kind], steps["local"][kind]
    ranks_agree(outs, "m")
    for key in ("metrics", "eval"):
        np.testing.assert_allclose(outs[0][key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-7)
    close_states(outs[0]["m"], ref["m"])
    if kind == "pretrain":
        for out in outs:
            torch.testing.assert_close(out["counts"], ref["counts"], rtol=1e-5, atol=1e-6)
    else:
        steps = len(outs[0]["metrics"])
        close_states(outs[0]["d"], ref["d"], adam_bound=2 * GanConfig().disc_lr * steps)


@pytest.mark.parametrize("kind", ["entry_plc", "entry_pb"])
def test_meshed_run_matches_meshless(entries, kind):
    local, meshed = entries
    outs, ref = meshed[kind], local[kind]
    assert outs[0]["files"] == ref["files"] and "hist.json" in ref["files"]
    for out in outs:
        for k, v in ref["hist"].items():
            np.testing.assert_allclose(out["hist"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
