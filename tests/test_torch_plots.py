"""The port's figures against the JAX package's, on the CPU.

- ``eval/plots.py::rate_distortion_plots`` at the cases of
  ``tests/test_plots.py`` (all three systems; no baselines): the five
  figures, whose decoded pixels (``matplotlib.image.imread``) equal the JAX
  package's for the same rows, exactly.
- ``utils/artifacts.py::write_curves`` at ``tests/test_artifacts.py::
  test_hist_and_curves``: pixels equal to the JAX package's, exactly.
- ``example_signals`` on the evidence corpus's trained ``rvqB2_K32`` and 2
  held-out pairs against the JAX package's inline math of
  ``eval/plots.py::plot_examples`` (forward, resampling, alignment, log-mel)
  on the same checkpoints: the aligned reference and estimate within 1e-4
  of the reference's largest magnitude; the max-normalised mel magnitudes
  within 2e-6 on every bin and their dB within 1e-3 dB on the bins within
  30 dB of the maximum (a bin 140 dB down sits at fp32's rounding floor,
  where a 1e-7 difference is a dB; the measured gap there is up to 3.3 dB
  on the reference and 0.8 dB on the estimate); the PSNR equal to the proposed
  evaluator's for the file alone (within 1e-9 dB); ``draw_examples`` writes
  the JAX package's file names.
- ``plc/plots.py``: ``select_top_k`` equal to the JAX package's on the
  committed uniform evaluation's rows; ``plot_plc_example`` writes both
  figures; the evaluator's second pass (``plot_top_k``) re-runs the top
  files with pass 1's masks: its aligned signals and masks equal pass 1's
  exactly.
"""

import csv
import os

import jax
import jax.numpy as jnp
import matplotlib.image as mpimg
import numpy as np
import pytest

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import CodecConfig as JCodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu.dsp.mel import mel_mag as jmel_mag
from multimodal_vqvae_compression_audio_tactile_tpu.dsp.resample import resample as jresample
from multimodal_vqvae_compression_audio_tactile_tpu.eval import plots as jplots
from multimodal_vqvae_compression_audio_tactile_tpu.eval.metrics import (
    align_and_psnr_raw as jalign_and_psnr_raw)
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.plc import plots as jplc_plots
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu.utils import artifacts as jartifacts
from multimodal_vqvae_compression_audio_tactile_tpu.utils.wav_io import load_wav_mono
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, EvalConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import pair_stems, split_items
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import metrics as M
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import plots, proposed
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import eval_uniform
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import plots as plc_plots
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc.train import plc_config_from_meta
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import artifacts

from test_torch_plc import BACKBONE, EVIDENCE, HEADS
from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)

CORPUS = (os.path.join(EVIDENCE, "corpus", "audio"), os.path.join(EVIDENCE, "corpus", "tactile"))
RUN = os.path.join(EVIDENCE, "sweep", "rvqB2_K32")
LAT = {"enc_ms": 0.0, "dec_ms": 0.0, "enc_p50_ms": 0.0, "enc_p95_ms": 0.0,
       "dec_p50_ms": 0.0, "dec_p95_ms": 0.0}


def _row(kbps, cr, embed=None, books=None):
    r = {"kbps": kbps, "compression_ratio": cr, "stsim_mean": 0.9, "stsim_ci95": 0.01,
         "psnr_mean": 30.0 + kbps, "psnr_ci95": 0.5}
    if embed is not None:
        r["embed"] = embed
        r["books"] = books
    return r


RD_CASES = {
    "three_systems": ({4: _row(3.0, 256.0), 8: _row(6.0, 128.0)},
                      [_row(0.5, 1500.0, embed=128, books=1),
                       _row(1.1, 700.0, embed=128, books=2),
                       _row(2.2, 350.0, embed=256, books=4)],
                      [_row(1.5, 500.0), _row(4.0, 190.0)]),
    "no_baselines": ({}, [_row(0.5, 1500.0, embed=128, books=1)], []),
}


def _same_pixels(a: str, b: str) -> None:
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    assert pa.shape == pb.shape and np.array_equal(pa, pb), os.path.basename(a)


@pytest.mark.parametrize("case", sorted(RD_CASES))
def test_rate_distortion_figures_equal_jax(tmp_path, case):
    dac24, prop, vc = RD_CASES[case]
    outs = plots.rate_distortion_plots(dac24, prop, vc, str(tmp_path / "port"))
    jouts = jplots.rate_distortion_plots(dac24, prop, vc, str(tmp_path / "jax"))
    names = [os.path.basename(p) for p in outs]
    assert names == [os.path.basename(p) for p in jouts] == list(plots.RD_FIGURES)
    for p, jp in zip(outs, jouts):
        _same_pixels(p, jp)


def test_write_curves_equals_jax(tmp_path):
    hist = {"train": [1.0, 0.5], "val": [1.1, 0.6]}
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    artifacts.write_hist(str(tmp_path / "port"), hist)
    out = artifacts.write_curves(str(tmp_path / "port"), hist)
    jout = jartifacts.write_curves(str(tmp_path / "jax"), hist)
    assert os.path.basename(out) == os.path.basename(jout) == "curves.png"
    _same_pixels(out, jout)
    assert artifacts.have_matplotlib()


@pytest.fixture(scope="module")
def held_out():
    _, val = split_items(pair_stems(*CORPUS), 0.2, 300, 7)
    return val, M.compute_global_peak([t for _, t, _ in val])


@pytest.fixture(scope="module")
def examples(held_out):
    """The port's examples of rvqB2_K32 on 2 held-out pairs, at the global
    peak, and the JAX package's inline math on the same pairs."""
    val, peak = held_out
    cfg = CodecConfig().tiny()
    bb = convert.load_dac(BACKBONE, cfg.dac)
    best = {"books": 2, "embed": 32, "path": RUN}
    got = plots.example_signals(best, cfg, {"audio": bb, "tactile": bb}, val, device="cpu",
                                num_examples=2, peak=peak)

    jcfg = JCodecConfig().tiny().with_rvq(2, 32)
    jbb, _, _ = jckpt.load_checkpoint(BACKBONE, jdac.dac_init(jax.random.key(0), jcfg.dac))
    jhead, _, _ = jckpt.load_checkpoint(os.path.join(RUN, "best.msgpack"),
                                        jar.head_init(jax.random.key(0), jcfg))
    params = jar.CodecParams(jbb, jbb, jhead)
    sr24 = jcfg.dac.sample_rate
    ref = []
    for a_path, t_path, stem in val[:2]:       # eval/plots.py:174-208
        a_raw, sr_a = load_wav_mono(a_path)
        t_raw, sr_t = load_wav_mono(t_path)
        scale = max(float(np.abs(t_raw).max()), 1e-8)
        a24 = np.asarray(jresample(np.asarray(a_raw / scale), sr_a, sr24))
        t24 = np.asarray(jresample(np.asarray(t_raw / scale), sr_t, sr24))
        L = min(a24.shape[-1], t24.shape[-1])
        y24 = np.asarray(jar.forward_eval(params, jcfg, jnp.asarray(a24[None, :, :L]),
                                          jnp.asarray(t24[None, :, :L]), n_books_use=2))[0]
        est = np.asarray(jresample(np.asarray(y24 * scale), sr24, sr_t))
        _, r_a, e_a = jalign_and_psnr_raw(t_raw, est, 1.0)
        r24 = np.asarray(jresample(np.asarray(r_a), sr_t, sr24))
        e24 = np.asarray(jresample(np.asarray(e_a), sr_t, sr24))
        ref.append({"stem": stem, "ref": r_a[0], "est": e_a[0],
                    "mel_ref_db": 20 * np.log10(np.asarray(jmel_mag(r24))[0] + 1e-8),
                    "mel_est_db": 20 * np.log10(np.asarray(jmel_mag(e24))[0] + 1e-8)})
    return got, ref


def test_example_signals_match_jax(examples):
    got, ref = examples
    assert [g["stem"] for g in got] == [r["stem"] for r in ref]
    for g, r in zip(got, ref):
        for k in ("ref", "est"):
            assert g[k].shape == r[k].shape, k
            scale = float(np.abs(r["ref"]).max())
            assert float(np.abs(g[k] - r[k]).max()) <= 1e-4 * scale, k
        for k in ("mel_ref_db", "mel_est_db"):
            assert g[k].shape == r[k].shape, k
            lin = np.abs(10 ** (g[k] / 20) - 10 ** (r[k] / 20))
            assert float(lin.max()) <= 2e-6, k
            loud = r[k] > -30.0
            assert float(np.abs(g[k] - r[k])[loud].max()) <= 1e-3, k
        assert g["sr"] == 3000 and g["mel_frame_s"] == 128 / 24000


def test_example_psnr_is_the_evaluators(examples, held_out):
    got, _ = examples
    val, peak = held_out
    m = convert.load_codec(BACKBONE, os.path.join(RUN, "best.msgpack"),
                           CodecConfig().tiny().with_rvq(2, 32))
    for ex, pair in zip(got, val):
        row = proposed.evaluate_proposed_model(m, [pair], peak, books_use=2, latency=LAT,
                                               ecfg=EvalConfig(), device="cpu")
        assert abs(ex["psnr_db"] - row["psnr_mean"]) <= 1e-9, ex["stem"]


def test_draw_examples_writes_the_jax_names(examples, tmp_path):
    got, _ = examples
    outs = plots.draw_examples(got, str(tmp_path))
    assert [os.path.basename(p) for p in outs] == [
        "proposed_example_01.png", "proposed_example_01_mel.png",
        "proposed_example_02.png", "proposed_example_02_mel.png"]
    assert all(os.path.getsize(p) > 0 for p in outs)


def _committed_rows():
    with open(os.path.join(HEADS["plc_uniform"], "eval_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        r["psnr_global_db"], r["stsim_global"] = (float(r["psnr_global_db"]),
                                                  float(r["stsim_global"]))
    return rows


@pytest.mark.parametrize("k", [1, 2, 10])
def test_select_top_k_equals_jax(k):
    rows = _committed_rows()
    assert plc_plots.select_top_k(rows, k) == jplc_plots.select_top_k(rows, k)


def test_mask_spans_equal_jax():
    rng = np.random.default_rng(0)
    m = rng.random(200) < 0.4
    assert plc_plots._mask_spans(m, 3000.0) == jplc_plots._mask_spans(m, 3000.0)


def test_plot_plc_example_writes_both_figures(tmp_path):
    rng = np.random.default_rng(1)
    ref = rng.standard_normal(2400).astype(np.float32)
    est = ref + 0.1 * rng.standard_normal(2400).astype(np.float32)
    mask = rng.random(10) < 0.5
    outs = plc_plots.plot_plc_example(str(tmp_path), "s", ref, est, mask, sr=24000)
    assert [os.path.basename(p) for p in outs] == ["plc_s_wave.png", "plc_s_mel.png"]
    assert all(os.path.getsize(p) > 0 for p in outs)


def test_plot_top_k_reruns_pass_one(tmp_path, monkeypatch, held_out):
    """Every ``eval_plc_file`` call is recorded with its signals: the second
    pass re-runs the top files with the first pass's masks and gets its
    signals and rows back exactly, and draws their figures."""
    val, _ = held_out
    pcfg = plc_config_from_meta(HEADS["plc_uniform"])
    m = convert.load_plc(BACKBONE, HEADS["plc_uniform"], CodecConfig().tiny(), pcfg.n_layers)
    calls = []
    original = eval_uniform.eval_plc_file

    def recorded(*a, return_signals=False, **kw):
        row = original(*a, return_signals=True, **kw)
        calls.append(row)
        return row if return_signals else {k: v for k, v in row.items()
                                           if not k.startswith("_")}

    monkeypatch.setattr(eval_uniform, "eval_plc_file", recorded)
    eval_uniform.eval_plc_uniform(m, val, str(tmp_path), pcfg, seed=7, plot_top_k=1,
                                  device="cpu", log=lambda *_: None)
    first, second = calls[:len(val)], calls[len(val):]
    top = plc_plots.select_top_k(first, 1)
    assert sorted(r["stem"] for r in second) == sorted(top)
    by_stem = {r["stem"]: r for r in first}
    for r in second:
        p = by_stem[r["stem"]]
        for k in ("_ref", "_est", "_mask"):
            assert np.array_equal(r[k], p[k]), k
        for k in eval_uniform.CSV_FIELDS:
            assert r[k] == p[k] or (r[k] != r[k] and p[k] != p[k]), k
        for fig in ("wave", "mel"):
            assert os.path.getsize(tmp_path / f"plc_{r['stem']}_{fig}.png") > 0
