"""The port's codec evaluators against the JAX package's and against
``artifacts/evidence_tiny/MANIFEST.json``, on the CPU.

- ``eval/prepared.py``: the same pairs, scales, raw signals and batches as
  the JAX package's; the resampled signals within the resampler's own
  tolerance (2e-5, ``tests/test_torch_dsp.py``).
- ``eval_backbone_codec`` and ``eval_proposed_runs`` on the trained tiny
  codec of the evidence corpus (its 3 held-out pairs,
  ``split_items(pairs, 0.2, 300, 7)``) and ``evaluate_proposed_model`` /
  ``eval_backbone_codec`` on the JAX package's tiny init and a synthetic
  corpus, both PSNR protocols: PSNR within 1e-3 dB and ST-SIM within 1e-4 of
  the JAX package's rows, ``kbps``, ``kbps_entropy_coded``, ``n`` and the
  other counts exactly, the same keys in the same order; the MANIFEST's
  ``dac_baseline``, ``proposed`` and ``vc_pwq`` rows within its tolerances,
  and the entropy-coded rates of the committed evaluation JSON exactly.
- Run discovery, ``parse_run_dir``'s fallbacks and the best -> last
  checkpoint fallback (the JAX package's ``tests/test_eval_runners.py``).
- The VC-PWQ codec built from ``native/vcpwq``'s sources into
  ``build/vcpwq/`` (``native/`` left as it was; a failed build raises), and
  ``eval_vc_pwq`` on its files against the JAX package's.
- The latency helpers' schemas on the CPU, and the three entry points on a
  copy of the evidence root.

Latency is measured on the CPU here (``EvalConfig(latency_warmup=0,
latency_repeats=1)``) or given as a map; its values are not compared.
"""

import hashlib
import json
import math
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import CodecConfig as JCodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import EvalConfig as JEvalConfig
from multimodal_vqvae_compression_audio_tactile_tpu.data.synth import make_synth_corpus
from multimodal_vqvae_compression_audio_tactile_tpu.eval import dac_baseline as jdac_baseline
from multimodal_vqvae_compression_audio_tactile_tpu.eval import latency as jlatency
from multimodal_vqvae_compression_audio_tactile_tpu.eval import prepared as jprepared
from multimodal_vqvae_compression_audio_tactile_tpu.eval import proposed as jproposed
from multimodal_vqvae_compression_audio_tactile_tpu.eval import vcpwq as jvcpwq
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu.utils import artifacts as jartifacts
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, EvalConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import pair_stems, split_items
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import dac_baseline, latency
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import metrics as M
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import prepared, proposed, vcpwq
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingCodec
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts import (
    demo_eval_only, eval_codecs, measure_latencies)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import artifacts

from test_torch_plc import BACKBONE, EVIDENCE, ROOT
from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)

SWEEP = os.path.join(EVIDENCE, "sweep")
CORPUS = (os.path.join(EVIDENCE, "corpus", "audio"), os.path.join(EVIDENCE, "corpus", "tactile"))
EVAL_JSON = os.path.join(SWEEP, "eval_vs_backbone", "eval_all_vs_backbone_rawPSNR_latency.json")
NQ = (1, 2, 4, 8)
DB_TOL, STSIM_TOL, RESAMPLE_TOL = 1e-3, 1e-4, 2e-5
ECFG, JECFG = EvalConfig(latency_warmup=0, latency_repeats=1), JEvalConfig(latency_warmup=0,
                                                                          latency_repeats=1)
LAT = {"enc_ms": 0.0, "dec_ms": 0.0}
R5_KBPS_CODED = 4.309333333333333    # the r5 codec's entropy-coded rate on the held-out pairs
EXACT = {"kbps", "kbps_entropy_coded", "n", "tps", "bins", "books", "embed", "bits_per_code",
         "compression_ratio", "psnr_protocol", "buffer_delay_ms", "run", "checkpoint", "b",
         "label", "pairs", "stream_version"}


def quiet(*_):
    pass


def _check_row(got: dict, ref: dict, skip=("path",)):
    assert list(got) == list(ref)
    for k, v in ref.items():
        if k in skip or "delay" in k and k != "buffer_delay_ms":
            continue
        if k in EXACT:
            assert got[k] == v or (isinstance(v, float) and math.isnan(v)
                                   and math.isnan(got[k])), k
        else:
            tol = STSIM_TOL if "stsim" in k else DB_TOL
            assert abs(got[k] - v) <= tol, (k, got[k], v)


@pytest.fixture(scope="module")
def held_out():
    _, val = split_items(pair_stems(*CORPUS), 0.2, 300, 7)
    return val, M.compute_global_peak([t for _, t, _ in val])


@pytest.fixture(scope="module")
def evidence(held_out):
    """Both packages' evaluators on the trained tiny codec and the held-out
    pairs: {"jax" | "port": (backbone rows, proposed rows)}."""
    val, peak = held_out
    jcfg = JCodecConfig().tiny()
    jbb, _, _ = jckpt.load_checkpoint(BACKBONE, jdac.dac_init(jax.random.key(0), jcfg.dac))
    jbb = jax.device_put(jbb)
    jrows = (jdac_baseline.eval_backbone_codec(jbb, jcfg.dac, val, peak, JECFG, n_q_list=NQ,
                                               latency_map={str(q): LAT for q in NQ}, log=quiet),
             jproposed.eval_proposed_runs(SWEEP, jcfg, {"audio": jbb, "tactile": jbb}, val, peak,
                                          JECFG, latency_map={"rvqB2_K32": LAT,
                                                              "rvqB4_K32": LAT}, log=quiet))
    cfg = CodecConfig().tiny()
    bb = convert.load_dac(BACKBONE, cfg.dac)
    rows = (dac_baseline.eval_backbone_codec(bb, cfg.dac, val, peak, ECFG, n_q_list=NQ,
                                             log=quiet, device="cpu"),
            proposed.eval_proposed_runs(SWEEP, cfg, {"audio": bb, "tactile": bb}, val, peak,
                                        ECFG, log=quiet, device="cpu"))
    return {"jax": jrows, "port": rows}


@pytest.fixture(scope="module")
def vc_files(tmp_path_factory):
    """The evidence corpus coded by the port's source build at every budget
    of ``EvalConfig().vc_b_list``; the hashes of ``native/vcpwq`` before."""
    native = {f: _sha(os.path.join(vcpwq.NATIVE_DIR, f)) for f in os.listdir(vcpwq.NATIVE_DIR)}
    out = tmp_path_factory.mktemp("vc")
    exe = vcpwq.build_codec()
    vcpwq.code_corpus(CORPUS[1], str(out / "dec"), str(out / "comp"), EvalConfig().vc_b_list,
                      codec=exe)
    return exe, str(out / "dec"), str(out / "comp"), native


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------- prepared pairs

def test_held_out_pairs(held_out):
    val, _ = held_out
    assert [s for *_, s in val] == ["pair_0003", "pair_0014", "pair_0007"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synth_corpus(str(tmp_path_factory.mktemp("corpus")), n_pairs=5, dur_sec=0.6,
                             seed=11)


@pytest.mark.parametrize("corpus", ["evidence", "synth"])
def test_prepare_pairs_match_jax(held_out, synth, corpus):
    pairs = held_out[0] if corpus == "evidence" else synth
    got, ref = prepared.prepare_pairs(pairs, 24000), jprepared.prepare_pairs(pairs, 24000)
    assert len(got) == len(ref) == len(pairs)
    for g, r in zip(got, ref):
        assert (g.stem, g.scale, g.sr_t) == (r.stem, r.scale, r.sr_t)
        np.testing.assert_array_equal(g.t_raw, r.t_raw)
        for x, y in ((g.a24, r.a24), (g.t24, r.t24)):
            assert x.shape == y.shape and x.dtype == y.dtype == np.float32
            np.testing.assert_allclose(x, y, rtol=0, atol=RESAMPLE_TOL)


@pytest.mark.parametrize("batch", [1, 2, 16])
def test_equal_length_batches_match_jax(batch):
    """Pairs of three lengths, in an order that interleaves them: the same
    groups, indices and arrays as the JAX package's."""
    rng = np.random.default_rng(batch)
    lengths = [320, 640, 320, 960, 640, 320, 320]
    pp = [prepared.PreparedPair(f"s{i}", rng.standard_normal((1, L)).astype(np.float32),
                                rng.standard_normal((1, L)).astype(np.float32),
                                np.zeros((1, 4), np.float32), 1.0, 3000)
          for i, L in enumerate(lengths)]
    got = list(prepared.equal_length_batches(pp, batch))
    ref = list(jprepared.equal_length_batches(pp, batch))
    assert len(got) == len(ref)
    assert sorted(i for idxs, _, _ in got for i in idxs) == list(range(len(pp)))
    for (gi, ga, gt), (ri, ra, rt) in zip(got, ref):
        assert gi == ri
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gt, rt)


# ---------------------------------------------------------------- evaluators

def test_backbone_rows_match_jax(evidence):
    got, ref = evidence["port"][0], evidence["jax"][0]
    assert list(got) == list(ref) == list(NQ)
    for q in NQ:
        _check_row(got[q], ref[q])


def test_proposed_rows_match_jax(evidence):
    got, ref = evidence["port"][1], evidence["jax"][1]
    assert [r["run"] for r in got] == [r["run"] for r in ref] == ["rvqB2_K32", "rvqB4_K32"]
    for g, r in zip(got, ref):
        _check_row(g, r)
        assert g["path"] == r["path"]


def test_rows_reproduce_manifest(evidence, vc_files, held_out):
    with open(os.path.join(EVIDENCE, "MANIFEST.json")) as f:
        man = json.load(f)
    tol, want = man["tolerances"], man["smoke_numbers"]
    dac24, prop = evidence["port"]
    _, dec, comp, _ = vc_files
    vc = vcpwq.eval_vc_pwq(dec, comp, CORPUS[1], held_out[1], log=quiet)
    pairs = ([(dac24[int(r["n_q"])], r) for r in want["dac_baseline"]]
             + list(zip(prop, want["proposed"])) + list(zip(vc, want["vc_pwq"])))
    assert len(pairs) == 4 + 2 + 6
    for g, w in pairs:
        assert abs(g["kbps"] - w["kbps"]) <= tol["kbps"]
        assert abs(g["psnr_mean"] - w["psnr_mean"]) <= tol["psnr_db"]
        assert abs(g["stsim_mean"] - w["stsim_mean"]) <= tol["stsim"]
    with open(EVAL_JSON) as f:
        committed = json.load(f)["proposed_runs"]
    assert [r["kbps_entropy_coded"] for r in prop] == \
        [r["kbps_entropy_coded"] for r in committed]


@pytest.fixture(scope="module")
def tiny_init(synth):
    """The JAX package's tiny init (as its tests/test_eval_runners.py) in both
    packages, and the synthetic corpus prepared by each."""
    jcfg = JCodecConfig().tiny()
    jp = jar.codec_init(jax.random.key(5), jcfg)
    m = convert.params_from_jax(jax.tree.map(np.asarray, jp), CodecConfig().tiny())
    return jp, jcfg, m


@pytest.mark.parametrize("protocol", ["raw", "3k"])
def test_tiny_init_proposed_row_matches_jax(tiny_init, synth, protocol):
    jp, jcfg, m = tiny_init
    ref = jproposed.evaluate_proposed_model(jp, jcfg, synth, 1.0, ecfg=JECFG, protocol=protocol,
                                            latency=LAT, forward_batch=2)
    got = proposed.evaluate_proposed_model(m, synth, 1.0, ecfg=ECFG, protocol=protocol,
                                           latency=LAT, forward_batch=2, device="cpu")
    _check_row(got, ref)
    assert got["n"] == 5 and got["psnr_protocol"] == protocol


def test_tiny_init_backbone_rows_match_jax(tiny_init, synth):
    jp, jcfg, m = tiny_init
    lat = {"1": LAT, "2": LAT}
    ref = jdac_baseline.eval_backbone_codec(jp.tactile_dac, jcfg.dac, synth, 1.0, JECFG,
                                            n_q_list=(1, 2), latency_map=lat, log=quiet)
    got = dac_baseline.eval_backbone_codec(m.tactile_dac, m.cfg.dac, synth, 1.0, ECFG,
                                           n_q_list=(1, 2), latency_map=lat, forward_batch=2,
                                           log=quiet, device="cpu")
    assert list(got) == list(ref) == [1, 2]
    for q in got:
        _check_row(got[q], ref[q])


def test_batched_rows_equal_single_file_rows(tiny_init, synth):
    """A batch of 5 and five batches of 1 score every file the same."""
    _, _, m = tiny_init
    rows = [proposed.evaluate_proposed_model(m, synth, 1.0, ecfg=ECFG, latency=LAT,
                                             forward_batch=fb, device="cpu") for fb in (5, 1)]
    _check_row(rows[0], rows[1])


# ---------------------------------------------------------------- run discovery

def _sweep(tmp_path, name, ckpts, meta=True):
    """A sweep of one run ``name`` holding a tiny head with 2 books of 16
    codes under each of ``ckpts``."""
    jcfg = JCodecConfig().tiny().with_rvq(2, 16)
    run = tmp_path / "sweep" / name
    os.makedirs(run)
    head = jar.head_init(jax.random.key(9), jcfg)
    for c in ckpts:
        jckpt.save_checkpoint(str(run / c), head, 1, {})
    if meta:
        with open(run / "meta.json", "w") as f:
            json.dump({"rvq_books": 2, "rvq_embed": 16}, f)
    return str(tmp_path / "sweep")


@pytest.mark.parametrize("ckpts,used", [(("best.msgpack", "last.msgpack"), "best.msgpack"),
                                        (("last.msgpack",), "last.msgpack"),
                                        ((), None)],
                         ids=["best", "last_only", "none"])
def test_run_discovery_and_best_last_fallback(tmp_path, tiny_init, synth, ckpts, used):
    jp, _, m = tiny_init
    sweep = _sweep(tmp_path, "rvqB2_K16", ckpts)
    bbs = {"audio": m.audio_dac, "tactile": m.tactile_dac}
    rows = proposed.eval_proposed_runs(sweep, CodecConfig().tiny(), bbs, synth, 1.0, ECFG,
                                       latency_map={"rvqB2_K16": LAT}, log=quiet, device="cpu")
    jrows = jproposed.eval_proposed_runs(sweep, JCodecConfig().tiny(),
                                         {"audio": jp.audio_dac, "tactile": jp.tactile_dac},
                                         synth, 1.0, JECFG, latency_map={"rvqB2_K16": LAT},
                                         log=quiet)
    assert [r["checkpoint"] for r in rows] == [r["checkpoint"] for r in jrows] == \
        ([used] if used else [])
    for g, r in zip(rows, jrows):
        assert (g["books"], g["embed"], g["run"]) == (2, 16, "rvqB2_K16")
        _check_row(g, r)


def test_no_runs_raises(tmp_path):
    with pytest.raises(RuntimeError, match="No runs"):
        proposed.eval_proposed_runs(str(tmp_path), CodecConfig().tiny(), {}, [], 1.0,
                                    device="cpu")


def test_parse_run_dir_and_discover_runs_match_jax(tmp_path):
    cases = {"rvqB3_K64": None, "rvqB5_K32": {"rvq_books": 6, "rvq_embed": 256},
             "rvqB7_K8": "not json", "rvqB1_K2": {"rvq_books": 4}, "odd_name": {"x": 1},
             "odd_meta": {"rvq_books": 2, "rvq_embed": 8}}
    for name, meta in cases.items():
        os.makedirs(tmp_path / name)
        if meta is not None:
            with open(tmp_path / name / "meta.json", "w") as f:
                f.write(meta if isinstance(meta, str) else json.dumps(meta))
    (tmp_path / "rvqB9_K9").write_text("a file, not a run")
    for name in cases:
        p = str(tmp_path / name)
        assert artifacts.parse_run_dir(p) == jartifacts.parse_run_dir(p), name
    assert artifacts.parse_run_dir(str(tmp_path / "rvqB5_K32")) == (6, 256)
    assert artifacts.parse_run_dir(str(tmp_path / "odd_name")) is None
    assert artifacts.discover_runs(str(tmp_path)) == jartifacts.discover_runs(str(tmp_path))
    assert [os.path.basename(p) for p in artifacts.discover_runs(str(tmp_path))] == \
        ["rvqB1_K2", "rvqB3_K64", "rvqB5_K32", "rvqB7_K8"]
    assert artifacts.run_dir_name(8, 128) == jartifacts.run_dir_name(8, 128) == "rvqB8_K128"


# ---------------------------------------------------------------- VC-PWQ

def test_vc_pwq_rows_match_jax(vc_files, held_out):
    exe, dec, comp, native = vc_files
    assert exe == os.path.join(ROOT, "build", "vcpwq", "vcpwq_codec")
    assert {f: _sha(os.path.join(vcpwq.NATIVE_DIR, f)) for f in native} == native
    peak = held_out[1]
    got = vcpwq.eval_vc_pwq(dec, comp, CORPUS[1], peak, log=quiet)
    ref = jvcpwq.eval_vc_pwq(dec, comp, CORPUS[1], peak, log=quiet)
    assert [r["b"] for r in got] == list(EvalConfig().vc_b_list)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _check_row(g, r)
        assert g["stream_version"] == "v2" and g["n"] == g["pairs"] == 16


def test_vc_pwq_skips_missing_budgets(vc_files, held_out):
    _, dec, comp, _ = vc_files
    rows = vcpwq.eval_vc_pwq(dec, comp, CORPUS[1], held_out[1], b_list=(8, 7), log=quiet)
    assert [r["b"] for r in rows] == [8]


def test_vc_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(vcpwq, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(vcpwq, "CXX_FLAGS", ["-O3", "-std=c++17", "--no-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        vcpwq.build_codec()
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------- latency

def test_latency_helpers_schema_on_cpu():
    stats = latency.measure_ms_stats(lambda: sum(range(1000)), warmup=1, repeats=4,
                                     device="cpu")
    assert set(stats) == {"mean", "p50", "p95", "min", "max"}
    assert 0 <= stats["min"] <= stats["p50"] <= stats["p95"] <= stats["max"]
    assert latency.measure_ms(lambda: None, 0, 2, device="cpu") >= 0
    enc, dec = latency.measure_codec_latency_stats(lambda a, t: a + t, lambda z: z * 2, 240,
                                                   0, 2, device="cpu")
    row = latency.latency_row(enc, dec)
    assert list(row) == ["enc_ms", "dec_ms", "enc_p50_ms", "enc_p95_ms", "dec_p50_ms",
                         "dec_p95_ms"]
    assert latency.row_delays(row)["encoding_delay_ms"] == row["enc_p50_ms"]
    old = latency.row_delays({"enc_ms": 1.0, "dec_ms": 2.0})
    assert (old["encoding_delay_ms"], old["decoding_delay_ms"]) == (1.0, 2.0)
    assert math.isnan(old["encoding_delay_p95_ms"])
    assert len(latency.measure_codec_latency(lambda a, t: a, lambda z: z, 240, 0, 1,
                                             device="cpu")) == 2
    for tps in (75.0, 0.0):
        b, jb = latency.buffer_delay_ms(tps), jlatency.buffer_delay_ms(tps)
        assert b == jb or (math.isnan(b) and math.isnan(jb))
    dev = latency.measure_device_ms(lambda c, k: torch.tanh(c * k), torch.ones(64), 1, 3, 2,
                                    const_args=(0.5,), device="cpu")
    assert list(dev) == ["ms_per_call", "slope_ms", "slope_reps_ms", "slope_spread_ms",
                         "intercept_ms", "n_lo", "n_hi"]
    assert (dev["n_lo"], dev["n_hi"], len(dev["slope_reps_ms"])) == (1, 3, 2)


@pytest.mark.parametrize("r,flops,peak", [
    ({"ms_per_call": -0.1}, 0, 0), ({"ms_per_call": 1.0, "slope_spread_ms": 3.0}, 0, 0),
    ({"ms_per_call": 1.0, "slope_spread_ms": 0.1}, 0, 0),
    ({"ms_per_call": 1e-3}, 1e12, 989.0), ({"ms_per_call": 10.0}, 1e12, 989.0), ({}, 0, 0)])
def test_implausible_reason_matches_jax(r, flops, peak):
    assert latency.implausible_reason(r, flops, peak) == jlatency.implausible_reason(r, flops,
                                                                                      peak)


def test_latency_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        latency.measure_ms_stats(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        proposed.evaluate_proposed_model(None, [], 1.0, latency=LAT)


# ---------------------------------------------------------------- entry points

@pytest.fixture
def quick_latency(monkeypatch):
    """The entry points with one untimed and one timed latency call (as
    ``ECFG``) and the shortest chains in ``device_time_ms``, so that their
    tests stay short."""
    for mod in (demo_eval_only, eval_codecs, measure_latencies):
        monkeypatch.setattr(mod, "EvalConfig", lambda: ECFG)
    chained = StreamingCodec.device_time_ms
    monkeypatch.setattr(StreamingCodec, "device_time_ms",
                        lambda self, n_lo=4, n_hi=16, reps=3: chained(self, 1, 2, 1))


@pytest.fixture(scope="module")
def evidence_copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("evidence") / "root"
    shutil.copytree(EVIDENCE, root, ignore=shutil.ignore_patterns("eval_vs_backbone"))
    return root


def test_demo_eval_only_reproduces_manifest(evidence_copy, quick_latency):
    """``demo_eval_only`` on a copy of the evidence root: the MANIFEST's
    proposed, backbone (n_q 1, 2, 4, 8), VC-PWQ (b 8, 24, 48) and uniform PLC
    numbers within its tolerances, and the combined JSON's keys."""
    root = evidence_copy
    out = demo_eval_only.main(["--root", str(root), "--tiny", "--cpu"])
    with open(os.path.join(EVIDENCE, "MANIFEST.json")) as f:
        man = json.load(f)
    tol, want = man["tolerances"], man["smoke_numbers"]
    vc_want = {8: want["vc_pwq"][0], 24: want["vc_pwq"][4], 48: want["vc_pwq"][5]}
    pairs = (list(zip(out["proposed_runs"], want["proposed"]))
             + [(out["dac_24khz"][int(w["n_q"])], w) for w in want["dac_baseline"]]
             + [(r, vc_want[r["b"]]) for r in out["vc_pwq_runs"]])
    assert len(pairs) == 2 + 4 + 3
    for g, w in pairs:
        assert abs(g["kbps"] - w["kbps"]) <= tol["kbps"]
        assert abs(g["psnr_mean"] - w["psnr_mean"]) <= tol["psnr_db"]
        assert abs(g["stsim_mean"] - w["stsim_mean"]) <= tol["stsim"]
    assert out["config"]["latency_protocol"] == "host_clock_p50"
    for k, v in want["plc_uniform"].items():
        assert abs(out["plc_uniform"][k] - v) <= (tol["stsim"] if "stsim" in k
                                                  else tol["psnr_db"])
    with open(root / "sweep" / "eval_vs_backbone" / eval_codecs.OUT_JSON) as f:
        assert list(json.load(f)) == ["dac_24khz", "proposed_runs", "vc_pwq_runs", "config"]


def test_eval_codecs_writes_the_jax_keys(tmp_path, held_out, quick_latency):
    """On the 3 held-out pairs, copied into a corpus of their own."""
    for a, t, _ in held_out[0]:
        for path, sub in ((a, "audio"), (t, "tactile")):
            os.makedirs(tmp_path / sub, exist_ok=True)
            shutil.copy(path, tmp_path / sub)
    vc_dec, vc_comp = str(tmp_path / "dec"), str(tmp_path / "comp")
    vcpwq.code_corpus(str(tmp_path / "tactile"), vc_dec, vc_comp, (8,))
    combined = eval_codecs.main([
        "--audio-dir", str(tmp_path / "audio"), "--tact-dir", str(tmp_path / "tactile"),
        "--sweep-root", SWEEP,
        "--backbone", BACKBONE, "--vc-dec-dir", vc_dec, "--vc-comp-dir", vc_comp,
        "--out-dir", str(tmp_path / "out"), "--tiny", "--cpu"])
    with open(tmp_path / "out" / eval_codecs.OUT_JSON) as f:
        written = json.load(f)
    assert list(written) == ["dac_24khz", "proposed_runs", "vc_pwq_runs", "config"]
    assert list(written["dac_24khz"]) == [str(q) for q in EvalConfig().dac_nq_list]
    assert list(written["config"]) == [
        "eval_sr", "orig_tact_sr_baseline", "pcm_kbps_tact_orig", "dac_nq_list",
        "max_align_shift_samples", "sweep_root", "peak_global_raw", "vc_buffer_delay_ms",
        "dac_24khz_backbone"]
    assert [r["n"] for r in combined["proposed_runs"]] == [3, 3]
    assert [r["b"] for r in combined["vc_pwq_runs"]] == [8]


def test_measure_latencies_prints_the_jax_map(capsys, quick_latency):
    measure_latencies.main(["--backbone", BACKBONE, "--sweep-root", SWEEP, "--nq", "1,2",
                            "--tiny", "--cpu"])
    lat = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(lat) == ["backbone", "runs", "latency_protocol", "device_time"]
    assert list(lat["backbone"]) == ["1", "2"]
    assert list(lat["runs"]) == ["rvqB2_K32", "rvqB4_K32"]
    for row in (*lat["backbone"].values(), *lat["runs"].values()):
        assert list(row) == ["enc_ms", "dec_ms", "enc_p50_ms", "enc_p95_ms", "dec_p50_ms",
                             "dec_p95_ms"]
    assert lat["latency_protocol"] == "host_clock_p50"
    assert list(lat["device_time"]) == ["run", "encode_device_ms", "decode_device_ms",
                                        "protocol"]
    assert lat["device_time"]["run"] == "rvqB4_K32"


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((measure_latencies.main, ["--backbone", BACKBONE]),
                       (demo_eval_only.main, ["--root", EVIDENCE]),
                       (eval_codecs.main, ["--audio-dir", CORPUS[0], "--tact-dir", CORPUS[1],
                                           "--sweep-root", SWEEP, "--backbone", BACKBONE])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


@pytest.mark.slow
def test_r5_proposed_row_matches_jax(held_out):
    """The full-width round-5 codec (backbone + rvqB8_K128 head) through both
    packages' ``evaluate_proposed_model`` on the held-out pairs, fp32."""
    val, peak = held_out
    backbone = os.path.join(ROOT, "artifacts", "r5", "backbone_best.msgpack")
    head = os.path.join(ROOT, "artifacts", "r5", "rvqB8_K128", "best.msgpack")
    jcfg = JCodecConfig().with_rvq(8, 128)
    jbb, _, _ = jckpt.load_checkpoint(backbone, jdac.dac_init(jax.random.key(0), jcfg.dac))
    jhead, _, _ = jckpt.load_checkpoint(head, jar.head_init(jax.random.key(0), jcfg))
    ref = jproposed.evaluate_proposed_model(jax.device_put(jar.CodecParams(jbb, jbb, jhead)),
                                            jcfg, val, peak, ecfg=JECFG, latency=LAT)
    del jbb, jhead
    m = convert.load_codec(backbone, head, CodecConfig().with_rvq(8, 128))
    got = proposed.evaluate_proposed_model(m, val, peak, ecfg=ECFG, latency=LAT, device="cpu")
    _check_row(got, ref)
    # the same bytes as the JAX package's: on these three 1 s synthetic pairs
    # the adaptive coder lands above the nominal rate, in both packages
    assert got["kbps"] == 4.2 and got["kbps_entropy_coded"] == R5_KBPS_CODED
