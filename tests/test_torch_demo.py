"""The port's end-to-end demo and evidence check, on the CPU.

- ``scripts/demo_end_to_end.py`` at ``--tiny --cpu`` on 10 synthetic 1-s
  pairs, one epoch per stage, ``--cached-heads --plc-category``: every file
  of the reference contract is written (``contract_files``), the combined
  JSON has the key tree of the committed
  ``artifacts/evidence_tiny/.../eval_all_vs_backbone_rawPSNR_latency.json``,
  each row's rate is its configuration's nominal rate (within 1e-12 kbps)
  and every metric is finite; once with matplotlib and once with
  ``sys.modules["matplotlib"] = None``, where the demo and both trainers
  (``train_codec``, ``train_plc``) print their "not drawn" lines, no PNG is
  written and every other file is.
- ``evidence_tiny run`` on that root writes the ``KEEP`` paths and a
  ``MANIFEST.json`` of its headline numbers into ``--art`` and refuses
  ``artifacts/evidence_tiny``.
- ``scripts/evidence_tiny.py``: ``DEMO_FLAGS`` (less ``--cpu``), ``KEEP``,
  ``EVAL_OUTPUTS`` and the tolerances equal the JAX script's;
  ``_headline`` of the committed tree and ``_compare`` of the committed
  numbers against perturbed copies equal the JAX script's, exactly.
- Without a card and without ``--cpu``, the demo and both ``evidence_tiny``
  commands raise.
- ``slow``: ``evidence_tiny check --cpu`` reproduces ``MANIFEST.json``
  within its tolerances (PSNR 0.2 dB, ST-SIM 0.01, kbps 1e-6), the
  regenerated corpus byte-equal to the committed one.

Latency runs one untimed and one timed call (``EvalConfig(latency_warmup=0,
latency_repeats=1)``) and the shortest chains; its values are not compared.
"""

import copy
import importlib.util
import json
import math
import os
import sys

import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, EvalConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingCodec
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts import (
    demo_end_to_end, demo_eval_only, evidence_tiny)

from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_JSON = os.path.join(ROOT, "artifacts", "evidence_tiny", "sweep", "eval_vs_backbone",
                              "eval_all_vs_backbone_rawPSNR_latency.json")
ECFG = EvalConfig(latency_warmup=0, latency_repeats=1)
FLAGS = ["--tiny", "--cpu", "--pairs", "10", "--dur-sec", "1", "--pretrain-epochs", "1",
         "--codec-epochs", "1", "--plc-epochs", "1", "--plc-latent-epochs", "1",
         "--batch", "2", "--books-grid", "2,4", "--embed-grid", "32", "--cached-heads",
         "--plc-category", "--plc-layers", "2", "--seed", "7"]


@pytest.fixture
def quick_latency(monkeypatch):
    monkeypatch.setattr(demo_eval_only, "EvalConfig", lambda: ECFG)
    chained = StreamingCodec.device_time_ms
    monkeypatch.setattr(StreamingCodec, "device_time_ms",
                        lambda self, n_lo=4, n_hi=16, reps=3: chained(self, 1, 2, 1))


def key_tree(x):
    """The keys of nested dicts; a list is the tree of its rows, which must
    all have one tree."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        trees = [key_tree(v) for v in x]
        assert all(t == trees[0] for t in trees)
        return [trees[0]] if trees else []
    return None


def _metrics(combined):
    rows = list(combined["dac_24khz"].values()) + combined["proposed_runs"] + combined[
        "vc_pwq_runs"]
    return [r[k] for r in rows for k in r if k.endswith(("_mean", "_ci95"))]


@pytest.mark.parametrize("figures", [True, False], ids=["matplotlib", "no_matplotlib"])
def test_demo_writes_the_contract(tmp_path, monkeypatch, capsys, quick_latency, figures):
    if not figures:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    root = str(tmp_path / "demo")
    out = demo_end_to_end.main(["--root", root] + FLAGS)
    printed = capsys.readouterr().out

    combined = out["combined"]
    runs = [r["run"] for r in combined["proposed_runs"]]
    assert runs == ["rvqB2_K32", "rvqB4_K32"]
    missing = [p for p in demo_end_to_end.contract_files(
        root, runs, len(out["examples"]), figures=figures) if not os.path.exists(p)]
    assert not missing
    assert len(out["examples"]) == len(out["eval_pairs"]) == 2
    pngs = [f for d, _, fs in os.walk(root) for f in fs if f.endswith(".png")]
    assert (len(pngs) > 0) == figures
    if not figures:
        lines = printed.splitlines()
        assert sum("curves.png not drawn" in line for line in lines) == 4   # 2 runs + 2 PLC
        assert any(line.startswith("[plc:uniform] curves.png not drawn") for line in lines)
        assert sum("stsim_vs_kbps.png" in line and "not drawn" in line for line in lines) == 1

    with open(os.path.join(root, "sweep", "eval_vs_backbone",
                           demo_eval_only.OUT_JSON)) as f:
        written = json.load(f)
    with open(COMMITTED_JSON) as f:
        assert key_tree(written) == key_tree(json.load(f))
    cfg = CodecConfig().tiny()
    for r in written["proposed_runs"]:
        assert abs(r["kbps"] - cfg.with_rvq(r["books"], r["embed"]).kbps()) <= 1e-12
    for nq, r in written["dac_24khz"].items():
        nominal = cfg.dac.tokens_per_sec * int(nq) * math.log2(cfg.dac.codebook_size) / 1000
        assert abs(r["kbps"] - nominal) <= 1e-12
    assert all(math.isfinite(v) for v in _metrics(written) if v is not None)
    assert out["plc_uniform"]["num_files"] == 2
    # evidence_tiny run on the finished root: the KEEP paths and a MANIFEST
    # of its headline numbers into --art, never into artifacts/
    art = str(tmp_path / "art")
    man = evidence_tiny.run(root, art, cpu=True)
    assert man["smoke_numbers"] == evidence_tiny._headline(root)
    with open(os.path.join(art, "MANIFEST.json")) as f:
        assert json.load(f) == json.loads(json.dumps(man))
    assert all(os.path.exists(os.path.join(art, k)) for k in evidence_tiny.KEEP)
    with pytest.raises(ValueError, match="elsewhere"):
        evidence_tiny.run(root, evidence_tiny.ART, cpu=True)
    assert sorted(out["stages"]) == sorted([
        "corpus", "backbone", "latent_cache", "sweep", "plc_uniform_train",
        "plc_category_train", "vc_pwq", "codec_eval", "plc_uniform_eval",
        "plc_category_eval"])


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_evidence_tiny", os.path.join(ROOT, "scripts", "evidence_tiny.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evidence_constants_equal_jax():
    j = _jax_script()
    assert evidence_tiny.DEMO_FLAGS == [f for f in j.DEMO_FLAGS if f != "--cpu"]
    assert evidence_tiny.KEEP == j.KEEP and evidence_tiny.EVAL_OUTPUTS == j.EVAL_OUTPUTS
    assert (evidence_tiny.TOL_DB, evidence_tiny.TOL_STSIM, evidence_tiny.TOL_KBPS) == (
        j.TOL_DB, j.TOL_STSIM, j.TOL_KBPS)


def _perturb(numbers, where):
    out = copy.deepcopy(numbers)
    if where == "none":
        return out
    if where == "psnr_inside":
        out["proposed"][0]["psnr_mean"] += 0.19
    elif where == "psnr_outside":
        out["dac_baseline"][1]["psnr_mean"] -= 0.21
    elif where == "stsim_outside":
        out["plc_category"]["low"]["mean_stsim_global"] += 0.02
    elif where == "kbps_outside":
        out["vc_pwq"][2]["kbps"] += 1e-5
    elif where == "row_missing":
        out["proposed"].pop()
    elif where == "key_missing":
        del out["plc_uniform"]["mean_psnr_masked_db"]
    elif where == "nan":
        out["plc_uniform"]["mean_psnr_global_db"] = float("nan")
    return out


@pytest.mark.parametrize("where", ["none", "psnr_inside", "psnr_outside", "stsim_outside",
                                   "kbps_outside", "row_missing", "key_missing", "nan"])
def test_evidence_headline_and_compare_equal_jax(where):
    j = _jax_script()
    committed = evidence_tiny._headline(evidence_tiny.ART)
    assert committed == j._headline(j.ART)
    with open(os.path.join(evidence_tiny.ART, "MANIFEST.json")) as f:
        assert committed == json.load(f)["smoke_numbers"]
    fresh = _perturb(committed, where)
    bad = evidence_tiny._compare(committed, fresh)
    assert bad == j._compare(committed, fresh)
    assert (bad == []) == (where in ("none", "psnr_inside"))


@pytest.mark.parametrize("argv", [["check"], ["run"]], ids=lambda a: a[0])
def test_evidence_refuses_without_a_card(monkeypatch, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evidence_tiny.main(argv + ["--root", str(tmp_path / "r")])
    assert not os.path.exists(tmp_path / "r")


def test_demo_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo_end_to_end.main(["--root", str(tmp_path / "r"), "--tiny"])
    assert not os.path.exists(tmp_path / "r")


@pytest.mark.slow
def test_evidence_check_reproduces_the_manifest(tmp_path, quick_latency):
    res = evidence_tiny.check(str(tmp_path / "check"), cpu=True)
    assert res["mismatches"] == [] and res["corpus"] == []
    assert evidence_tiny.main(["check", "--root", str(tmp_path / "again"), "--cpu"]) == 0
