"""The port's PLC evaluators against the JAX package's and against
``artifacts/evidence_tiny/MANIFEST.json``, on the CPU.

Both packages evaluate the trained tiny heads (``plc_uniform``,
``plc_category``) on the 3 held-out pairs of the evidence corpus
(``split_items(pairs, 0.2, 300, 7)``: pair_0003, pair_0014, pair_0007), the
model in fp32. Each per-file CSV row agrees with the JAX package's within
1e-3 dB and 1e-4 ST-SIM (MAE within 1e-5, lengths and stems exactly); the
summaries agree with the MANIFEST's ``plc_uniform`` and ``plc_category``
entries within its tolerances (PSNR 0.2 dB, ST-SIM 0.01); the CSV fields and
summary keys are the JAX package's.
"""

import csv
import json
import math
import os

import jax
import pytest

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import EvalConfig as JEvalConfig
from multimodal_vqvae_compression_audio_tactile_tpu.data.pairs import pair_stems as jpair_stems
from multimodal_vqvae_compression_audio_tactile_tpu.data.pairs import split_items as jsplit_items
from multimodal_vqvae_compression_audio_tactile_tpu.plc import eval_uniform as jeval_uniform
from multimodal_vqvae_compression_audio_tactile_tpu.plc.eval_categories import (
    eval_plc_categories as jeval_plc_categories)
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import pair_stems, split_items
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import eval_uniform
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc.eval_categories import (
    eval_plc_categories)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc.train import plc_config_from_meta

from test_torch_plc import BACKBONE, EVIDENCE, HEADS, _jax_trained
from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)

MANIFEST = os.path.join(EVIDENCE, "MANIFEST.json")
CORPUS = (os.path.join(EVIDENCE, "corpus", "audio"), os.path.join(EVIDENCE, "corpus", "tactile"))
CATS = ("low", "medium", "high")
DB_TOL, STSIM_TOL = 1e-3, 1e-4


def _held_out(pair_fn, split_fn):
    _, val = split_fn(pair_fn(*CORPUS), 0.2, 300, 7)
    return val


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax" | "port": {"uniform" | "category": (out dir, summary)}}."""
    out = tmp_path_factory.mktemp("plc_eval")
    val = _held_out(pair_stems, split_items)
    quiet = lambda *_: None                            # noqa: E731
    res = {"jax": {}, "port": {}}
    for mode, fn, jfn in (("uniform", eval_uniform.eval_plc_uniform,
                           jeval_uniform.eval_plc_uniform),
                          ("category", eval_plc_categories, jeval_plc_categories)):
        head = HEADS[f"plc_{mode}"]
        jp, jcfg, jpcfg = _jax_trained(head)
        d = str(out / f"jax_{mode}")
        res["jax"][mode] = (d, jfn(jax.device_put(jp), jcfg, _held_out(jpair_stems, jsplit_items),
                                   d, jpcfg, JEvalConfig(), seed=7, log=quiet))
        pcfg = plc_config_from_meta(head)
        m = convert.load_plc(BACKBONE, head, CodecConfig().tiny(), pcfg.n_layers)
        d = str(out / f"port_{mode}")
        res["port"][mode] = (d, fn(m, val, d, pcfg, seed=7, log=quiet, device="cpu"))
    return res


def test_held_out_pairs():
    val = _held_out(pair_stems, split_items)
    assert [s for *_, s in val] == ["pair_0003", "pair_0014", "pair_0007"]
    assert val == _held_out(jpair_stems, jsplit_items)


def _check_rows(got_path, ref_path):
    got, ref = _rows(got_path), _rows(ref_path)
    assert list(got[0]) == list(ref[0]) == eval_uniform.CSV_FIELDS
    assert eval_uniform.CSV_FIELDS == jeval_uniform.CSV_FIELDS
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g["stem"] == r["stem"] and g["len_samples"] == r["len_samples"]
        for k in eval_uniform.CSV_FIELDS[2:]:
            gv, rv = float(g[k]), float(r[k])
            if math.isnan(rv):
                assert math.isnan(gv), k
                continue
            tol = STSIM_TOL if "stsim" in k else DB_TOL
            if k.startswith("mae"):
                tol = 1e-5
            assert abs(gv - rv) <= tol, (g["stem"], k, gv, rv)


def test_uniform_rows_match_jax(runs):
    _check_rows(os.path.join(runs["port"]["uniform"][0], "eval_metrics.csv"),
                os.path.join(runs["jax"]["uniform"][0], "eval_metrics.csv"))


@pytest.mark.parametrize("cat", CATS)
def test_category_rows_match_jax(runs, cat):
    _check_rows(os.path.join(runs["port"]["category"][0], f"eval_metrics_{cat}.csv"),
                os.path.join(runs["jax"]["category"][0], f"eval_metrics_{cat}.csv"))


def test_summary_keys_match_jax(runs):
    for mode, name in (("uniform", "eval_summary.json"), ("category", "eval_cat_summary.json")):
        got, ref = runs["port"][mode][1], runs["jax"][mode][1]
        assert list(got) == list(ref)
        with open(os.path.join(runs["port"][mode][0], name)) as f:
            assert list(json.load(f)) == list(ref)
        if mode == "category":
            for cat in CATS:
                assert list(got[cat]) == list(ref[cat])


def test_summaries_reproduce_manifest(runs):
    with open(MANIFEST) as f:
        man = json.load(f)
    tol, numbers = man["tolerances"], man["smoke_numbers"]
    uni = runs["port"]["uniform"][1]
    for k, v in numbers["plc_uniform"].items():
        assert abs(uni[k] - v) <= (tol["stsim"] if "stsim" in k else tol["psnr_db"]), k
    cat = runs["port"]["category"][1]
    for c in CATS:
        for k, v in numbers["plc_category"][c].items():
            if isinstance(v, float) and math.isnan(v):
                assert math.isnan(cat[c][k]), (c, k)
            elif k == "num_files":
                assert cat[c][k] == v
            else:
                t = tol["stsim"] if "stsim" in k else tol["psnr_db"]
                assert abs(cat[c][k] - v) <= t, (c, k)


def test_summaries_match_jax(runs):
    for mode in ("uniform", "category"):
        got, ref = runs["port"][mode][1], runs["jax"][mode][1]
        flat = [(got, ref)] if mode == "uniform" else [(got[c], ref[c]) for c in CATS]
        for g, r in flat:
            for k, v in r.items():
                if isinstance(v, float) and math.isnan(v):
                    assert math.isnan(g[k]), k
                else:
                    assert abs(g[k] - v) <= (STSIM_TOL if "stsim" in k else DB_TOL), k
        assert got["peak_global"] == ref["peak_global"]


def test_unported_options_raise(tmp_path):
    m = convert.load_plc(BACKBONE, HEADS["plc_uniform"], CodecConfig().tiny(), 2)
    val = _held_out(pair_stems, split_items)
    with pytest.raises(NotImplementedError, match="dec_ft"):
        eval_uniform.eval_plc_uniform(m, val, str(tmp_path), dec_ft={}, device="cpu")
    with pytest.raises(NotImplementedError, match="plot"):
        eval_uniform.eval_plc_uniform(m, val, str(tmp_path), plot_top_k=2, device="cpu")
    with pytest.raises(NotImplementedError, match="dec_ft"):
        eval_plc_categories(m, val, str(tmp_path), dec_ft={}, device="cpu")
