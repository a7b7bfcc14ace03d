"""The port's ``.mat`` extraction and evidence collector against the JAX
package's, on the CPU.

- ``data/mat_extract.py`` at the seven cases of ``tests/test_mat_extract.py``
  (scipy structs, the field fallbacks, the raw variants' artifacts, the tree
  walk), each run through both packages on the same ``.mat`` files (written
  here with ``scipy.io.savemat``): the same results, and every written WAV
  and JSON byte-equal to the JAX package's.
- ``scripts/extract_dataset.py``: the positional CLI writes the JAX
  package's files; without arguments it prints its usage and returns 1.
- ``scripts/collect_evidence.py`` at ``tests/test_collect_evidence.py``'s
  contract, and its ``SUMMARY.txt`` equal to the JAX script's on the same
  root.
"""

import filecmp
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from multimodal_vqvae_compression_audio_tactile_tpu.data import mat_extract as jmx
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import mat_extract as mx
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts import (
    collect_evidence, extract_dataset)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import wav_io

from test_collect_evidence import _make_root

scipy_io = pytest.importorskip("scipy.io")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = lambda *a: None      # noqa: E731


def _write_mat(path, field, sig):
    scipy_io.savemat(path, {"finalMaterialRecording": {field: sig}})


def _same_tree(a, b) -> None:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, diff, errors = filecmp.cmpfiles(a, b, [n for n in names if not n.endswith(".png")],
                                       shallow=False)
    assert not diff and not errors, (diff, errors)


def test_normalize():
    x = np.array([0.5, -2.0, 1.0], np.float32)
    y = mx.normalize_audio(x)
    assert abs(np.abs(y).max() - 1.0) < 1e-6
    assert np.array_equal(y, jmx.normalize_audio(x))
    assert mx.normalize_audio(np.zeros(3)).max() == 0.0


def test_mono_downmix_heuristic():
    stereo = np.stack([np.ones(100), -np.ones(100)])  # [2, 100]
    y = mx.ensure_1d_mono(stereo)
    assert y.shape == (100,)
    np.testing.assert_allclose(y, 0.0)
    col = np.ones((100, 1))
    assert mx.ensure_1d_mono(col).shape == (100,)
    for x in (stereo, col, np.arange(30.0).reshape(3, 10), np.ones((20, 10)), np.float64(2.0)):
        assert np.array_equal(mx.ensure_1d_mono(x), jmx.ensure_1d_mono(x))


def _both(tmp_path, mat, *args, **kw):
    """``process_mat_file`` of both packages into ``port/`` and ``jax/``."""
    got = mx.process_mat_file(mat, str(tmp_path / "port"), *args, **kw)
    ref = jmx.process_mat_file(mat, str(tmp_path / "jax"), *args, **kw)
    return got, ref


def test_audio_extract_normalized_pcm16(tmp_path):
    sig = 3.0 * np.sin(2 * np.pi * 100 * np.arange(4410) / 44100)
    mat = str(tmp_path / "rec1.mat")
    _write_mat(mat, "sound", sig)
    out, ref = _both(tmp_path, mat, "sound", 44100, normalize=True)
    assert out and out.endswith("rec1.wav") and os.path.basename(ref) == "rec1.wav"
    w, sr = wav_io.read_wav(out)
    assert sr == 44100
    assert abs(np.abs(w).max() - 1.0) < 1e-3  # peak-normalised
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_tactile_raw_float_with_artifacts(tmp_path):
    sig = 2.5 * np.sin(2 * np.pi * 60 * np.arange(3000) / 3000)
    mat = str(tmp_path / "rec2.mat")
    _write_mat(mat, "accelDFT", sig)
    out, _ = _both(tmp_path, mat, "accelDFT", 3000, normalize=False, raw_artifacts=True)
    w, sr = wav_io.read_wav(out)
    assert sr == 3000
    assert abs(np.abs(w).max() - 2.5) < 0.01   # not normalised
    with open(tmp_path / "port" / "rec2.json") as f:
        assert abs(json.load(f)["max"] - 2.5) < 0.01
    assert os.path.getsize(tmp_path / "port" / "rec2.png") > 0
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_missing_field_returns_none(tmp_path):
    mat = str(tmp_path / "bad.mat")
    scipy_io.savemat(mat, {"unrelated": np.ones(5)})
    assert _both(tmp_path, mat, "sound", 44100) == (None, None)


def test_fallback_key_hint(tmp_path):
    mat = str(tmp_path / "hint.mat")
    scipy_io.savemat(mat, {"my_sound_data": np.ones(50)})
    out, ref = _both(tmp_path, mat, "sound", 44100)
    assert out is not None and ref is not None
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_extract_corpus_walks_tree(tmp_path):
    sub = tmp_path / "db" / "C5" / "material1"
    sub.mkdir(parents=True)
    _write_mat(str(sub / "a.mat"), "sound", np.sin(np.arange(1000) * 0.1))
    _write_mat(str(sub / "b.mat"), "accelDFT", np.cos(np.arange(700) * 0.3))
    for pkg, d in ((mx, "port"), (jmx, "jax")):
        n = pkg.extract_corpus(str(tmp_path / "db"), str(tmp_path / d), "audio", log=QUIET)
        assert n == 1
    assert os.path.exists(tmp_path / "port" / "a.wav")
    _same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("kind", ["audio", "tactile_raw"])
def test_extract_dataset_cli(tmp_path, kind, capsys):
    db = tmp_path / "db"
    db.mkdir()
    _write_mat(str(db / "r.mat"), "sound" if kind == "audio" else "accelDFT",
               np.sin(np.arange(900) * 0.05))
    assert extract_dataset.main([kind, str(db), str(tmp_path / "port"), "8000"]) == 0
    jmx.extract_corpus(str(db), str(tmp_path / "jax"), kind, sr=8000, log=QUIET)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert wav_io.read_wav(str(tmp_path / "port" / "r.wav"))[1] == 8000
    assert extract_dataset.main([]) == 1
    assert "KIND ROOT OUT" in capsys.readouterr().out


def test_collect_evidence_contract(tmp_path, capsys):
    """``tests/test_collect_evidence.py``'s checks on the port's collector,
    and its SUMMARY.txt equal to the JAX script's."""
    root = _make_root(tmp_path)
    out = tmp_path / "out"
    collect_evidence.main(["--root", str(root), "--out", str(out)])
    summary = (out / "SUMMARY.txt").read_text()
    assert "1.05 kbps (0.98 coded)" in summary
    assert "VQ 6.71b/book (min 6.55)" in summary
    assert "PSNR 30.00 dB" in summary
    assert "n_q= 4:  3.00 kbps" in summary
    assert "b= 8:  1.40 kbps" in summary
    assert "mean_psnr_masked_db = 25.0000" in summary
    assert "mean_psnr_masked_zero_db = 12.0000" in summary
    assert "plc_gain_masked_db = 13.0000" in summary
    assert "plc_category [low]:" in summary
    assert "plc_gain_masked_db = 9.5000" in summary
    assert "plc_category [medium]:" in summary
    for f in ("eval_all_vs_backbone_rawPSNR_latency.json", "sweep_summary.csv",
              "plc_uniform_eval_summary.json", "plc_category_eval_cat_summary.json",
              "plc_category_eval_metrics_low.csv"):
        assert (out / f).exists(), f

    spec = importlib.util.spec_from_file_location(
        "jax_collect_evidence", os.path.join(ROOT, "scripts", "collect_evidence.py"))
    jce = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jce)
    argv = sys.argv
    try:
        sys.argv = ["collect_evidence.py", "--root", str(root), "--out", str(tmp_path / "jout")]
        jce.main()
    finally:
        sys.argv = argv
    assert summary == (tmp_path / "jout" / "SUMMARY.txt").read_text()
    _same_tree(out, tmp_path / "jout")
