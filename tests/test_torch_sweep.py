"""The port's rate sweep (``train/sweep.py::run_sweep``) against the JAX
package's, and the new entry points' options against the JAX scripts'.

Tiny configuration, books (1, 2) x embed (16,), one epoch of two 0.2-s
batches, the predictor's dropout and ``dead_frac`` 0. Both packages start
every run from the same JAX-written head (a resumable epoch-0
``last.msgpack`` in each run directory, which ``run_sweep``'s resume picks
up), so the summaries compare number for number: the CSV's columns, order
and values (``best_val`` within 1e-4 relative) and ``meta.json``'s keys. A
second call trains nothing and leaves every file's bytes as they were; a
larger epoch budget resumes each run.
"""

import dataclasses
import importlib
import json
import os
import re
import runpy
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import (
    SweepConfig as JSweepConfig, TrainConfig as JTrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu.train import sweep as jsweep
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, SweepConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import sweep
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import artifacts

from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)
from test_torch_train import batch, codec_pair, jax_cfg, port_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(books_grid=(1, 2), embed_grid=(16,))
TRAIN = [batch(60), batch(61)]
VAL = [batch(62)]


def _seed_heads(root: str, jcfg) -> None:
    """The same JAX head (per grid point) as each run's epoch-0 checkpoint."""
    for books in GRID["books_grid"]:
        for embed in GRID["embed_grid"]:
            head = jar.head_init(jax.random.key(books), jcfg.with_rvq(books, embed))
            jckpt.save_checkpoint(os.path.join(root, artifacts.run_dir_name(books, embed),
                                               "last.msgpack"), head, 0, {})


def _port_sweep(jcfg, m, root, epochs=1, log=lambda s: None):
    return sweep.run_sweep(port_cfg(jcfg), TrainConfig(epochs=epochs, batch=2,
                                                       best_after_epoch=0),
                           SweepConfig(**GRID), {"audio": m.audio_dac, "tactile": m.tactile_dac},
                           lambda ep: iter(TRAIN), lambda: iter(VAL), root, log=log,
                           device="cpu")


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    jcfg = jax_cfg(dropout=0.0, dead_frac=0.0)
    jp, m = codec_pair(jcfg, seed=6)
    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(side))
        _seed_heads(root, jcfg)
        if side == "jax":
            rows = jsweep.run_sweep(jcfg, JTrainConfig(epochs=1, batch=2, best_after_epoch=0),
                                    JSweepConfig(**GRID),
                                    {"audio": jp.audio_dac, "tactile": jp.tactile_dac},
                                    lambda ep: iter(TRAIN), lambda: iter(VAL), root,
                                    log=lambda s: None)
        else:
            rows = _port_sweep(jcfg, m, root)
        out[side] = (root, rows)
    return jcfg, m, out


def _csv(root):
    with open(os.path.join(root, "sweep_summary.csv")) as f:
        return [line.rstrip("\n").split(",") for line in f]


def test_sweep_csv_matches_jax(sweeps):
    _, _, out = sweeps
    got, ref = _csv(out["port"][0]), _csv(out["jax"][0])
    assert got[0] == ref[0] == sweep.CSV_FIELDS
    assert [r[0] for r in got[1:]] == [r[0] for r in ref[1:]] == ["rvqB1_K16", "rvqB2_K16"]
    for g, r in zip(got[1:], ref[1:]):
        for name, a, b in zip(ref[0], g, r):
            if name == "best_val":
                np.testing.assert_allclose(float(a), float(b), rtol=1e-4, err_msg=name)
            elif name == "run":
                assert a == b
            else:
                assert float(a) == float(b), name
    est = [float(r[5]) for r in got[1:]]
    assert est == sorted(est) and est == [port_cfg(sweeps[0]).with_rvq(b, 16).kbps()
                                          for b in (1, 2)]


def test_sweep_meta_matches_jax(sweeps):
    _, _, out = sweeps
    for books in GRID["books_grid"]:
        name = artifacts.run_dir_name(books, 16)
        got = artifacts.read_meta(os.path.join(out["port"][0], name))
        ref = artifacts.read_meta(os.path.join(out["jax"][0], name))
        assert sorted(got) == sorted(ref) == sorted(sweep.CSV_FIELDS[1:])
        for k in ref:
            if k != "best_val":
                assert got[k] == ref[k], k


def test_second_sweep_trains_nothing(sweeps):
    jcfg, m, out = sweeps
    root, rows = out["port"]
    files = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
             for d, _, fs in os.walk(root) for f in fs}
    logs = []
    again = _port_sweep(jcfg, m, root, log=logs.append)
    assert sum("skip" in s for s in logs) == 2 and not any("Epoch" in s for s in logs)
    assert [r["run"] for r in again] == [r["run"] for r in rows]
    assert [r["best_val"] for r in again] == [r["best_val"] for r in rows]
    for path, blob in files.items():
        if not path.endswith("sweep_summary.csv"):
            assert open(path, "rb").read() == blob, path


def test_larger_budget_resumes_each_run(sweeps, tmp_path):
    jcfg, m, out = sweeps
    root = str(tmp_path / "copy")
    shutil.copytree(out["port"][0], root)
    logs = []
    rows = _port_sweep(jcfg, m, root, epochs=2, log=logs.append)
    assert sum("[resume]" in s and "epoch 1" in s for s in logs) == 2
    for r in rows:
        assert r["epochs"] == 2
        with open(os.path.join(root, r["run"], "hist.json")) as f:
            assert len(json.load(f)["train"]) == 2


def test_skip_needs_meta_and_a_checkpoint(monkeypatch, tmp_path):
    """As the JAX package's ``test_sweep_skips_completed_runs``: a finished
    run is skipped; another epoch budget retrains."""
    calls = []

    def fake_train(cfg, tcfg, backbones, train_batches, val_batches, out_dir, **kw):
        calls.append(out_dir)
        os.makedirs(out_dir, exist_ok=True)
        open(os.path.join(out_dir, "last.msgpack"), "wb").close()
        return {"train": [1.0], "val": [0.5]}

    monkeypatch.setattr(sweep, "train_codec", fake_train)
    cfg = CodecConfig().tiny()
    scfg = SweepConfig(books_grid=(1, 2), embed_grid=(128,))
    for epochs, n in ((2, 2), (2, 2), (3, 4)):
        sweep.run_sweep(cfg, TrainConfig(epochs=epochs, batch=2), scfg, {}, None, None,
                        str(tmp_path), log=lambda s: None, device="cpu")
        assert len(calls) == n


def test_run_sweep_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_sweep(CodecConfig().tiny(), TrainConfig(), SweepConfig(), {}, None, None,
                        str(tmp_path))


def _options(run, capsys) -> set:
    """The options a script's ``--help`` lists (argparse exits before the
    script imports anything heavy)."""
    with pytest.raises(SystemExit) as done:
        run()
    assert done.value.code == 0
    return set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", capsys.readouterr().out)) - {"--help"}


@pytest.mark.parametrize("script", ["build_latent_cache", "train_sweep", "train_plc",
                                    "train_plc_decft", "eval_plc"])
def test_scripts_take_the_jax_options(script, monkeypatch, capsys):
    monkeypatch.setenv("COLUMNS", "1000")
    mod = importlib.import_module(
        f"multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.{script}")
    port = _options(lambda: mod.main(["--help"]), capsys)
    path = os.path.join(ROOT, "scripts", f"{script}.py")
    monkeypatch.setattr(sys, "argv", [path, "--help"])
    monkeypatch.syspath_prepend(os.path.dirname(path))
    ref = _options(lambda: runpy.run_path(path, run_name="__main__"), capsys)
    assert port == ref


def test_train_sweep_script_runs(monkeypatch, tmp_path):
    """``scripts/train_sweep.py`` on a synthetic corpus (the tiny
    configuration in place of the full width, on the CPU)."""
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts import train_sweep
    tiny = dataclasses.replace(CodecConfig().tiny(), ar_chunk_tok=4)
    monkeypatch.setattr(train_sweep, "CodecConfig", lambda: tiny)
    rows = train_sweep.main(["--out-root", str(tmp_path), "--synth", "5", "--books", "1",
                             "--embeds", "16", "--epochs", "1", "--batch", "2", "--cpu"])
    assert [r["run"] for r in rows] == ["rvqB1_K16"]
    assert os.path.exists(tmp_path / "sweep_summary.csv")
    assert all(os.path.exists(tmp_path / r["run"] / "last.msgpack") for r in rows)
