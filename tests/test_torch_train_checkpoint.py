"""Checkpoints between the port's trainer and the JAX package, both ways,
and the port's ``scripts/train_codec.py``.

- The port writes a head checkpoint byte for byte as the JAX package's
  ``save_checkpoint`` does, and its msgpack writer's bytes equal
  ``flax.serialization.to_bytes`` of the same payload.
- The port's ``last.msgpack`` loads through the JAX package's
  ``load_checkpoint`` with the JAX head template: equal leaves, epoch, hist.
- A JAX-written checkpoint resumes in the port's ``train_codec``: the
  resumed epoch's validation loss equals the JAX ``eval_step`` of that head,
  a checkpoint from before ``vq_counts`` gets the +100 warm start.
- ``--tiny --cpu --synth 6 --epochs 2`` writes last/best/hist, and
  ``--resume`` continues at epoch 3.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import TrainConfig as JTrainConfig
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.train import checkpoint as jckpt
from multimodal_vqvae_compression_audio_tactile_tpu.train import loop as jloop
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import TrainConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import checkpoint, loop
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import msgpack_write

from test_torch_train import batch, codec_pair, jax_cfg, port_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIST = {"train": [0.5, 0.25], "val": [0.6, 0.3], "ema": [0.0, 1.0]}


@pytest.fixture(scope="module")
def codecs():
    jcfg = jax_cfg()
    jp, m = codec_pair(jcfg, seed=4)
    return jcfg, jp, m


def test_head_checkpoint_bytes_equal_jax(codecs, tmp_path):
    _, jp, m = codecs
    jckpt.save_checkpoint(str(tmp_path / "j.msgpack"), jp.head, 2, HIST)
    checkpoint.save_checkpoint(str(tmp_path / "p.msgpack"), convert.head_tree(m.head), 2, HIST)
    assert (tmp_path / "p.msgpack").read_bytes() == (tmp_path / "j.msgpack").read_bytes()
    assert not list(tmp_path.glob("*.tmp"))


def test_backbone_checkpoint_loads_back(codecs, tmp_path):
    """A backbone written by the port reads back strictly in both packages."""
    jcfg, jp, m = codecs
    path = str(tmp_path / "bb.msgpack")
    checkpoint.save_checkpoint(path, convert.dac_tree(m.audio_dac), 0)
    bb = convert.load_dac(path, port_cfg(jcfg).dac)
    for (p, a, _), (_, b, _) in zip(convert.dac_leaves(bb), convert.dac_leaves(m.audio_dac)):
        assert torch.equal(a, b), p
    tree, _, _ = jckpt.load_checkpoint(path, jp.audio_dac)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jp.audio_dac)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_writer_bytes_equal_flax_to_bytes(codecs):
    _, _, m = codecs
    tree = checkpoint.to_host(convert.head_tree(m.head))
    payload = {"model": tree, "epoch": np.int64(7), "hist_json": json.dumps(HIST)}
    assert msgpack_write.packb(payload) == serialization.to_bytes(copy.deepcopy(payload))
    lists = {"a": [np.ones(3, np.float32), {"b": np.int32(4)}], "n": None, "t": True,
             "big": 70000, "neg": -40000, "f": 0.5, "s": "x" * 300, "bin": b"\x00" * 300}
    assert msgpack_write.packb(lists) == serialization.to_bytes(copy.deepcopy(lists))
    with pytest.raises(msgpack_write.MsgpackWriteError):
        msgpack_write.packb({"x": object()})


def test_port_last_checkpoint_loads_in_jax(codecs, tmp_path):
    jcfg, jp, m = codecs
    acp = checkpoint.AsyncCheckpointer()
    acp.save(str(tmp_path / "last.msgpack"), convert.head_tree(m.head), 5, HIST)
    acp.close()
    tree, epoch, hist = jckpt.load_checkpoint(str(tmp_path / "last.msgpack"),
                                              jar.head_init(jax.random.key(1), jcfg))
    assert epoch == 5 and hist == HIST
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jp.head)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_checkpointer_snapshots_and_raises(tmp_path, codecs):
    _, _, m = codecs
    acp = checkpoint.AsyncCheckpointer()
    t = {"w": torch.ones(3)}
    acp.save(str(tmp_path / "a.msgpack"), t, 1)
    t["w"].add_(1.0)                                    # after the snapshot
    acp.wait()
    tree, _, _ = checkpoint.load_checkpoint(str(tmp_path / "a.msgpack"))
    assert np.array_equal(tree["w"], np.ones(3, np.float32))
    acp.save(str(tmp_path / "b.msgpack"), {"x": object()}, 1)
    with pytest.raises(msgpack_write.MsgpackWriteError):
        acp.wait()
    acp.close()


def _jax_val(jcfg, head, jp, b):
    _, jeval = jloop.make_step_fns(jcfg, JTrainConfig(), None)
    return float(jeval(head, {"audio": jp.audio_dac, "tactile": jp.tactile_dac},
                       jnp.asarray(b[0]), jnp.asarray(b[1]))[0])


@pytest.mark.parametrize("pre_schema", [False, True])
def test_jax_checkpoint_resumes_in_port(codecs, tmp_path, pre_schema):
    """An epoch-3 JAX checkpoint (with trained-looking counts, or without
    ``vq_counts`` at all), resumed for one epoch with no training batch: the
    epoch's validation loss is the JAX eval of that head, hist grows to 4,
    ``last.msgpack`` is epoch 4 with the head unchanged (the pre-schema
    file's counts, zeros, warm-started to 100)."""
    jcfg, jp, m = codecs
    head = dict(jp.head, vq_counts=jnp.full_like(jp.head["vq_counts"], 2.0))
    if pre_schema:
        head.pop("vq_counts")
    hist = {k: [0.5, 0.4, 0.3] for k in ("train", "val", "l1", "stft", "mel", "ema")}
    jckpt.save_checkpoint(str(tmp_path / "last.msgpack"), head, 3, hist)
    vb = batch(40)
    logs = []
    got = loop.train_codec(port_cfg(jcfg), TrainConfig(epochs=4, batch=2),
                           {"audio": m.audio_dac, "tactile": m.tactile_dac},
                           train_batches=lambda ep: iter(()), val_batches=lambda: iter([vb]),
                           out_dir=str(tmp_path), seed=4, resume=True, log=logs.append,
                           device="cpu")
    assert any("[resume]" in s and "epoch 3" in s for s in logs)
    assert len(got["train"]) == 4 and got["train"][:3] == [0.5, 0.4, 0.3]
    assert all(np.isnan(got["vq_bits"][:3]))           # padded: the old hist lacks it
    np.testing.assert_allclose(got["val"][3], _jax_val(jcfg, dict(jp.head), jp, vb),
                               rtol=1e-4)
    tree, epoch, _ = checkpoint.load_checkpoint(str(tmp_path / "last.msgpack"),
                                                convert.head_template(port_cfg(jcfg)))
    assert epoch == 4
    np.testing.assert_array_equal(tree["vq_books"], np.asarray(jp.head["vq_books"]))
    np.testing.assert_array_equal(tree["vq_counts"], np.full((2, 16), 100.0 if pre_schema
                                                             else 2.0, np.float32))
    assert any("warm-started" in s for s in logs) == pre_schema


def test_cache_path_is_not_ported(codecs, tmp_path):
    """The cached-latent path, once refused here, is ported: ``cache=``
    needs ``seg_tok`` and then trains on the cache (its parity with the JAX
    package: ``tests/test_torch_latent_cache.py``)."""
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import latent_cache as lc
    jcfg, _, m = codecs
    cfg, bb = port_cfg(jcfg), {"audio": m.audio_dac, "tactile": m.tactile_dac}
    cache = lc.build_latent_cache(bb, cfg, iter([batch(50)]), device="cpu")
    with pytest.raises(ValueError, match="seg_tok"):
        loop.train_codec(cfg, TrainConfig(), bb, None, None, str(tmp_path), cache=cache,
                         device="cpu")
    hist = loop.train_codec(cfg, TrainConfig(epochs=1, batch=2), bb, None, None,
                            str(tmp_path), cache=cache, seg_tok=10, device="cpu",
                            log=lambda s: None)
    assert len(hist["train"]) == 1 and np.isfinite(hist["train"][0])
    assert os.path.exists(tmp_path / "last.msgpack")


def _script(*args):
    # one torch thread: beside the other test workers, a process that spins
    # a thread per core is slowed tenfold (as tests/test_torch_plc.py notes)
    return subprocess.run([sys.executable, "-m",
                           "multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts"
                           ".train_codec", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_train_codec_script_trains_and_resumes(tmp_path):
    """JAX's flags: seven epochs pass ``best_after_epoch`` (6), so only epoch
    7 may be kept as best; ``--resume`` then continues at epoch 8."""
    out = str(tmp_path / "run")
    base = ["--tiny", "--cpu", "--synth", "6", "--batch", "2", "--books", "2", "--embed", "16",
            "--out-dir", out]
    proc = _script(*base, "--epochs", "7")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "random-init backbones" in proc.stdout and "Epoch 007" in proc.stdout
    assert proc.stdout.count("new best") == 1
    assert proc.stdout.index("new best") > proc.stdout.index("Epoch 007")
    for f in ("last.msgpack", "best.msgpack", "hist.json"):
        assert os.path.exists(os.path.join(out, f)), f
    _, best_epoch, _ = checkpoint.load_checkpoint(os.path.join(out, "best.msgpack"))
    assert best_epoch == 7
    with open(os.path.join(out, "hist.json")) as f:
        assert len(json.load(f)["train"]) == 7
    proc = _script(*base, "--epochs", "8", "--resume")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[resume]" in proc.stdout and "Epoch 008" in proc.stdout
    assert "Epoch 007" not in proc.stdout
    _, epoch, hist = checkpoint.load_checkpoint(os.path.join(out, "last.msgpack"))
    assert epoch == 8 and len(hist["train"]) == 8
