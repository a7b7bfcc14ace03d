"""The PyTorch port stands alone: no jax, flax, msgpack or JAX package.

The machine with the card has none of them, so an import of any (even of a
JAX-free module of the JAX package, whose ``__init__`` pulls jax in) would
pass every CPU test here and die there on its first import. It has no
matplotlib and no h5py either: the port imports them only inside the
functions that draw or read HDF5, and runs with both blocked.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "multimodal_vqvae_compression_audio_tactile_tpu_torch"
FORBIDDEN = {"jax", "flax", "msgpack", "multimodal_vqvae_compression_audio_tactile_tpu"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, PORT)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_heads(src, name="<src>"):
    """Top-level package of every absolute import in the source."""
    for node in ast.walk(ast.parse(src, name)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_heads_match_whole_names():
    """The JAX package's name is a prefix of the port's: matching must be on
    the whole first dotted component, in both directions."""
    src = (f"import {PORT}.ops\nfrom {PORT} import convert\n"
           "import multimodal_vqvae_compression_audio_tactile_tpu.core as c\n")
    assert [h in FORBIDDEN for h in _imported_heads(src)] == [False, False, True]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    with open(path) as f:
        bad = sorted(set(_imported_heads(f.read(), path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


# absent on the card's machine: imported only inside the functions that use them
LAZY = {"matplotlib", "h5py"}


def _module_level_heads(src, name="<src>"):
    """Top-level package of every import that runs when the module is
    imported: the module's body, outside any function."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            yield node
            yield from walk(ast.iter_child_nodes(node))
    for node in walk(ast.parse(src, name).body):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_level_plotting_or_hdf5_import(path):
    with open(path) as f:
        bad = sorted(set(_module_level_heads(f.read(), path)) & LAZY)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad} at module level"


def test_module_level_heads_skip_function_bodies():
    src = ("import os\nclass A:\n    import h5py\n"
           "def f():\n    import matplotlib\n    from matplotlib import pyplot\n")
    assert sorted(_module_level_heads(src)) == ["h5py", "os"]


_BLOCKED_RUN = f"""
import importlib.abc, os, sys
BLOCK = {sorted(FORBIDDEN | LAZY)!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCK:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import numpy as np, torch
torch.set_num_threads(1)        # beside other test workers, a thread per core is slower
import {PORT}.convert, {PORT}._build
from {PORT}.core.config import CodecConfig
from {PORT}.models import allpred_ar
from {PORT}.eval.serving import StreamingCodec
m = allpred_ar.codec_init(CodecConfig().tiny(), torch.Generator().manual_seed(0))
sc = StreamingCodec(m, batch=1, frame_sec=0.2, fast=False, compute_dtype=torch.float32,
                    device="cpu")
rng = np.random.default_rng(0)
a, t = (0.1 * rng.standard_normal((2, 1, 1, 4800))).astype(np.float32)
streams = sc.encode_to_bytes(a, t)
y = sc.decode_from_bytes(a, streams)
assert y.shape == (1, 1, 4800) and bool(torch.isfinite(y).all())
import {PORT}.plc.eval_uniform, {PORT}.plc.eval_categories
from {PORT}.eval.serving import StreamingConcealer
from {PORT}.plc import masks, model as plc_model
plc = plc_model.plc_init(CodecConfig().tiny(), torch.Generator().manual_seed(0), 2)
scn = StreamingConcealer(plc, batch=1, frame_sec=0.2, mask_embed=True, device="cpu")
mk = masks.make_token_loss_mask(rng, 1, 15, 2, 0.5)
yc = scn.conceal(a, np.zeros((1, 64, 15), np.float32), mk)
assert yc.shape == (1, 1, 4800) and bool(torch.isfinite(yc).all())
import {PORT}.eval.proposed, {PORT}.eval.dac_baseline, {PORT}.eval.vcpwq
import {PORT}.scripts.eval_codecs, {PORT}.scripts.demo_eval_only
import {PORT}.scripts.measure_latencies
scp = StreamingCodec(m, batch=1, frame_sec=0.2, fast=False, compute_dtype=torch.float32,
                     device="cpu", parallel_roll=True)
assert scp.encode_to_bytes(a, t) == streams
import tempfile
import {PORT}.scripts.train_codec, {PORT}.data.synth, {PORT}.utils.msgpack_write
from {PORT}.core.config import TrainConfig
from {PORT}.train import loop
with tempfile.TemporaryDirectory() as d:
    hist = loop.train_codec(CodecConfig().tiny(), TrainConfig(epochs=1, batch=1),
                            {{"audio": m.audio_dac, "tactile": m.tactile_dac}},
                            train_batches=lambda ep: iter([(a, t)]),
                            val_batches=lambda: iter([(a, t)]), out_dir=d, device="cpu",
                            log=lambda s: None)
    assert len(hist["train"]) == 1 and os.path.exists(os.path.join(d, "last.msgpack"))
import {PORT}.scripts.build_latent_cache, {PORT}.scripts.train_sweep
import {PORT}.scripts.train_plc, {PORT}.scripts.train_plc_decft, {PORT}.scripts.eval_plc
from {PORT}.core.config import PLCConfig, SweepConfig
from {PORT}.train import latent_cache, sweep
from {PORT}.plc import train as plc_train
bb = {{"audio": m.audio_dac, "tactile": m.tactile_dac}}
with tempfile.TemporaryDirectory() as d:
    cache = latent_cache.build_latent_cache(bb, CodecConfig().tiny(), [(a, t)], device="cpu")
    latent_cache.save_cache(os.path.join(d, "c.npz"), cache)
    cache = latent_cache.load_cache(os.path.join(d, "c.npz"), device="cpu")
    rows = sweep.run_sweep(CodecConfig().tiny(), TrainConfig(epochs=1, batch=1),
                           SweepConfig((1,), (16,)), bb, None, None, d, cache=cache,
                           seg_tok=10, device="cpu", log=lambda s: None)
    assert rows[0]["run"] == "rvqB1_K16"
    tcfg = TrainConfig(epochs=1, batch=1, seg_sec=0.2, best_after_epoch=0)
    plc_train.train_plc(CodecConfig().tiny(), tcfg, PLCConfig(), bb, lambda ep: iter([(a, t)]),
                        lambda: iter([(a, t)]), d, device="cpu", log=lambda s: None)
    plc_train.finetune_inpaint_decoder(CodecConfig().tiny(), tcfg, PLCConfig(), bb,
                                       plc.head, lambda ep: iter([(a, t)]),
                                       lambda: iter([(a, t)]), d, device="cpu",
                                       log=lambda s: None)
    assert os.path.exists(os.path.join(d, "dec_plc.msgpack"))
import {PORT}.scripts.pretrain_backbone, {PORT}.core.rng, {PORT}.losses.gan
from {PORT}.core.config import DacConfig, GanConfig
from {PORT}.data.synth import stream_pretrain_batches
from {PORT}.train import pretrain_backbone as pb
xb = [next(stream_pretrain_batches(1, seg=640, seed=0, wire_i16=True))]
for gan in (None, GanConfig(periods=(2,), fft_sizes=(64,))):
    with tempfile.TemporaryDirectory() as d:
        hist = pb.pretrain_backbone(DacConfig().tiny(), TrainConfig(epochs=1, batch=1),
                                    lambda ep: iter(xb), lambda: iter(xb), d, gan=gan,
                                    device="cpu", log=lambda s: None)
        assert np.isfinite(hist["train"][0]) and os.path.exists(os.path.join(
            d, "vq_counts.msgpack" if gan is None else "disc_last.msgpack"))
import {PORT}.scripts.demo_end_to_end, {PORT}.scripts.evidence_tiny
import {PORT}.scripts.collect_evidence, {PORT}.scripts.extract_dataset
import {PORT}.eval.plots, {PORT}.plc.plots, {PORT}.data.mat_extract
from {PORT}.parallel import dryrun, mesh as pmesh
from {PORT}.models import dac_import
from {PORT}.utils import flops, profiling, roofline
from {PORT}.eval import bitstream
assert pmesh.distributed_init() == 1
cost = sc.cost_analysis()
assert cost["encode"]["flops"] > 0 and cost["decode"]["bytes"] > 0
assert flops.encoder_flops(CodecConfig().tiny().dac, 4800)["total"] > 0
with profiling.timed("x", log=lambda s: None, device="cpu"):
    pass
assert bitstream.unpack_codes(streams[0]).shape == (15, CodecConfig().tiny().rvq.n_books)
assert bitstream.pack_codes(bitstream.unpack_codes(streams[0]), CodecConfig().tiny().rvq.n_embed,
                            force_python=True) == streams[0]
from {PORT}.utils import artifacts
assert not artifacts.have_matplotlib()
assert not any(n.split(".")[0] in BLOCK for n in sys.modules)
print("ISOLATED_OK", len(streams[0]))
"""


def test_port_runs_with_jax_flax_msgpack_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED_OK" in proc.stdout


def test_default_device_is_the_card(monkeypatch):
    """Without a card, the default device raises instead of running on the CPU."""
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingCodec
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = allpred_ar.codec_init(CodecConfig().tiny(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingCodec(m, batch=1, frame_sec=0.2)
