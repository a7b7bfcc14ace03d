"""The port's backbone-pretraining pieces against the JAX package's, on the CPU.

Tiny width (``DacConfig().tiny()``: 64-dim latents, 4 books of 32 codes),
the trained tiny backbone of ``artifacts/evidence_tiny`` carried across by
``convert.dac_from_jax``, inputs from numpy seeds:

- ``Quantizer.quantize_train`` without dropout and with a fixed depth
  vector: z_q within 1e-5, codes equal, commitment and codebook losses
  within 1e-6, and the gradients of one scalar of all four toward z,
  ``in_proj`` and ``codebooks`` within 1e-4 of each one's largest; its
  values equal the serving ``quantize``'s bit for bit;
- ``quantizer_dead_code_reinit``: with the run's warm counts, books equal
  and counts within 1e-6; with zero counts, the same reseeded codes as the
  JAX package, each reseeded row within jitter of one of the batch's
  features for its book, every other row kept;
- ``Encoder.forward_train``: the serving encoder's values, a gradient on
  every encoder leaf, the serving-only layouts refused;
- ``warmup_cosine_lr`` over steps 0-120 across the warm-up edge (1e-7) and
  ``sample_nq_dropout``'s shares and range;
- ``stream_pretrain_batches``: audio elements bit-equal to the JAX
  package's, tactile ones within 2e-5 (one int16 step in wire batches);
- the script's flags and defaults equal the JAX script's;
- the loop's own behaviour, after the JAX package's tests: divergence
  restore, the VQ-stall moment reset that keeps the count, the schedule
  offset on resume with the usage counts read back, and the discriminator
  resume.
"""

import argparse
import dataclasses
import os
import runpy
from itertools import islice

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.data import synth as jsynth
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.train import pretrain_backbone as jpb
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    DacConfig, GanConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import synth
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import dac
from multimodal_vqvae_compression_audio_tactile_tpu_torch.parallel import mesh as pmesh
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts import (
    pretrain_backbone as script)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import checkpoint
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import pretrain_backbone as pb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = os.path.join(ROOT, "artifacts", "evidence_tiny", "backbone")
CFG = DacConfig().tiny()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Six test workers share the host: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rtol * max(np.max(np.abs(ref)), 1e-30)


@pytest.fixture(scope="module")
def backbone():
    """The trained tiny backbone in both packages, and its usage counts."""
    tree, _, _ = checkpoint.load_checkpoint(os.path.join(BACKBONE, "last.msgpack"),
                                            convert.dac_template(CFG))
    jp = jax.tree.map(jnp.asarray, tree)
    counts = checkpoint.load_vq_counts(os.path.join(BACKBONE, "vq_counts.msgpack"),
                                       (CFG.n_codebooks, CFG.codebook_size))
    return jp, convert.dac_from_jax(jax.tree.map(np.asarray, jp), CFG), counts


def latents(seed, B=2, T=10):
    return (0.5 * np.random.default_rng(seed).standard_normal((B, CFG.latent_dim, T))
            ).astype(np.float32)


# -------------------------------------------------------------- quantize_train

@pytest.mark.parametrize("nq", [None, (1, 3)])
def test_quantize_train_matches_jax(backbone, nq):
    jp, m, _ = backbone
    z = latents(1)
    nq_np = None if nq is None else np.asarray(nq, np.int32)
    wz = np.random.default_rng(2).standard_normal(z.shape).astype(np.float32)

    def jobj(z, in_proj, books):
        q = dict(jp["quantizer"], in_proj=in_proj, codebooks=books)
        zq, codes, commit, codebk = jdac.quantize(
            q, z, nq_per_example=None if nq is None else jnp.asarray(nq_np))
        return jnp.sum(zq * wz) + 0.3 * commit + 0.7 * codebk, (zq, codes, commit, codebk)
    (_, (jzq, jcodes, jcommit, jcodebk)), jg = jax.value_and_grad(
        jobj, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(z), jp["quantizer"]["in_proj"],
                                               jp["quantizer"]["codebooks"])

    q = m.quantizer
    q.zero_grad(set_to_none=True)
    tz = torch.from_numpy(z).requires_grad_(True)
    zq, codes, commit, codebk = q.quantize_train(
        tz, None if nq is None else torch.from_numpy(nq_np).long())
    (torch.sum(zq * torch.from_numpy(wz)) + 0.3 * commit + 0.7 * codebk).backward()
    _close(zq.detach().numpy(), jzq, 1e-5)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(float(commit.detach()), float(jcommit), rtol=1e-6)
    np.testing.assert_allclose(float(codebk.detach()), float(jcodebk), rtol=1e-6)
    for got, ref in zip((tz.grad, q.in_proj.grad, q.codebooks.grad), jg):
        _close(got.numpy(), ref, 1e-4)
        assert np.any(np.asarray(ref) != 0)


def test_quantize_train_values_are_the_serving_values(backbone):
    _, m, _ = backbone
    z = torch.from_numpy(latents(3))
    with torch.no_grad():
        zq, codes = m.quantizer.quantize(z)
        tzq, tcodes, _, _ = m.quantizer.quantize_train(z)
    assert torch.equal(zq, tzq) and torch.equal(codes, tcodes)


# ------------------------------------------------------------- dead-code reinit

def _features(q, z):
    """Each book's factorized features of the batch, the residual chain
    advancing with the codes the books pick, in float64 numpy."""
    P = {k: np.asarray(getattr(q, k).detach(), np.float64)
         for k in ("in_proj", "in_bias", "out_proj", "out_bias", "codebooks")}
    B, C, T = z.shape
    r = np.transpose(z, (0, 2, 1)).reshape(B * T, C).astype(np.float64)
    feats = []
    for i in range(P["codebooks"].shape[0]):
        e = r @ P["in_proj"][i] + P["in_bias"][i]
        cb = P["codebooks"][i]
        nrm = lambda a: a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-8)  # noqa: E731
        idx = np.argmax(nrm(e) @ nrm(cb).T, axis=1)
        feats.append(e)
        r = r - (cb[idx] @ P["out_proj"][i] + P["out_bias"][i])
    return feats


@pytest.mark.parametrize("warm", [True, False])
def test_dead_code_reinit_matches_jax(backbone, warm):
    jp, m, counts = backbone
    z = latents(4, B=2, T=15)
    c0 = counts if warm else np.zeros_like(counts)
    jbooks, jcounts = jdac.quantizer_dead_code_reinit(jp, jnp.asarray(c0), jnp.asarray(z),
                                                      jax.random.key(0))
    books, new_counts = dac.quantizer_dead_code_reinit(
        m.quantizer, torch.from_numpy(c0.copy()), torch.from_numpy(z),
        torch.Generator().manual_seed(0))
    books0 = m.quantizer.codebooks.detach().numpy()
    jre = np.any(np.asarray(jbooks) != books0, axis=-1)
    re = np.any(books.numpy() != books0, axis=-1)
    np.testing.assert_array_equal(re, jre)
    _close(new_counts.numpy(), jcounts, 1e-6)
    if warm:
        assert not re.any()
        np.testing.assert_array_equal(books.numpy(), books0)
        return
    assert 0 < re.sum() < re.size
    np.testing.assert_array_equal(books.numpy()[~re], books0[~re])
    for i, e in enumerate(_features(m.quantizer, z)):
        jitter = 1e-3 * np.std(e)
        for row in books.numpy()[i][re[i]]:
            assert np.min(np.max(np.abs(e - row), axis=1)) <= 6 * jitter


# ------------------------------------------------------------- forward_train

def test_encoder_forward_train(backbone):
    _, m, _ = backbone
    x = torch.from_numpy(np.random.default_rng(5).uniform(-0.5, 0.5, (2, 1, 3200))
                         .astype(np.float32))
    with torch.no_grad():
        ref = m.encoder(x)
    m.encoder.zero_grad(set_to_none=True)
    z = m.encoder.forward_train(x)
    assert torch.equal(z.detach(), ref)
    z.square().mean().backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in m.encoder.parameters())
    for flag in ("time_major_enc", "tail_kernel"):
        with pytest.raises(ValueError, match="serving option"):
            m.encoder.forward_train(x, dataclasses.replace(CFG, **{flag: True}))


# ------------------------------------------------------------- schedule, dropout

def test_warmup_cosine_lr_matches_jax():
    jf = jpb.warmup_cosine_lr(2e-4, 100, 50, 0.1)
    pf = pb.warmup_cosine_lr(2e-4, 100, 50, 0.1)
    steps = np.arange(0, 121)
    ref = np.asarray(jax.vmap(jf)(jnp.asarray(steps, jnp.int32)))
    got = np.array([float(pf(torch.tensor(s))) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=1e-7)
    assert got[49] == pytest.approx(2e-4) and got[120] == pytest.approx(2e-5)


def test_sample_nq_dropout_statistics():
    n, draws = 4, 40000
    nq = pb.sample_nq_dropout(torch.Generator().manual_seed(0), draws, n).numpy()
    assert nq.min() == 1 and nq.max() == n
    share = np.bincount(nq, minlength=n + 1)[1:] / draws
    want = np.full(n, 0.5 / n)
    want[-1] += 0.5
    np.testing.assert_allclose(share, want, atol=0.01)
    again = pb.sample_nq_dropout(torch.Generator().manual_seed(0), draws, n).numpy()
    assert np.array_equal(nq, again)


# ------------------------------------------------------------- data

@pytest.mark.parametrize("mix,wire_i16", [(1.0, False), (0.0, False), (1.0, True),
                                          (0.0, True)])
def test_stream_pretrain_batches_match_jax(mix, wire_i16):
    kw = dict(batch=2, seg=2400, sr=24000, seed=3, mix_audio=mix, prefetch=1,
              wire_i16=wire_i16)
    got = list(islice(synth.stream_pretrain_batches(**kw), 2))
    ref = list(islice(jsynth.stream_pretrain_batches(**kw), 2))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape == (2, 1, 2400)
        if mix == 1.0:
            np.testing.assert_array_equal(g, r)
        elif wire_i16:
            assert np.max(np.abs(g.astype(np.int32) - r.astype(np.int32))) <= 1
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=2e-5)


# ------------------------------------------------------------- script

class _Parsed(Exception):
    pass


def _parser_of_jax_script(monkeypatch) -> argparse.ArgumentParser:
    def capture(self, *a, **k):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    with pytest.raises(_Parsed) as e:
        runpy.run_path(os.path.join(ROOT, "scripts", "pretrain_backbone.py"),
                       run_name="__main__")
    return e.value.args[0]


def _flags(ap: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, type(a).__name__, a.required,
                     a.nargs) for a in ap._actions if a.dest != "help"}


def test_script_flags_match_jax(monkeypatch):
    with monkeypatch.context() as mp:
        ref = _flags(_parser_of_jax_script(mp))
    assert _flags(script.build_parser()) == ref
    args = script.build_parser().parse_args(["--out-dir", "o"])
    assert (args.batch, args.lr, args.clip, args.gan, args.stream) == (8, 2e-4, 3.0, False, 0)


# ------------------------------------------------------------- the loop

T_LOOP = 2 * CFG.hop


def _run(out, tcfg, batches, val, **kw):
    logs = []
    hist = pb.pretrain_backbone(CFG, tcfg, batches, val, out_dir=str(out), seed=0,
                                device="cpu", log=logs.append, **kw)
    return hist, logs


def test_divergence_restores_best(tmp_path):
    """After test_pretrain_recovery.py: epoch-4 batches blow the loss up;
    the best backbone comes back with zeroed moments and the same count."""
    tcfg = TrainConfig(epochs=6, batch=2, best_after_epoch=1)
    rng = np.random.default_rng(0)
    clean = (0.3 * rng.standard_normal((4, 2, 1, T_LOOP))).astype(np.float32)
    seen = {}

    def on_epoch(ep, st):
        seen[ep] = (int(st.opt.count), float(sum(mu.abs().sum() for mu in st.opt.mu)))

    hist, logs = _run(tmp_path, tcfg, lambda ep: iter(clean * (1e6 if ep == 4 else 1.0)),
                      lambda: iter(clean[:1]), on_epoch=on_epoch)
    assert any("divergence at epoch 4" in s for s in logs), logs
    assert hist["train"][3] > 5.0 * min(hist["val"][:3])
    assert hist["val"][-1] < 2.0 * min(hist["val"][:3])
    assert all(np.isfinite(v) for v in hist["val"])
    assert seen[4][1] == 0.0 and seen[4][0] > seen[3][0] and seen[3][1] > 0
    assert seen[5][0] == seen[4][0] + 4 and seen[5][1] > 0


def test_vq_stall_resets_moments_and_keeps_the_count(tmp_path):
    """Silence codes one code per book: 30 epochs under the stall line reset
    the generator's moments at epoch 30, and the count goes on."""
    tcfg = TrainConfig(epochs=31, batch=1)
    x = np.zeros((1, 1, 1, T_LOOP), np.float32)
    seen = {}

    def on_epoch(ep, st):
        seen[ep] = (int(st.opt.count), float(sum(mu.abs().sum() for mu in st.opt.mu)))

    _, logs = _run(tmp_path, tcfg, lambda ep: iter(x), lambda: iter(x), on_epoch=on_epoch,
                   nq_dropout=False)
    assert [s for s in logs if "VQ stall" in s] and any("epoch 030" in s for s in logs)
    assert seen[30] == (30, 0.0) and seen[29][1] > 0 and seen[31][0] == 31
    assert sum("VQ stall" in s for s in logs) == 1


def test_resume_offsets_the_schedule_and_reads_the_counts(tmp_path, monkeypatch):
    """After test_resume.py::test_pretrain_resume_schedule_offset."""
    rng = np.random.default_rng(0)
    batches = [(0.3 * rng.standard_normal((2, 1, T_LOOP))).astype(np.float32)
               for _ in range(2)]
    out = tmp_path / "bb"
    _, logs = _run(out, TrainConfig(epochs=2, batch=2), lambda ep: iter(batches),
                   lambda: iter(batches[:1]), steps_per_epoch=2)
    assert len(logs) == 2 and os.path.exists(out / "vq_counts.msgpack")
    counts = checkpoint.load_vq_counts(str(out / "vq_counts.msgpack"), (4, 32))
    seen = {}

    def on_epoch(ep, st):
        seen[ep] = (st.opt.offset, float(st.opt.lr()), st.vq_counts.clone())

    sched = pb.warmup_cosine_lr(2e-4, 8, 50, 0.1)
    state0 = {}
    orig = pb.PretrainState.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        state0["counts"] = None if self.vq_counts is None else self.vq_counts.clone()
    monkeypatch.setattr(pb.PretrainState, "__init__", spy)
    hist, logs2 = _run(out, TrainConfig(epochs=4, batch=2), lambda ep: iter(batches),
                       lambda: iter(batches[:1]), steps_per_epoch=2,
                       resume_from=str(out / "last.msgpack"), on_epoch=on_epoch)
    assert any("resuming" in s for s in logs2)
    assert any("resumed VQ usage tracker" in s for s in logs2)
    assert sum("epoch 003" in s or "epoch 004" in s for s in logs2) == 2
    assert not any("epoch 001" in s for s in logs2) and sorted(seen) == [3, 4]
    np.testing.assert_array_equal(state0["counts"].numpy(), counts)
    assert seen[3][0] == 4 and seen[3][1] == pytest.approx(float(sched(4 + 2)), rel=1e-6)
    assert len(hist["val"]) == 2 and np.isfinite(hist["val"][-1])


def test_resume_restores_discriminator(tmp_path):
    """After test_gan.py::test_resume_restores_discriminator: disc_last
    comes back on resume, and a warm-up epoch leaves it as it was."""
    rng = np.random.default_rng(0)
    batches = [(0.3 * rng.standard_normal((2, 1, T_LOOP))).astype(np.float32)
               for _ in range(2)]
    gcfg = GanConfig(periods=(2, 3), fft_sizes=(64, 128))
    out = tmp_path / "gan"
    _run(out, TrainConfig(epochs=2, batch=2), lambda ep: iter(batches),
         lambda: iter(batches[:1]), steps_per_epoch=2, gan=gcfg)
    assert os.path.exists(out / "disc_last.msgpack")
    assert not os.path.exists(out / "vq_counts.msgpack")
    saved = convert.load_disc(str(out / "disc_last.msgpack"), gcfg)
    seen = {}
    _, logs = _run(out, TrainConfig(epochs=3, batch=2), lambda ep: iter(batches),
                   lambda: iter(batches[:1]), steps_per_epoch=2,
                   gan=GanConfig(periods=(2, 3), fft_sizes=(64, 128), start_epoch=4),
                   resume_from=str(out / "last.msgpack"),
                   on_epoch=lambda ep, st: seen.setdefault(ep, [p.clone() for p in
                                                                st.d.parameters()]))
    assert any("resumed discriminator" in s for s in logs), logs
    assert all(torch.equal(a, b) for a, b in zip(seen[3], saved.parameters()))


def test_mesh_and_the_missing_card_are_refused(tmp_path, monkeypatch):
    kw = dict(train_batches=lambda ep: iter([]), val_batches=lambda: iter([]),
              out_dir=str(tmp_path), steps_per_epoch=1)
    # a mesh is taken (tests/test_torch_parallel_plc.py) but refused where
    # the batch does not divide into its shards
    stub = pmesh.Mesh({"data": 4, "model": 1}, {"data": 0, "model": 0}, 0,
                      torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="mesh"):
        pb.pretrain_backbone(CFG, TrainConfig(epochs=1, batch=6), mesh=stub, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pb.pretrain_backbone(CFG, TrainConfig(epochs=1), **kw)
