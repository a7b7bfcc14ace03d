"""The codec evaluation path on the card: K1 at the evaluators' batch sizes,
the parallel roll's codes, and the evaluators' rows card against CPU.

- K1 at batch 3 (the evidence corpus's held-out batch) and 16 (the
  evaluators' ``forward_batch``) at every stack shape of a 1 s forward, the
  tiny config's and the full width's: fp32 bit-equal to its plain version
  (TF32 off), bf16 within 2e-2, with the stack's launch count.
- ``StreamingCodec(parallel_roll=True)`` against the scan, fp32, full width
  and tiny, batch 1 and 4: the share of equal codes (at least 0.999) and
  z_run within 1e-5 of its scale.
- ``eval_backbone_codec`` and ``eval_proposed_runs`` on the trained tiny
  codec of ``artifacts/evidence_tiny``, on the card against the CPU: the
  same counts and rates, PSNR within 1e-3 dB, ST-SIM within 1e-4, with the
  forwards' K1 launches (8 stacks a backbone forward, 12 a proposed one).
- F5: ``StreamingCodec.device_time_ms`` of a full-width bf16 batch-1 encode
  (the scan and the parallel roll) within 0.9-2.0x the kernel time that
  torch.profiler records for one encode: the chain of CUDA-graph replays
  reads the device's time, where an eager chain of Python calls read the
  host's (4-7x the kernel sum at batch 1).

Marked ``cuda``: each test skips without a card. The file imports neither jax
nor the JAX package; on a machine with the card run it without the
repository's conftest (which sets up jax):

    python -m pytest --noconftest tests/test_torch_eval_cuda.py -q
"""

import math
import os

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, EvalConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import pair_stems, split_items
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import metrics as M
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.dac_baseline import (
    eval_backbone_codec)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.proposed import eval_proposed_runs
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingCodec
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit

from test_torch_plc_cuda import EVIDENCE, TINY_STACKS, _rel, _units, cuda  # noqa: F401

# (C, T, trailing snake) of every stack of the full-width default path at 1 s
FULL_STACKS = [(64, 24000, True), (128, 12000, True), (256, 3000, True), (512, 600, True),
               (768, 600, False), (384, 3000, False), (192, 12000, False), (96, 24000, True)]
LAT = {"enc_ms": 0.0, "dec_ms": 0.0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch", [3, 16])
@pytest.mark.parametrize("c,t,post", TINY_STACKS + FULL_STACKS)
def test_k1_at_evaluator_batches(cuda, dtype, batch, c, t, post):
    units = _units(c, c + t + batch, cuda)
    x = torch.randn(batch, c, t, generator=torch.Generator().manual_seed(batch)).to(cuda, dtype)
    pa = torch.full((c,), 0.9, device=cuda) if post else None
    with torch.no_grad():
        before = resunit.launches
        got = resunit.resunit_stack(units, x, resunit.DILATIONS, pa)
        launched = resunit.launches - before
        with fp32_exact():
            ref = resunit.resunit_stack_ref(units, x, resunit.DILATIONS, pa)
    torch.cuda.synchronize()
    assert launched == resunit.stack_launches(3, dtype)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert torch.equal(got, ref)
    else:
        assert _rel(got, ref) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("width", ["tiny", "full"])
def test_parallel_roll_codes_on_card(cuda, width, batch):
    cfg = CodecConfig().tiny() if width == "tiny" else CodecConfig().with_rvq(8, 128)
    m = allpred_ar.codec_init(cfg, torch.Generator().manual_seed(0)).to(cuda)
    rng = np.random.default_rng(batch)
    a, tc = (0.1 * rng.standard_normal((2, batch, 1, 24000))).astype(np.float32)
    kw = dict(batch=batch, fast=False, compute_dtype=torch.float32)
    z, codes = StreamingCodec(m, **kw).encode(a, tc)
    zp, codesp = StreamingCodec(m, parallel_roll=True, **kw).encode(a, tc)
    assert float((codesp == codes).float().mean()) >= 0.999
    assert _rel(zp, z) <= 1e-5


@pytest.fixture(scope="module")
def evidence_rows():
    """{"cpu" | "cuda": ((backbone rows, K1 launches), (proposed rows, K1
    launches))} on the trained tiny codec and the 3 held-out pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    _, val = split_items(pair_stems(os.path.join(EVIDENCE, "corpus", "audio"),
                                    os.path.join(EVIDENCE, "corpus", "tactile")), 0.2, 300, 7)
    peak = M.compute_global_peak([t for _, t, _ in val])
    cfg, ecfg = CodecConfig().tiny(), EvalConfig()
    out = {}
    for dev in ("cpu", "cuda"):
        bb = convert.load_dac(os.path.join(EVIDENCE, "backbone", "best.msgpack"), cfg.dac)
        resunit.launches = 0
        dac24 = eval_backbone_codec(bb, cfg.dac, val, peak, ecfg, n_q_list=(1, 2, 4, 8),
                                    latency_map={str(q): LAT for q in (1, 2, 4, 8)},
                                    log=lambda *_: None, device=dev)
        n_dac = resunit.launches
        resunit.launches = 0
        rows = eval_proposed_runs(os.path.join(EVIDENCE, "sweep"), cfg,
                                  {"audio": bb, "tactile": bb}, val, peak, ecfg,
                                  latency_map={"rvqB2_K32": LAT, "rvqB4_K32": LAT},
                                  log=lambda *_: None, device=dev)
        out[dev] = ((dac24, n_dac), (rows, resunit.launches))
    return out


def _same_row(got, ref):
    assert list(got) == list(ref)
    for k, v in ref.items():
        if k in ("psnr_mean", "psnr_ci95"):
            assert abs(got[k] - v) <= 1e-3, k
        elif k in ("stsim_mean", "stsim_ci95"):
            assert abs(got[k] - v) <= 1e-4, k
        elif isinstance(v, float) and math.isnan(v):       # p95 of a latency map without it
            assert math.isnan(got[k]), k
        else:
            assert got[k] == v, k


@pytest.mark.cuda
def test_evaluators_on_card_match_cpu(evidence_rows):
    (dac_g, n_dac), (prop_g, n_prop) = evidence_rows["cuda"]
    (dac_c, n_dac_cpu), (prop_c, n_prop_cpu) = evidence_rows["cpu"]
    per_stack = resunit.stack_launches(3, torch.float32)
    # one batch of 3 a forward, and one encode of zeros probing the token rate
    assert n_dac == (4 * 8 + 4) * per_stack and n_prop == 2 * 12 * per_stack
    assert n_dac_cpu == n_prop_cpu == 0
    for q in dac_c:
        _same_row(dac_g[q], dac_c[q])
    for g, c in zip(prop_g, prop_c):
        _same_row(g, c)


def _kernel_ms(fn) -> float:
    """The summed CUDA kernel time of one call of ``fn`` (torch.profiler;
    copies and memsets left out), after a warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and not e.name.lower().startswith(("memcpy",
                                                                               "memset"))]
    assert us, "torch.profiler recorded no kernel"
    return sum(us) / 1e3


@pytest.mark.cuda
@pytest.mark.parametrize("parallel_roll", [False, True], ids=["scan", "parallel_roll"])
def test_chained_encode_time_is_the_device_time(cuda, parallel_roll):
    m = allpred_ar.codec_init(CodecConfig().with_rvq(8, 128), torch.Generator().manual_seed(0))
    sc = StreamingCodec(m, batch=1, device=cuda, parallel_roll=parallel_roll)
    rng = np.random.default_rng(3)
    a, tc = (sc._put((0.1 * rng.standard_normal((1, 1, sc.frame))).astype(np.float32))
             for _ in range(2))
    kernels = _kernel_ms(lambda: sc._encode(sc.modules, a, tc, n_books_use=sc.n_books_use,
                                            cfg=sc.cfg))
    chained = sc.device_time_ms(n_lo=4, n_hi=16, reps=2)["encode"]["ms_per_call"]
    assert 0.9 * kernels <= chained <= 2.0 * kernels, (chained, kernels)


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_raises(cuda):
    """A host synchronisation inside the chained step is named, not timed
    eagerly instead."""
    from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import latency
    x = torch.ones(64, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA graph.*local_scalar_dense"):
        latency.measure_device_ms(lambda c: c * float(c.sum().item() > 0), x, 2, 4, 1,
                                  device=cuda)
    # a step long enough (a 1024^3 product, ~40 us) for the slope to stand
    # clear of the replays' jitter
    w = torch.randn(1024, 1024, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    r = latency.measure_device_ms(lambda c, k: torch.tanh(c @ k), torch.ones(1024, 1024,
                                                                           device=cuda),
                                  4, 20, 2, const_args=(w / 32,), device=cuda)
    assert r["ms_per_call"] > 0 and (r["n_lo"], r["n_hi"]) == (4, 20)
