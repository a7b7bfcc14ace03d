"""The port's tooling against the JAX package's, on the CPU.

- ``utils/flops.py``: every function equal to the JAX package's over the
  tiny and the default configurations;
- ``utils/roofline.py``: ``compiled_cost`` of a 256^3 matmul within JAX's
  band (``tests/test_roofline.py``), the encoder's counted FLOPs equal to
  ``encoder_flops`` (within 1%; they are equal: every convolution is
  counted at full length, as the closed form counts it), ``summarize``
  equal to JAX's, ``device_peaks`` for the CPU and the H100 parts, raising
  on an unknown card, and ``StreamingCodec.cost_analysis``'s contract
  (``tests/test_roofline.py``'s serving test);
- ``utils/profiling.py``: ``timed``, ``annotate`` and ``trace``;
- ``eval/bitstream.py``'s native coder: its bytes equal to the pure coder's
  and to the JAX package's pure coder on skewed and uniform codes, each
  coder decoding the other's streams, and a build that fails raising with
  the compiler's message.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core import config as jconfig
from multimodal_vqvae_compression_audio_tactile_tpu.eval import bitstream as jbits
from multimodal_vqvae_compression_audio_tactile_tpu.utils import flops as jflops
from multimodal_vqvae_compression_audio_tactile_tpu.utils import roofline as jroof
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import bitstream, vcpwq
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingCodec
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models.dac import DAC
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import flops, profiling, roofline

CONFIGS = {"tiny": (CodecConfig().tiny(), jconfig.CodecConfig().tiny()),
           "default": (CodecConfig(), jconfig.CodecConfig()),
           "rvqB8_K128": (CodecConfig().with_rvq(8, 128), jconfig.CodecConfig().with_rvq(8, 128))}


# ---------------------------------------------------------------- flops

@pytest.mark.parametrize("args", [(1, 7, 1, 64), (600, 16, 512, 1024), (24000, 1, 96, 96)])
def test_conv_and_resunit_flops_match_jax(args):
    assert flops.conv_flops(*args) == jflops.conv_flops(*args)
    t, _, _, c = args
    assert flops.resunit_flops(t, c) == jflops.resunit_flops(t, c)
    assert flops.resunit_stack_flops(t, c, 2) == jflops.resunit_stack_flops(t, c, 2)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_flops_match_jax(name):
    cfg, jcfg = CONFIGS[name]
    for t in (3200, 24000):
        assert flops.encoder_flops(cfg.dac, t) == jflops.encoder_flops(jcfg.dac, t)
        assert flops.decoder_flops(cfg.dac, t // 320) == jflops.decoder_flops(jcfg.dac, t // 320)
        for b in (1, 32):
            assert flops.codec_decode_flops(cfg, t, b) == jflops.codec_decode_flops(jcfg, t, b)
            assert flops.codec_encode_front_flops(cfg, t, b) == \
                jflops.codec_encode_front_flops(jcfg, t, b)
    for n in (None, 1, 4):
        assert flops.quantizer_flops(cfg.dac, 75, n) == jflops.quantizer_flops(jcfg.dac, 75, n)


# ---------------------------------------------------------------- roofline

def test_compiled_cost_matmul_in_jax_band():
    m = k = n = 256
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    cost = roofline.compiled_cost(lambda x, y: x @ y, a, b)
    assert 2 * m * n * k * 0.9 <= cost["flops"] < 2 * m * n * k * 10
    # the unfused bytes: both operands read and the product written once
    assert cost["bytes"] == 3 * 256 * 256 * 4


def test_compiled_cost_never_raises():
    def boom():
        raise RuntimeError("no")
    cost = roofline.compiled_cost(boom)
    assert math.isnan(cost["flops"]) and math.isnan(cost["bytes"])


@pytest.mark.parametrize("name", ["tiny", "default"])
def test_encoder_counted_flops_match_closed_form(name):
    cfg = CONFIGS[name][0].dac
    t = 3200
    with torch.device("meta"):            # shapes only: nothing is computed
        m = DAC(cfg)
        x = torch.zeros(1, 1, t)
    cost = roofline.compiled_cost(lambda v: m.encoder(v, cfg), x)
    want = flops.encoder_flops(cfg, t)["total"]
    assert abs(cost["flops"] / want - 1.0) < 1e-2
    assert cost["flops"] == want


SUMMARIES = [(1e12, 1e9, 100.0, 1), (1e10, 1e9, 10.0, 1), (1e6, 1e6, 10.0, 4),
             (float("nan"), float("nan"), 1.0, 1), (5e9, float("nan"), 2.0, 3),
             (5e9, 2e8, 0.0, 1)]


@pytest.mark.parametrize("args", SUMMARIES, ids=str)
def test_summarize_matches_jax(args):
    peaks = {"tflops": 100.0, "hbm_gbps": 1000.0, "kind": "test"}
    f, b, ms, calls = args
    got = roofline.summarize(f, b, ms, peaks=peaks, calls=calls)
    want = jroof.summarize(f, b, ms, peaks=peaks, calls=calls)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == v or (v != v and got[k] != got[k]), k


def test_device_peaks(monkeypatch):
    cpu = roofline.device_peaks("cpu")
    assert cpu["tflops"] == 0.1 and cpu["hbm_gbps"] == 50.0 and "nominal" in cpu["kind"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", (989.0, 3350.0)),
                       ("NVIDIA H100 PCIe", (756.0, 2000.0))):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None, n=name: n)
        p = roofline.device_peaks()
        assert (p["tflops"], p["hbm_gbps"], p["kind"]) == (*want, name)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no peaks known"):
        roofline.device_peaks()


def test_roofline_report_fields():
    a = torch.zeros(64, 64)
    rep = roofline.roofline_report(lambda x: x @ x, (a,), 1.0, calls=2,
                                   peaks=roofline.device_peaks("cpu"))
    assert rep["flops_per_call"] == 2 * 64 ** 3
    # two calls of 1 ms each
    assert rep["achieved_tflops"] == pytest.approx(2 * 64 ** 3 / 1e-3 / 1e12)


@pytest.mark.parametrize("batch", [1, 2])
def test_serving_cost_analysis_contract(batch):
    cfg = CodecConfig().tiny()
    m = allpred_ar.codec_init(cfg, torch.Generator().manual_seed(0))
    sc = StreamingCodec(m, batch=batch, frame_sec=0.25, device="cpu")
    cost = sc.cost_analysis()
    assert set(cost) == {"encode", "decode", "decode_from_codes"}
    for kk in cost:
        assert set(cost[kk]) == {"flops", "bytes"}
        for v in cost[kk].values():
            assert np.isfinite(v) and v > 0
    # the decoder's convolutions alone are the closed form's
    assert cost["decode"]["flops"] == batch * flops.decoder_flops(
        cfg.dac, sc.frame // cfg.dac.hop)["total"]
    # the counts are of the work: the kernels' counters see no launch here
    assert cost["decode_from_codes"]["flops"] > cost["decode"]["flops"]


# ---------------------------------------------------------------- profiling

def test_timed_records():
    results = {}
    lines = []
    with profiling.timed("op", results, log=lines.append, device="cpu"):
        torch.ones(100, 100) @ torch.ones(100, 100)
    assert "op" in results and results["op"][0] > 0 and lines[0].startswith("[timed] op:")


def test_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.annotate("region", device="cpu"):
            _ = torch.ones(4) + 1
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "region" in names
    assert any(e.key == "region" for e in prof.key_averages())


def test_profiling_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.timed("x", log=lambda s: None):
            pass


# ---------------------------------------------------------------- native coder

def _codes(seed, shape, K, skew):
    rng = np.random.default_rng(seed)
    p = np.exp(-skew * np.arange(K) / K)
    return rng.choice(K, size=shape, p=p / p.sum()).astype(np.int32)


@pytest.mark.parametrize("shape,K,skew", [((75, 8), 128, 4.0), ((75, 10), 128, 0.0),
                                          ((4, 75, 8), 1024, 6.0), ((300, 2), 16, 0.0),
                                          ((1, 1), 2, 0.0)])
def test_native_bytes_equal_pure_and_jax(shape, K, skew):
    codes = _codes(sum(shape) + K, shape, K, skew)
    native = bitstream.pack_codes(codes, K)
    pure = bitstream.pack_codes(codes, K, force_python=True)
    assert native == pure == jbits.pack_codes(codes, K, force_python=True)
    flat = codes.reshape(-1, codes.shape[-1])
    for stream in (native, pure):
        np.testing.assert_array_equal(bitstream.unpack_codes(stream), flat)
        np.testing.assert_array_equal(bitstream.unpack_codes(stream, force_python=True), flat)
    assert bitstream.peek(native) == (flat.shape[0], flat.shape[1], K)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(bitstream, "_lib", None)
    monkeypatch.setattr(vcpwq, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(vcpwq, "CXX_FLAGS", ["-O3", "-std=c++17", "--no-such-flag"])
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*no-such-flag"):
        bitstream.pack_codes(np.zeros((4, 2), np.int32), 16)
    # the pure coder is chosen explicitly only
    assert bitstream.pack_codes(np.zeros((4, 2), np.int32), 16, force_python=True)
    assert os.listdir(tmp_path) == []


def test_native_library_is_built_outside_native(monkeypatch):
    so = vcpwq.build_library()
    assert so == os.path.join(vcpwq.BUILD_DIR, "libvcpwq.so") and os.path.exists(so)
    assert os.path.dirname(so) != vcpwq.NATIVE_DIR


def test_dataclass_configs_are_duck_typed():
    """The closed forms read only fields both packages' configs have."""
    cfg = dataclasses.replace(CodecConfig().tiny(), ar_chunk_tok=8)
    assert flops.codec_decode_flops(cfg, 3200) > 0
