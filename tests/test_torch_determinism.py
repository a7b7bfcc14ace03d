"""The pieces of F6's repair on the CPU, and the port's last two helpers.

- ``ops/rvq.py::_segment_sum`` (a one-hot product) against ``index_add_``:
  counts exact, sums within 1e-6 relative, codes that no token hits
  included; ``take_rows``' gradient against plain indexing's.
- The reflect pads built of slices and flips equal ``F.pad``'s reflect mode,
  values and gradients.
- ``deterministic_steps`` sets cuDNN's flags inside and restores them, also
  on an exception.
- ``dump_config`` writes JSON equal to the JAX package's for the default,
  tiny and round-5 configurations; ``nominal_bits`` equals JAX's at
  ``tests/test_bitstream.py``'s cases.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_vqvae_compression_audio_tactile_tpu.core import config as jconfig
from multimodal_vqvae_compression_audio_tactile_tpu.eval import bitstream as jbitstream
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core import config
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import deterministic_steps
from multimodal_vqvae_compression_audio_tactile_tpu_torch.dsp.stft import (
    _reflect_pad, reflect_pad_right)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import bitstream
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import rvq


@pytest.mark.parametrize("shape", [(450,), (450, 96), (600, 8)])
@pytest.mark.parametrize("K", [16, 128, 1024])
def test_segment_sum_matches_index_add(shape, K):
    rng = np.random.default_rng(K + len(shape))
    N = shape[0]
    idx = torch.from_numpy(rng.integers(0, min(K, 40), N))      # most codes hit by none
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = rvq._segment_sum(w, idx, K)
    ref = w.new_zeros((K,) + shape[1:]).index_add_(0, idx, w)
    assert got.shape == ref.shape
    assert torch.equal(got[40:], torch.zeros_like(got[40:]))
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-6 * scale
    ones = torch.ones(N)
    counts = rvq._segment_sum(ones, idx, K)
    assert torch.equal(counts, torch.bincount(idx, minlength=K).float())


def test_take_rows_gradient_matches_indexing():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 32, 200))
    g = torch.from_numpy(rng.standard_normal((200, 8)).astype(np.float32))
    t1, t2 = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
    out = rvq.take_rows(t1, idx)
    assert torch.equal(out, t2[idx])
    out.backward(g)
    t2[idx].backward(g)
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,p", [(50, 7), (50, 49), (8, 20), (1, 3)])
def test_reflect_pads_match_f_pad(T, p):
    x = torch.randn(3, T, generator=torch.Generator().manual_seed(T + p))
    g = torch.randn(3, T + 2 * p, generator=torch.Generator().manual_seed(1))
    x1 = x.clone().requires_grad_(True)
    got = _reflect_pad(x1, p)
    got.backward(g)
    if p < T:
        x2 = x.clone().requires_grad_(True)
        ref = F.pad(x2[:, None], (p, p), mode="reflect")[:, 0]
        ref.backward(g)
        assert torch.equal(got, ref)
        np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), rtol=1e-6, atol=1e-6)
        x3 = x.clone().requires_grad_(True)
        right = reflect_pad_right(x3, p)
        assert torch.equal(right, F.pad(x[:, None], (0, p), mode="reflect")[:, 0])
    else:          # numpy's repeated reflection
        ref = np.pad(x.numpy(), ((0, 0), (p, p)), mode="reflect") if T > 1 else \
            np.repeat(x.numpy(), T + 2 * p, axis=1)
        np.testing.assert_array_equal(got.detach().numpy(), ref)
        assert x1.grad.shape == x.shape


def test_deterministic_steps_restores_cudnn_flags():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        with pytest.raises(ValueError):
            with deterministic_steps():
                assert torch.backends.cudnn.deterministic
                assert not torch.backends.cudnn.benchmark
                raise ValueError("inside")
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (
            False, True)

        @deterministic_steps()
        def step():
            return torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        assert step() == (True, False)
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (
            False, True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.parametrize("which", ["default", "tiny", "r5", "dual"])
def test_dump_config_equals_jax(which, tmp_path):
    def make(mod):
        cfg = mod.CodecConfig()
        if which == "tiny":
            cfg = cfg.tiny()
        elif which == "r5":
            cfg = cfg.with_rvq(8, 128)
        elif which == "dual":
            import dataclasses
            cfg = dataclasses.replace(cfg, vmap_dual_encoder=True)
        return cfg
    port, ref = tmp_path / "port.json", tmp_path / "jax.json"
    config.dump_config(make(config), str(port))
    jconfig.dump_config(make(jconfig), str(ref))
    got, want = json.loads(port.read_text()), json.loads(ref.read_text())
    # the JAX package's fused-stack options have no counterpart in the port
    for key in ("fused_resunits", "fused_resunits_b1"):
        want["dac"].pop(key, None)
    assert got == want


@pytest.mark.parametrize("args", [(75 * 4, 10, 128), (75 * 20, 10, 128), (75 * 10, 10, 512),
                                  (75, 8, 100), (1, 1, 1)])
def test_nominal_bits_equals_jax(args):
    assert bitstream.nominal_bits(*args) == jbitstream.nominal_bits(*args)
