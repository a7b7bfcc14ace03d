"""The port's reconstruction losses against the JAX package's, on the CPU in
fp32, for seeded numpy signals (the 1-s training segment, a 0.2-s one, one
short enough to skip an STFT resolution, and one that skips them all):
values within rtol 1e-5, input gradients within 1e-5 of their largest
element.

The mel-cosine loss (and the total, which holds it) is held to the fp32
resolution of what it computes: its value 1 - mean(cos) is a difference of
numbers near 1, so a sum order alone moves it by ~1e-7 absolute (2e-7
allowed), and its input gradient near the reflect-padded edges is a sum of
log-mel terms ~1/(M + 1e-7) that cancel to ~1e-4 of their size, which two
sum orders leave 2.5e-5 apart (5e-5 of the largest element allowed). The
6-sample signal, there for the STFT loss's all-skipped path, is no input
of the mel loss alone: its one frame is ~85 reflections of 6 samples whose
gradient terms cancel to 1e-3 of their size (the total still takes it, the
mel term weighing 0.2 of it: value within 2e-6).
Everything else at the fp32 sum order's 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.losses import losses as jl
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses import losses as pl

RTOL = 1e-5
MEL_VALUE_ATOL = 2e-7
MEL_GRAD_RTOL = 5e-5


def _pair(seed, T, shape="b1t"):
    """A reconstruction and its target, as far apart as a training step's."""
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((2, 1, T))).astype(np.float32)
    y = (0.8 * x + 0.3 * rng.standard_normal((2, 1, T))).astype(np.float32)
    return (x, y) if shape == "b1t" else (x[:, 0], y[:, 0])


def _close(got, ref, rtol=RTOL, atol=None):
    """Within rtol, or for an array within rtol of its largest element."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if atol is None:
        atol = rtol * float(np.abs(ref).max()) if ref.ndim else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


MEL = ("mel_cosine", "codec_total")


def _value_and_grad(name, x, y, mel_atol=MEL_VALUE_ATOL):
    fn_port, fn_jax = LOSSES[name]
    xt = torch.from_numpy(x).requires_grad_(True)
    v = fn_port(xt, torch.from_numpy(y))
    v.backward()
    jv, jg = jax.value_and_grad(lambda a: fn_jax(a, jnp.asarray(y)))(jnp.asarray(x))
    _close(v.detach().numpy(), jv, atol=mel_atol if name in MEL else 0.0)
    _close(xt.grad.numpy(), jg, rtol=MEL_GRAD_RTOL if name in MEL else RTOL)
    return float(v.detach())


LOSSES = {
    "safe_l1": (pl.safe_l1, jl.safe_l1),
    "multires_stft": (pl.multires_stft_loss, jl.multires_stft_loss),
    "mel_cosine": (pl.mel_cosine_loss, jl.mel_cosine_loss),
    "codec_total": (lambda a, b: pl.codec_loss(a, b)[0], lambda a, b: jl.codec_loss(a, b)[0]),
}


CASES = [(name, T) for name in sorted(LOSSES) for T in (24000, 4800, 300, 6)
         if (name, T) != ("mel_cosine", 6)]


@pytest.mark.parametrize("name,T", CASES)
def test_loss_value_and_input_grad_match_jax(name, T):
    """T 300 skips the 1024-point resolution, T 6 skips every one (0.1 x L1)."""
    x, y = _pair(T, T)
    v = _value_and_grad(name, x, y, mel_atol=2e-6 if T == 6 else MEL_VALUE_ATOL)
    assert np.isfinite(v)


@pytest.mark.parametrize("name", ["multires_stft", "mel_cosine"])
def test_loss_on_batch_by_time_inputs(name):
    x, y = _pair(3, 4800, shape="bt")
    _value_and_grad(name, x, y)


def test_codec_loss_parts_match_jax():
    x, y = _pair(5, 4800)
    total, parts = pl.codec_loss(torch.from_numpy(x), torch.from_numpy(y), sr=24000)
    jtotal, jparts = jl.codec_loss(jnp.asarray(x), jnp.asarray(y), sr=24000)
    assert sorted(parts) == sorted(jparts)
    for k in parts:
        _close(parts[k].numpy(), jparts[k], atol=MEL_VALUE_ATOL if k in ("mel", "total") else 0.0)


def test_losses_zero_non_finite_inputs():
    x, y = _pair(6, 4800)
    x[0, 0, :10] = np.nan
    x[1, 0, 5] = np.inf
    for name in ("safe_l1", "multires_stft", "codec_total"):
        port, jax_fn = LOSSES[name]
        v = port(torch.from_numpy(x), torch.from_numpy(y))
        _close(v.numpy(), jax_fn(jnp.asarray(x), jnp.asarray(y)),
               atol=MEL_VALUE_ATOL if name in MEL else 0.0)
        assert np.isfinite(float(v))


@pytest.mark.parametrize("t_in,t_out", [(10, 10), (10, 17), (17, 10), (1, 4)])
def test_interp_frames_matches_jax(t_in, t_out):
    m = np.random.default_rng(t_in * 31 + t_out).standard_normal((2, 3, t_in)).astype(np.float32)
    got = pl._interp_frames(torch.from_numpy(m), t_out).numpy()
    np.testing.assert_allclose(got, np.asarray(jl._interp_frames(jnp.asarray(m), t_out)),
                               rtol=1e-6, atol=1e-7)
