"""The port's time-major convs (``ops/timeconv.py``) and polyphase upsampling
against the JAX package.

Same numpy weights and inputs through both, fp32 on the CPU (JAX at
HIGHEST). Tolerances are those of the JAX package's own ``tests/
test_timeconv.py``: rtol = atol = 1e-5, sum order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu.ops import timeconv as jtc
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import dac
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, timeconv as tc

HI = jax.lax.Precision.HIGHEST


def _params(seed, c_in, c_out, k):
    """JAX conv params {w [C_out, C_in, k], b [C_out]} from numpy."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(c_in * k)
    return {"w": rng.uniform(-bound, bound, (c_out, c_in, k)).astype(np.float32),
            "b": rng.uniform(-bound, bound, c_out).astype(np.float32)}


def _conv(p):
    c_out, c_in, k = p["w"].shape
    m = nn.Conv1d(c_in, c_out, k)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(p["w"]))
        m.bias.copy_(torch.from_numpy(p["b"]))
    return m


def _conv_t(p):
    """JAX transposed-conv params ([C_out, C_in, k]) -> nn.ConvTranspose1d."""
    c_out, c_in, k = p["w"].shape
    m = nn.ConvTranspose1d(c_in, c_out, k)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.swapaxes(p["w"], 0, 1)))
        m.bias.copy_(torch.from_numpy(p["b"]))
    return m


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jp(p):
    return jax.tree.map(jnp.asarray, p)


def _close(got, ref, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_snake_tm_matches_jax():
    x = 3 * _x(0, 2, 40, 5)
    a = np.random.default_rng(1).uniform(0.1, 2.0, 5).astype(np.float32)
    _close(tc.snake_tm(torch.from_numpy(a), torch.from_numpy(x)),
           jtc.snake_tm(jnp.asarray(a), jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("k", [7, 3, 1])
def test_conv_tm_matches_jax(k, dilation):
    p = _params(k * 10 + dilation, 12, 20, k)
    x = _x(k + dilation, 2, 64, 12)
    ref = jtc.conv_tm(_jp(p), jnp.asarray(x), dilation=dilation, precision=HI)
    with torch.no_grad():
        got = tc.conv_tm(_conv(p), torch.from_numpy(x), dilation=dilation)
    _close(got, ref)


@pytest.mark.parametrize("r", [2, 4, 5, 8])
def test_down_tm_matches_jax(r):
    p = _params(r, 10, 14, 2 * r)
    x = _x(100 + r, 2, 40 * r, 10)
    ref = jtc.down_tm(_jp(p), jnp.asarray(x), stride=r, precision=HI)
    with torch.no_grad():
        got = tc.down_tm(_conv(p), torch.from_numpy(x), stride=r)
    assert got.shape == (2, 40, 14)
    _close(got, ref)


@pytest.mark.parametrize("r", [8, 5, 4, 2])
def test_up_tm_matches_jax(r):
    p = _params(200 + r, 14, 6, 2 * r)
    x = _x(300 + r, 2, 23, 14)
    ref = jtc.up_tm(_jp(p), jnp.asarray(x), stride=r, precision=HI)
    with torch.no_grad():
        got = tc.up_tm(_conv_t(p), torch.from_numpy(x), stride=r)
    assert got.shape == (2, 23 * r, 6)
    _close(got, ref)


def test_geometry_other_than_2r_raises():
    with pytest.raises(ValueError):
        tc.down_tm(nn.Conv1d(4, 4, 5), torch.zeros(1, 20, 4), stride=2)
    with pytest.raises(ValueError):
        tc.up_tm(nn.ConvTranspose1d(4, 4, 5), torch.zeros(1, 20, 4), stride=2)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_resunit_tm_matches_jax(dilation):
    rng = np.random.default_rng(7 + dilation)
    c = 16
    u = {"snake1": {"alpha": rng.uniform(0.5, 1.5, c).astype(np.float32)},
         "conv1": _params(dilation, c, c, 7),
         "snake2": {"alpha": rng.uniform(0.5, 1.5, c).astype(np.float32)},
         "conv2": _params(dilation + 50, c, c, 1)}
    x = _x(dilation, 2, 54, c)
    ref = jtc.resunit_tm(_jp(u), jnp.asarray(x), dilation, precision=HI)
    m = resunit.ResUnit(c)
    with torch.no_grad():
        m.snake1.alpha.copy_(torch.from_numpy(u["snake1"]["alpha"]))
        m.snake2.alpha.copy_(torch.from_numpy(u["snake2"]["alpha"]))
        for conv, name in ((m.conv1, "conv1"), (m.conv2, "conv2")):
            conv.weight.copy_(torch.from_numpy(u[name]["w"]))
            conv.bias.copy_(torch.from_numpy(u[name]["b"]))
        got = tc.resunit_tm(m, torch.from_numpy(x), dilation)
    _close(got, ref)


@pytest.mark.parametrize("r", [8, 5, 4, 2])
def test_conv1d_transpose_poly_matches_jax_and_dilated_form(r):
    p = _params(400 + r, 12, 6, 2 * r)
    x = _x(500 + r, 2, 12, 17)
    m = _conv_t(p)
    ref = jdac.conv1d_transpose_poly(_jp(p), jnp.asarray(x), stride=r, precision=HI)
    with torch.no_grad():
        got = dac.conv1d_transpose_poly(m, torch.from_numpy(x), r)
        dilated = dac.conv1d_transpose(m, torch.from_numpy(x), r)
    assert got.shape == (2, 6, 17 * r)
    _close(got, ref)
    _close(got, dilated.numpy())


def test_conv1d_transpose_poly_needs_k_2r():
    with pytest.raises(ValueError):
        dac.conv1d_transpose_poly(nn.ConvTranspose1d(4, 2, 6), torch.zeros(1, 4, 9), 2)
