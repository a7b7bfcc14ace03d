"""The port's time-major residual-unit stack (K3) against the JAX package.

``resunit_stack_tm_ref`` (the plain PyTorch version of the CUDA kernel) is
held against the TPU kernel run in interpret mode
(``resunit_tm_pallas.resunit_stack_tm(interpret=True)``) on the CPU: in fp32
at the cases of the JAX package's ``tests/test_resunit_tm_pallas.py``, with
the trailing snake, at its tolerance 2e-5 (sum order only); in bf16 within
2e-2 of the output's scale. The CUDA kernel itself is held against the plain
version on the card in ``test_torch_resunit_tm_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.ops import resunit_tm_pallas as rtm
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm

from test_torch_resunit import _torch_units, _units


def _data(seed, c, t, n_units, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((2, t, c))).astype(np.float32)
    pa = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return _units(seed + 1, c, n_units), x, pa


def _jax(units, x, dils, pa, t_tile, dtype=jnp.float32):
    y = rtm.resunit_stack_tm(jax.tree.map(jnp.asarray, units),
                             jnp.asarray(x).astype(dtype), dils,
                             post_snake_alpha=jnp.asarray(pa), interpret=True,
                             t_tile=t_tile)
    return np.asarray(y, np.float32)


def _port(units, x, dils, pa, dtype=torch.float32):
    with torch.no_grad():
        y = resunit_tm.resunit_stack_tm_ref(
            _torch_units(units, x.shape[2]), torch.from_numpy(x).to(dtype), dils,
            torch.from_numpy(pa))
    assert y.dtype == dtype
    return y.float().numpy()


@pytest.mark.parametrize("c,t,dils,t_tile", [
    (8, 160, (1, 3, 9), 48),     # multi-tile, halo crossing
    (8, 150, (1, 3, 9), 64),     # T not a tile multiple
    (16, 96, (1,), 96),          # one unit, one tile
    (8, 120, (1, 3), 40),        # t_tile equal to the halo
])
def test_ref_matches_pallas_interpret_fp32(c, t, dils, t_tile):
    units, x, pa = _data(c * 1000 + t, c, t, len(dils))
    np.testing.assert_allclose(_port(units, x, dils, pa),
                               _jax(units, x, dils, pa, t_tile),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("c,t,scale", [(8, 64, 1.0), (16, 200, 1.0), (32, 160, 20.0)])
def test_bf16_follows_the_tm_kernel_with_its_fp32_carry(c, t, scale):
    """bf16: the plain version is within 2e-2 of the output's scale of the TPU
    kernel's bf16 run. Both keep the carry in fp32; the channels-first K1's
    plain version, which rounds the carry to bf16 after every unit, is
    further off from it."""
    units, x, pa = _data(c + t, c, t, 3, scale)
    ref = _jax(units, x, (1, 3, 9), pa, 40, jnp.bfloat16)
    got = _port(units, x, (1, 3, 9), pa, torch.bfloat16)
    with torch.no_grad():
        k1 = resunit.resunit_stack_ref(
            _torch_units(units, c), torch.from_numpy(x).bfloat16().transpose(1, 2).contiguous(),
            (1, 3, 9), torch.from_numpy(pa)).transpose(1, 2).float().numpy()
    scale_ref = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) / scale_ref
    err_k1 = float(np.abs(k1 - ref).max()) / scale_ref
    assert err <= 2e-2
    assert err < err_k1


@pytest.mark.parametrize("dils", [(13,), (9, 9), (1, 3, 9, 1), ()])
def test_halo_limits_raise(dils):
    """As the TPU kernel's asserts: 3 sum(d) <= 40 and 3 max(d) <= 27."""
    units = _torch_units(_units(0, 8, len(dils)), 8)
    with pytest.raises(ValueError):
        resunit_tm.resunit_stack_tm(units, torch.zeros(1, 64, 8), dils)


def test_cpu_tensor_takes_the_plain_version():
    units = _torch_units(_units(3, 8, 3), 8)
    x = torch.randn(1, 300, 8, generator=torch.Generator().manual_seed(0))
    pa = torch.full((8,), 1.3)
    before = resunit_tm.launches
    with torch.no_grad():
        got = resunit_tm.resunit_stack_tm(units, x, resunit.DILATIONS, pa)
        ref = resunit_tm.resunit_stack_tm_ref(units, x, resunit.DILATIONS, pa)
    assert torch.equal(got, ref)
    assert resunit_tm.launches == before        # no kernel launched for a CPU tensor


def test_meta_tensor_raises():
    """Only CPU and CUDA tensors are taken; nothing falls back silently."""
    units = _torch_units(_units(1, 8, 1), 8)
    with pytest.raises(ValueError):
        resunit_tm.resunit_stack_tm(units, torch.empty(1, 64, 8, device="meta"), (1,))
