"""The residual-unit stack kernel (K1) on the card, against its plain version:
bf16 on the tensor cores at the eight stack shapes of the default path and at
ragged ones, fp32 on FFMA bit-equal to the plain version.

Marked ``cuda``: each test skips without a card. The file imports neither jax
nor the JAX package, so it also runs on a machine with the card, which has
neither; there, run it without the repository's conftest (which sets up jax):

    python -m pytest --noconftest tests/test_torch_resunit_cuda.py -q
"""

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _units(seed, c, dev):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(7 * c)
    units = [resunit.ResUnit(c) for _ in resunit.DILATIONS]
    with torch.no_grad():
        for u in units:
            for p in (u.conv1.weight, u.conv1.bias, u.conv2.weight, u.conv2.bias):
                p.copy_(torch.from_numpy(rng.uniform(-bound, bound, p.shape).astype(np.float32)))
            for s in (u.snake1, u.snake2):
                s.alpha.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return [u.to(dev) for u in units]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c,t,post", [(64, 3000, True), (96, 1000, False),
                                      (5, 130, True), (8, 39, False)])
def test_kernel_matches_plain_on_card(cuda, dtype, tol, c, t, post):
    """fp32: sum order only (TF32 off); bf16: one rounding of the operands.
    Odd C, T not a multiple of the tile, and T equal to the stack's halo."""
    units = _units(c, c, cuda)
    x = torch.randn(2, c, t, generator=torch.Generator().manual_seed(c)).to(cuda, dtype)
    pa = torch.full((c,), 0.8, device=cuda) if post else None
    with torch.no_grad():
        before = resunit.launches
        got = resunit.resunit_stack(units, x, resunit.DILATIONS, pa)
        assert resunit.launches == before + resunit.stack_launches(3, dtype)
        ref = resunit.resunit_stack_ref(units, x, resunit.DILATIONS, pa)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
    assert got.dtype == dtype and err <= tol


# (C, T, trailing snake) of the eight stacks of the default path at 1 s
MAIN_SHAPES = [(64, 24000, True), (128, 12000, True), (256, 3000, True),
               (512, 600, True), (768, 600, False), (384, 3000, False),
               (192, 12000, False), (96, 24000, True)]


def _run(units, x, pa):
    with torch.no_grad():
        before = resunit.launches
        got = resunit.resunit_stack(units, x, resunit.DILATIONS, pa)
        assert resunit.launches == before + resunit.stack_launches(len(units), x.dtype)
        ref = resunit.resunit_stack_ref(units, x, resunit.DILATIONS, pa)
    torch.cuda.synchronize()
    return got, ref


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,post", MAIN_SHAPES)
def test_bf16_tensor_cores_match_plain_at_main_shapes(cuda, c, t, post):
    """bf16 at batch 1: the same bf16 operands as the plain version, fp32
    sums in another order, so within 2e-2 (TOL[bf16])."""
    units = _units(c + 1, c, cuda)
    x = torch.randn(1, c, t, generator=torch.Generator().manual_seed(t)).to(cuda, torch.bfloat16)
    pa = torch.full((c,), 0.8, device=cuda) if post else None
    got, ref = _run(units, x, pa)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _rel(got, ref) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t", [(2, 96, 1000), (2, 24, 1000), (2, 24, 130),
                                   (1, 96, 77), (2, 40, 20), (2, 24, 5), (1, 1, 600),
                                   (2, 20, 300)])
def test_bf16_ragged_shapes(cuda, b, c, t):
    """C off every tile (96, 24, 40, 1, 20; C % 8 != 0 stages h2 without
    cp.async), T off the t tile and under the stack's 39-step halo, batch 2."""
    units = _units(c + t, c, cuda)
    x = torch.randn(b, c, t, generator=torch.Generator().manual_seed(c)).to(cuda, torch.bfloat16)
    got, ref = _run(units, x, torch.full((c,), 1.2, device=cuda))
    assert bool(torch.isfinite(got).all()) and _rel(got, ref) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,post", MAIN_SHAPES)
def test_fp32_ffma_bit_equal_to_plain_at_main_shapes(cuda, c, t, post):
    """The fp32 path is unchanged: FFMA in cuDNN's sum order, bit-equal to the
    plain version (TF32 off), which the fp32 code-equality gates rest on."""
    units = _units(c + 2, c, cuda)
    x = torch.randn(1, c, t, generator=torch.Generator().manual_seed(c)).to(cuda)
    pa = torch.full((c,), 0.8, device=cuda) if post else None
    got, ref = _run(units, x, pa)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t", [20, 5])
def test_kernel_serves_signals_shorter_than_the_halo(cuda, dtype, tol, t):
    """T under the stack's 3 * (1 + 3 + 9) = 39-step halo, as the plain
    version and the JAX package serve it: the kernels zero everything
    outside [0, T)."""
    units = _units(t, 8, cuda)
    x = torch.randn(2, 8, t, generator=torch.Generator().manual_seed(t)).to(cuda, dtype)
    got, ref = _run(units, x, torch.full((8,), 0.8, device=cuda))
    assert got.dtype == dtype and _rel(got, ref) <= tol


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    units = _units(2, 8, cuda)
    x = torch.randn(1, 8, 600, device=cuda)
    with pytest.raises(ValueError):
        resunit.resunit_stack(units, x.half())
    with pytest.raises(ValueError):
        resunit.resunit_stack(units, x[..., ::2])            # not contiguous
    with pytest.raises(ValueError):
        resunit.resunit_stack([u.cpu() for u in units], x)    # weights elsewhere
