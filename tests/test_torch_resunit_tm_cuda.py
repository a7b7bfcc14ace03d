"""The time-major residual-unit stack kernel (K3) on the card, against its
plain version.

Marked ``cuda``: each test skips without a card. The file imports neither jax
nor the JAX package, so it also runs on a machine with the card, which has
neither; there, run it without the repository's conftest (which sets up jax):

    python -m pytest --noconftest tests/test_torch_resunit_tm_cuda.py -q
"""

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _units(seed, c, n, dev):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(7 * c)
    units = [resunit.ResUnit(c) for _ in range(n)]
    with torch.no_grad():
        for u in units:
            for p in (u.conv1.weight, u.conv1.bias, u.conv2.weight, u.conv2.bias):
                p.copy_(torch.from_numpy(rng.uniform(-bound, bound, p.shape).astype(np.float32)))
            for s in (u.snake1, u.snake2):
                s.alpha.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return [u.to(dev) for u in units]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,c,t,n_units,post", [
    (1, 64, 24000, 3, True), (1, 128, 12000, 3, True),     # the encoders' narrow stacks
    (1, 192, 12000, 3, False), (1, 96, 24000, 3, True),    # the decoder's
    (2, 96, 1000, 3, False), (2, 5, 130, 1, True),         # odd C, T off the tile
    (1, 8, 39, 3, False), (3, 16, 70, 2, True),            # T equal to the halo
])
def test_kernel_matches_plain_on_card(cuda, dtype, tol, b, c, t, n_units, post):
    """fp32: sum order only (TF32 off); bf16: the same operands rounded to
    bf16 in both, fp32 sums, so again sum order only, held at 2e-2."""
    units = _units(c + t, c, n_units, cuda)
    x = torch.randn(b, t, c, generator=torch.Generator().manual_seed(c)).to(cuda, dtype)
    pa = torch.full((c,), 0.8, device=cuda) if post else None
    dils = resunit.DILATIONS[:n_units]
    with torch.no_grad():
        before = resunit_tm.launches
        got = resunit_tm.resunit_stack_tm(units, x, dils, pa)
        assert resunit_tm.launches == before + 2 * n_units
        ref = resunit_tm.resunit_stack_tm_ref(units, x, dils, pa)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
    assert got.dtype == dtype and got.shape == x.shape and err <= tol


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    units = _units(2, 8, 3, cuda)
    x = torch.randn(1, 600, 8, device=cuda)
    with pytest.raises(ValueError):
        resunit_tm.resunit_stack_tm(units, x.half())
    with pytest.raises(ValueError):
        resunit_tm.resunit_stack_tm(units, x[:, ::2])                 # not contiguous
    with pytest.raises(ValueError):
        resunit_tm.resunit_stack_tm(units[:1], x, (13,))              # shift 39 > 27
    with pytest.raises(ValueError):
        resunit_tm.resunit_stack_tm([u.cpu() for u in units], x)      # weights elsewhere
