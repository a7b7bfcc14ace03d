"""The dual encoder (``CodecConfig.vmap_dual_encoder``) and the grouped
launches of K1 and K3 on the card.

- A grouped K1 launch sequence over two weight sets (the four encoder stack
  shapes) and a grouped K3 one (the two narrow ones), fp32 and bf16, batch 1
  and 8: bit-equal (``torch.equal``) to two single-stack launches, whose sum
  order is the same, and within the kernels' tolerances of their plain
  versions (``TOL``); 2 n (+ 1 in bf16) launches for both sets.
- ``dual_encode`` at full width, random weights: ``encode_latents``'s
  codes and latents equal the sequential path's bit for bit, in fp32, in
  bf16 and under ``tail_kernel``; K1 24 launches an fp32 encode and 28 a
  bf16 one (48 and 56 sequential), and under ``tail_kernel`` K3 takes the
  two narrow stacks.
- A grouped call that autograd would record raises, and so do two sets of
  unequal depth and rows that do not split into the sets.

Marked ``cuda``: each test skips without a card. The file imports neither
jax nor the JAX package; on the machine with the card run it without the
repository's conftest:

    python -m pytest --noconftest tests/test_torch_dual_encoder_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm

ENCODER_STACKS = [(64, 24000), (128, 12000), (256, 3000), (512, 600)]
NARROW_STACKS = [(64, 24000), (128, 12000)]
# against the plain version, relative to its largest element: fp32 1e-4 and
# bf16 2e-2, those of the single-stack card tests; bf16 at batch 8 2.5e-2
# (docs/PARITY.md's continuous-latent bound): the largest of 8x the elements
# (single launches, bit-equal to the grouped ones, measured 2.04e-2 at
# C128@12000, a shape and batch no single-stack test had covered)
TOL = {(torch.float32, 1): 1e-4, (torch.float32, 8): 1e-4,
       (torch.bfloat16, 1): 2e-2, (torch.bfloat16, 8): 2.5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _sets(seed, c, dev):
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(7 * c)
    sets = []
    for _ in range(2):
        units = [resunit.ResUnit(c) for _ in resunit.DILATIONS]
        with torch.no_grad():
            for u in units:
                for p in (u.conv1.weight, u.conv1.bias, u.conv2.weight, u.conv2.bias):
                    p.copy_(torch.from_numpy(rng.uniform(-bound, bound, p.shape)
                                             .astype(np.float32)))
                for s in (u.snake1, u.snake2):
                    s.alpha.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        sets.append([u.to(dev) for u in units])
    return sets


def _grouped_vs_single(kernel, counter, ref, sets, x, post, C):
    """x [B, 2, ...]: the grouped call over the rows b 2 + g against one call
    a set; -> (grouped [B, 2, ...], singles, plain, launches of the grouped)"""
    with torch.no_grad():
        before = counter.launches
        got = kernel(sets, x.flatten(0, 1).contiguous(), resunit.DILATIONS, post)
        launched = counter.launches - before
        single = torch.stack([kernel(sets[g], x[:, g].contiguous(), resunit.DILATIONS,
                                     post[g * C:(g + 1) * C]) for g in range(2)], dim=1)
        plain = ref(sets, x.flatten(0, 1).contiguous(), resunit.DILATIONS, post)
    torch.cuda.synchronize()
    return got.unflatten(0, (x.shape[0], 2)), single, plain.unflatten(0, (x.shape[0], 2)), \
        launched


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,t", ENCODER_STACKS)
def test_grouped_k1_equals_two_single_launches(cuda, c, t, dtype, batch):
    sets = _sets(c, c, cuda)
    x = torch.randn(batch, 2, c, t, generator=torch.Generator().manual_seed(c)).to(cuda, dtype)
    post = torch.rand(2 * c, generator=torch.Generator().manual_seed(1)).to(cuda) + 0.5
    got, single, plain, launched = _grouped_vs_single(
        resunit.resunit_stack, resunit, resunit.resunit_stack_ref, sets, x, post, c)
    assert launched == resunit.stack_launches(3, dtype)
    assert torch.equal(got, single)
    err = float((got.float() - plain.float()).abs().max() / plain.float().abs().max())
    assert err <= TOL[dtype, batch], err


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,t", NARROW_STACKS)
def test_grouped_k3_equals_two_single_launches(cuda, c, t, dtype, batch):
    sets = _sets(c + 1, c, cuda)
    x = torch.randn(batch, 2, t, c, generator=torch.Generator().manual_seed(c)).to(cuda, dtype)
    post = torch.rand(2 * c, generator=torch.Generator().manual_seed(2)).to(cuda) + 0.5
    got, single, plain, launched = _grouped_vs_single(
        resunit_tm.resunit_stack_tm, resunit_tm, resunit_tm.resunit_stack_tm_ref, sets, x,
        post, c)
    assert launched == resunit.stack_launches(3, dtype)
    assert torch.equal(got, single)
    err = float((got.float() - plain.float()).abs().max() / plain.float().abs().max())
    assert err <= TOL[dtype, batch], err


@pytest.mark.cuda
def test_grouped_calls_refuse_what_they_do_not_take(cuda):
    sets = _sets(3, 16, cuda)
    x = torch.randn(4, 16, 300, device=cuda)
    with pytest.raises(ValueError):
        resunit.resunit_stack([sets[0], sets[1][:2]], x)          # unequal depth
    with pytest.raises(ValueError):
        resunit.resunit_stack(sets, x[:3].contiguous())           # rows not in 2 sets
    with pytest.raises(ValueError):
        resunit.resunit_stack(sets, x, post_alpha=torch.ones(16, device=cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        resunit.resunit_stack(sets, x.requires_grad_(True))


def _encode(m, cfg, a, tc):
    before = resunit.launches, resunit_tm.launches
    z, codes = allpred_ar.encode_latents(m, a, tc, cfg=cfg)
    torch.cuda.synchronize()
    return z, codes, (resunit.launches - before[0], resunit_tm.launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_dual_encode_on_card(cuda, batch):
    cfg = CodecConfig().with_rvq(8, 128)
    dual = dataclasses.replace(cfg, vmap_dual_encoder=True)
    m = allpred_ar.codec_init(cfg, torch.Generator().manual_seed(3)).to(cuda).eval()
    rng = np.random.default_rng(batch)
    a, tc = (torch.from_numpy((0.1 * rng.standard_normal((batch, 1, 24000)))
                              .astype(np.float32)).to(cuda) for _ in range(2))
    z0, c0, n0 = _encode(m, cfg, a, tc)
    z1, c1, n1 = _encode(m, dual, a, tc)
    assert n0 == (48, 0) and n1 == (24, 0)
    assert torch.equal(c1, c0) and torch.equal(z1, z0)
    ab, tb = a.bfloat16(), tc.bfloat16()
    zb0, cb0, _ = _encode(m, cfg.fast_serving(), ab, tb)
    zb1, cb1, nb = _encode(m, dual.fast_serving(), ab, tb)
    assert nb == (28, 0) and torch.equal(cb1, cb0) and torch.equal(zb1, zb0)
    tail = dataclasses.replace(cfg, dac=dataclasses.replace(cfg.dac, tail_kernel=True))
    z2, c2, n2 = _encode(m, dataclasses.replace(tail, vmap_dual_encoder=True), a, tc)
    z3, c3, _ = _encode(m, tail, a, tc)
    assert n2 == (12, 12)                  # two narrow stacks on K3, two wide on K1
    assert torch.equal(c2, c3) and torch.equal(z2, z3)
