"""The tiles of the stack kernels, pure functions of the shape that the
wrappers pass to every launch: the bf16 tensor-core kernels'
(``ops/resunit.py::pick_tile``) and the fp32 FFMA kernels'
(``ops/resunit.py::pick_ffma_tile``). At every stack shape of the serving
paths a batch-1 launch fills the H100's 132 multiprocessors, and any shape
gets a tile the kernels take. Also the launches a stack makes and the
sources each stack library is built from."""

import itertools
import math
import os

import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch import _build
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm

# (C, T) of the eight stacks of a 1 s default encode and receiver decode
# (K1); the four narrow ones are also the time-major path's (K3)
MAIN_SHAPES = [(64, 24000), (128, 12000), (256, 3000), (512, 600),
               (768, 600), (384, 3000), (192, 12000), (96, 24000)]


@pytest.mark.parametrize("c,t", MAIN_SHAPES)
def test_main_shapes_fill_the_card_at_batch_1(c, t):
    gx, gy, gz = resunit.launch_grid(c, t, 1, torch.bfloat16)
    assert gx * gy * gz >= resunit.SMS == 132
    assert (gx, gy) == (-(-t // resunit.pick_tile(c, t)[0]), -(-c // resunit.pick_tile(c, t)[1]))


@pytest.mark.parametrize("b", [1, 2, 64])
def test_any_shape_gets_a_tile_the_kernels_take(b):
    for c, t in itertools.product([1, 5, 8, 24, 31, 32, 33, 96, 100, 1024],
                                  [1, 5, 20, 39, 127, 128, 600, 4097, 24000]):
        tile = resunit.pick_tile(c, t, b)
        assert tile in resunit.TILES
        if resunit._blocks(c, t, b, tile) < resunit.SMS:   # none fills: the smallest
            assert tile == resunit.TILES[-1]


def test_larger_batch_keeps_the_tallest_tile():
    assert resunit.pick_tile(768, 600, 1) == (64, 32)
    assert resunit.pick_tile(768, 600, 2) == (128, 32)


def test_fp32_keeps_the_ffma_grid():
    """The fp32 grid at C768@600, batch 1, where the old fixed 64 x 64 tile
    gave 10 x 12 = 120 blocks, less than one wave: 32 x 64 (4 steps a
    thread) gives 19 x 12, and the k=7 launch at d = 9 covers T in 9 * 17
    slots of 4 steps, 20 blocks of 8 slots. At batch 3 the 64 x 64 grid
    gives each SM two blocks and is taken."""
    assert resunit.pick_ffma_tile(768, 600) == (32, 64)
    assert resunit.launch_grid(768, 600, 1, torch.float32) == (19, 12, 1)
    assert resunit.launch_grid(768, 600, 1, torch.float32, dil=9) == (20, 12, 1)
    assert resunit.pick_ffma_tile(768, 600, 2) == (32, 64)
    assert resunit.pick_ffma_tile(768, 600, 3) == (64, 64)


@pytest.mark.parametrize("c,t", MAIN_SHAPES)
def test_fp32_main_shapes_fill_the_card_at_batch_1(c, t):
    """A batch-1 launch fills the 132 SMs with blocks, no channel tile is
    part-empty, launch_grid reports the picked tile's grid, and each k=7
    launch's slots (steps at a stride of d, d residues a group) cover [0, T)."""
    tile = resunit.pick_ffma_tile(c, t)
    steps = resunit.FFMA_STEPS[tile]
    assert tile in resunit.FFMA_TILES and c % tile[1] == 0
    blocks = resunit._blocks(c, t, 1, tile)
    assert blocks >= resunit.SMS == 132
    for dil in resunit.DILATIONS:
        gx, gy, gz = resunit.launch_grid(c, t, 1, torch.float32, dil)
        assert (gy, gz) == (c // tile[1], 1)
        need = dil * math.ceil(t / (steps * dil))
        per_block = tile[0] // steps
        assert (gx - 1) * per_block < need <= gx * per_block
        if dil == 1:
            assert gx * gy * gz == blocks


@pytest.mark.parametrize("b", [1, 2, 64])
def test_any_shape_gets_an_ffma_tile_the_kernels_take(b):
    for c, t in itertools.product([1, 5, 8, 24, 31, 32, 33, 96, 100, 1024],
                                  [1, 5, 20, 39, 127, 128, 600, 4097, 24000]):
        tile = resunit.pick_ffma_tile(c, t, b)
        assert tile in resunit.FFMA_TILES
        if c % 64 == 0:
            two = resunit._blocks(c, t, b, (64, 64)) >= 2 * resunit.SMS
            assert tile == ((64, 64) if two else (32, 64))
        else:
            assert tile == ((128, 32) if c % 32 == 0 else (64, 32))
        gx, gy, gz = resunit.launch_grid(c, t, b, torch.float32, 9)
        assert gx >= 1 and gy * tile[1] >= c and gz == b


@pytest.mark.parametrize("n", [1, 2, 3])
def test_fp32_stacks_launch_twice_a_unit(n):
    """No prologue in fp32: each unit's k=1 launch writes the next unit's
    snaked operand, so the count stays 2 n (bf16: 2 n + 1)."""
    assert resunit.stack_launches(n, torch.float32) == 2 * n
    assert resunit.stack_launches(n, torch.bfloat16) == 2 * n + 1


@pytest.mark.parametrize("mod", [resunit, resunit_tm])
def test_stack_libraries_build_from_both_product_cores(mod):
    """A change to either core rebuilds both stack libraries (the build
    follows #include "...")."""
    srcs = [os.path.basename(f) for f in _build.sources(mod.LIBRARY[1])]
    assert srcs[0] == mod.LIBRARY[1]
    assert {"resunit_ffma.cuh", "resunit_mma.cuh"} <= set(srcs[1:])
    assert all(os.path.exists(f) for f in _build.sources(mod.LIBRARY[1]))
