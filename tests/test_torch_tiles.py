"""The tile of the bf16 tensor-core stack kernels (``ops/resunit.py::pick_tile``),
a pure function of the shape that the wrappers pass to every launch: at
every stack shape of the serving paths a batch-1 launch fills the H100's
132 multiprocessors, and any shape gets a tile the kernels take."""

import itertools

import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit

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
    assert resunit.launch_grid(768, 600, 1, torch.float32) == (10, 12, 1)
