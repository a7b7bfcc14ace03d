"""``core/precision.py::fp32_exact``: TF32 off for cuDNN convolutions and
CUDA matrix products inside the block, the caller's settings back after it,
an exception included. (The settings exist on a CPU-only build too; the
card test of the pinned entry points is ``test_torch_precision_cuda.py``.)
"""

import itertools

import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact


@pytest.fixture
def flags():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    def current():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    def set_(conv, mm):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm

    yield current, set_
    set_(*saved)


@pytest.mark.parametrize("conv,mm", list(itertools.product([True, False], repeat=2)))
def test_pins_and_restores(flags, conv, mm):
    current, set_ = flags
    set_(conv, mm)
    with fp32_exact():
        assert current() == (False, False)
    assert current() == (conv, mm)


def test_restores_after_an_exception(flags):
    current, set_ = flags
    set_(True, True)
    with pytest.raises(RuntimeError, match="inside"):
        with fp32_exact():
            raise RuntimeError("inside")
    assert current() == (True, True)


def test_inactive_leaves_the_settings(flags):
    current, set_ = flags
    set_(True, True)
    with fp32_exact(False):
        assert current() == (True, True)
    assert current() == (True, True)
