"""Precision pin for the port's fp32 paths.

On a CUDA card PyTorch runs fp32 convolutions through cuDNN in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), which keeps about
three decimal digits, and runs fp32 matrix products in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set. The JAX package pins its
fp32 convolutions and products to HIGHEST precision (``models/dac.py:49-60``,
``core/precision.py:43-59`` there). ``fp32_exact`` turns TF32 off for the
duration of a call and gives the caller's settings back after it, so the
port's fp32 entry points compute in true fp32 without changing TF32 for the
rest of the process.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def fp32_exact(active: bool = True) -> Iterator[None]:
    """Inside the block (when ``active``), cuDNN convolutions and CUDA
    matrix products run without TF32; on exit, an exception included, both
    settings are what they were. The settings are process-wide while the
    block runs, as PyTorch's own ``torch.backends.cudnn.flags`` are; setting
    the two attributes keeps cuDNN's other flags (enabled, benchmark,
    deterministic) as the caller left them."""
    if not active:
        yield
        return
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
