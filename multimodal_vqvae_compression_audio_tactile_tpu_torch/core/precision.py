"""Precision pin for the port's fp32 paths.

On a CUDA card PyTorch runs fp32 convolutions through cuDNN in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), which keeps about
three decimal digits, and runs fp32 matrix products in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set. The JAX package pins its
fp32 convolutions and products to HIGHEST precision (``models/dac.py:49-60``,
``core/precision.py:43-59`` there). ``fp32_exact`` turns TF32 off for the
duration of a call and gives the caller's settings back after it, so the
port's fp32 entry points compute in true fp32 without changing TF32 for the
rest of the process. ``deterministic_steps`` does the same for cuDNN's
choice of algorithms around a training step.
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


@contextlib.contextmanager
def deterministic_steps() -> Iterator[None]:
    """Inside the block, cuDNN picks only deterministic algorithms
    (``torch.backends.cudnn.deterministic``) and does not time candidates
    (``benchmark`` off), so a training step's convolutions, their backward
    ones included, sum in the same order on every run; on exit, an
    exception included, both flags are what they were. The port's training
    steps run inside it: one start, one batch and one seed give the same
    bits, as the JAX package's steps do. Process-wide while the block runs,
    like ``fp32_exact``; it leaves ``torch.use_deterministic_algorithms``
    alone, so serving and callers' code are not changed by it."""
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
