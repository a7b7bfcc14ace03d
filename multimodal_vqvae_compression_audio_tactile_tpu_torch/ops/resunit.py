"""Residual-unit stack (K1): the CUDA kernel's wrapper and its plain version.

A residual unit is snake -> dilated k=7 conv -> snake -> k=1 conv -> residual
add (``models/dac.py::_resunit_apply`` in the JAX package); a stack is up to
three units at dilations 1/3/9, optionally followed by the block's trailing
snake. ``resunit_stack`` sends a CUDA tensor through ``csrc/resunit_stack.cu``
(two launches per unit) and a CPU tensor through ``resunit_stack_ref``. It
never sends a CUDA tensor to the plain version: what the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import _build

DILATIONS = (1, 3, 9)
MAX_HALO_PER_UNIT = 27     # the kernel's shared-memory window: 3 * dilation <= 27

# Kernel launches made by ``resunit_stack`` (two per unit); reset it to 0
# before a run to count that run's launches.
launches = 0


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + sin^2(a x) / (a + 1e-9), computed in fp32, returned in x's dtype."""
    a = alpha.float()[None, :, None]
    xf = x.float()
    return (xf + torch.sin(a * xf) ** 2 / (a + 1e-9)).to(x.dtype)


class Snake(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha)


class ResUnit(nn.Module):
    """Parameters of one residual unit, in PyTorch's conv layouts (applied by
    ``resunit_stack``, which gives each unit its dilation)."""

    def __init__(self, c: int):
        super().__init__()
        self.snake1 = Snake(c)
        self.conv1 = nn.Conv1d(c, c, 7)     # dilation is the stack's, per unit
        self.snake2 = Snake(c)
        self.conv2 = nn.Conv1d(c, c, 1)


def resunit_stack_ref(units: Sequence[ResUnit], x: torch.Tensor,
                      dilations: Sequence[int] = DILATIONS,
                      post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic op by op. Operands are in
    x's dtype, biases, snakes and the residual add in fp32."""
    cdt = x.dtype
    for u, d in zip(units, dilations):
        h = snake(x, u.snake1.alpha)
        acc = F.conv1d(h, u.conv1.weight.to(cdt), None, dilation=d,
                       padding=3 * d).float() + u.conv1.bias.float()[:, None]
        h2 = snake(acc, u.snake2.alpha).to(cdt)
        y = F.conv1d(h2, u.conv2.weight.to(cdt)).float() + u.conv2.bias.float()[:, None]
        x = (x.float() + y).to(cdt)
    if post_alpha is not None:
        x = snake(x, post_alpha)
    return x


# (library name, source under csrc/)
LIBRARY = ("resunit", "resunit_stack.cu")
_SIGNATURES = {
    "resunit_conv7": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "resunit_conv1": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    return _build.load(*LIBRARY, _SIGNATURES)


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def resunit_stack(units: Sequence[ResUnit], x: torch.Tensor,
                  dilations: Sequence[int] = DILATIONS,
                  post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stack of residual units over x [B, C, T], then the optional trailing
    snake ``post_alpha`` [C]. CUDA tensors go through the kernel (fp32 or
    bf16, contiguous, on the same device as the weights); CPU tensors through
    ``resunit_stack_ref``."""
    global launches
    if x.device.type == "cpu":
        return resunit_stack_ref(units, x, dilations, post_alpha)
    if x.device.type != "cuda":
        raise ValueError(f"resunit_stack: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resunit_stack: unsupported dtype {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("resunit_stack: x must be a contiguous [B, C, T] tensor")
    B, C, T = x.shape
    dils = tuple(dilations[:len(units)])
    if len(dils) != len(units) or any(3 * d > MAX_HALO_PER_UNIT or d < 1
                                      for d in dils):
        raise ValueError(f"resunit_stack: unsupported dilations {dils}")
    if 3 * sum(dils) > T:
        raise ValueError(f"resunit_stack: receptive-field halo {3 * sum(dils)} "
                         f"exceeds T={T}")
    for u in units:
        if (u.conv1.weight.shape != (C, C, 7) or u.conv2.weight.shape != (C, C, 1)
                or u.conv1.weight.device != x.device):
            raise ValueError("resunit_stack: unit weights do not match x")
    if post_alpha is not None and post_alpha.shape != (C,):
        raise ValueError("resunit_stack: post_alpha must be [C]")

    lib = _lib()
    is_bf16 = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.no_grad():
        for i, (u, d) in enumerate(zip(units, dils)):
            w7 = u.conv1.weight.detach().to(x.dtype).contiguous()
            w1 = u.conv2.weight.detach().to(x.dtype).contiguous()
            b7, b1 = _f32(u.conv1.bias), _f32(u.conv2.bias)
            a1, a2 = _f32(u.snake1.alpha), _f32(u.snake2.alpha)
            h2 = torch.empty_like(x)
            _check(lib.resunit_conv7(x.data_ptr(), w7.data_ptr(), b7.data_ptr(),
                                     a1.data_ptr(), a2.data_ptr(), h2.data_ptr(),
                                     B, C, T, d, is_bf16, stream), "resunit_conv7")
            launches += 1
            post = (_f32(post_alpha) if post_alpha is not None
                    and i == len(units) - 1 else None)
            out = torch.empty_like(x)
            _check(lib.resunit_conv1(x.data_ptr(), h2.data_ptr(), w1.data_ptr(),
                                     b1.data_ptr(),
                                     post.data_ptr() if post is not None else None,
                                     out.data_ptr(), B, C, T, is_bf16, stream),
                   "resunit_conv1")
            launches += 1
            x = out
    return x
