"""Time-major residual-unit stack (K3): the CUDA kernel's wrapper and its
plain version.

The same stack as ``ops/resunit.py`` (snake -> dilated k=7 conv -> snake ->
k=1 conv -> residual add, per unit at dilations 1/3/9, then the optional
trailing snake), on time-major x ``[B, T, C]``, with the arithmetic of the
JAX package's ``ops/resunit_tm_pallas.py::_kernel``: the residual carry stays
fp32 across all units and is cast to x's dtype once, at the end; each
unit's snakes, biases and residual add are fp32; the conv operands (the
snaked carry and h2) are rounded to x's dtype, the products summed in fp32.
The channels-first K1 instead rounds its carry after every unit, so in bf16
the two stacks differ on purpose, each following its own TPU kernel.

``resunit_stack_tm`` sends a CUDA tensor through ``csrc/resunit_stack_tm.cu``
(two launches per unit) and a CPU tensor through ``resunit_stack_tm_ref``. It
never sends a CUDA tensor to the plain version: what the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .. import _build
from .resunit import DILATIONS, ResUnit, _check, _f32
from .timeconv import snake_tm

# The TPU kernel's limits, which the wrapper keeps: its haloed window covers a
# stack's receptive field up to 40 rows, and a single tap shifts by at most 27.
HALO = 40
MAX_SHIFT = 27

# Kernel launches made by ``resunit_stack_tm`` (two per unit); reset it to 0
# before a run to count that run's launches.
launches = 0


def _operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the operand type and widen again: products of such values
    are exact in fp32, so fp32 matmuls of them sum like the kernel does."""
    return t.to(dtype).float()


def resunit_stack_tm_ref(units: Sequence[ResUnit], x_btc: torch.Tensor,
                         dilations: Sequence[int] = DILATIONS,
                         post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic op by op, one fp32
    product per tap."""
    cdt = x_btc.dtype
    T = x_btc.shape[1]
    acc_x = x_btc.float()                                  # fp32 residual carry
    for u, d in zip(units, dilations):
        h = _operand(snake_tm(u.snake1.alpha, acc_x), cdt)
        hp = F.pad(h, (0, 0, 3 * d, 3 * d))
        w7 = _operand(u.conv1.weight, cdt).permute(2, 1, 0)   # [7, C_in, C_out]
        acc = torch.matmul(hp[:, :T], w7[0])
        for j in range(1, 7):
            acc = acc + torch.matmul(hp[:, j * d:j * d + T], w7[j])
        acc = acc + u.conv1.bias.float()
        h2 = _operand(snake_tm(u.snake2.alpha, acc), cdt)
        y = torch.matmul(h2, _operand(u.conv2.weight[:, :, 0], cdt).T)
        acc_x = acc_x + (y + u.conv2.bias.float())
    if post_alpha is not None:
        acc_x = snake_tm(post_alpha, acc_x)
    return acc_x.to(cdt)


# (library name, source under csrc/)
LIBRARY = ("resunit_tm", "resunit_stack_tm.cu")
_SIGNATURES = {
    "resunit_tm_conv7": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "resunit_tm_conv1": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}


def _lib() -> ctypes.CDLL:
    return _build.load(*LIBRARY, _SIGNATURES)


def _check_dilations(dilations: Sequence[int], n_units: int) -> tuple:
    """The dilations of a stack of ``n_units``, held to the TPU kernel's
    limits (``resunit_tm_pallas.py:231-240``); raises on what it refuses."""
    dils = tuple(dilations[:n_units])
    if n_units < 1 or len(dils) != n_units or min(dils) < 1:
        raise ValueError(f"resunit_stack_tm: unsupported dilations {dils}")
    if 3 * sum(dils) > HALO:
        raise ValueError(f"resunit_stack_tm: stack receptive field {3 * sum(dils)} "
                         f"exceeds the halo {HALO}")
    if 3 * max(dils) > MAX_SHIFT:
        raise ValueError(f"resunit_stack_tm: single-tap shift {3 * max(dils)} "
                         f"exceeds {MAX_SHIFT}")
    return dils


def resunit_stack_tm(units: Sequence[ResUnit], x_btc: torch.Tensor,
                     dilations: Sequence[int] = DILATIONS,
                     post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stack of residual units over time-major x [B, T, C], then the optional
    trailing snake ``post_alpha`` [C]. CUDA tensors go through the kernel
    (fp32 or bf16, contiguous, on the same device as the weights); CPU
    tensors through ``resunit_stack_tm_ref``."""
    global launches
    dils = _check_dilations(dilations, len(units))
    if x_btc.device.type == "cpu":
        return resunit_stack_tm_ref(units, x_btc, dils, post_alpha)
    if x_btc.device.type != "cuda":
        raise ValueError(f"resunit_stack_tm: unsupported device {x_btc.device}")
    if x_btc.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resunit_stack_tm: unsupported dtype {x_btc.dtype}")
    if x_btc.dim() != 3 or not x_btc.is_contiguous():
        raise ValueError("resunit_stack_tm: x must be a contiguous [B, T, C] tensor")
    B, T, C = x_btc.shape
    for u in units:
        if (u.conv1.weight.shape != (C, C, 7) or u.conv2.weight.shape != (C, C, 1)
                or u.conv1.weight.device != x_btc.device):
            raise ValueError("resunit_stack_tm: unit weights do not match x")
    if post_alpha is not None and post_alpha.shape != (C,):
        raise ValueError("resunit_stack_tm: post_alpha must be [C]")

    lib = _lib()
    is_bf16 = int(x_btc.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x_btc.device).cuda_stream
    acc = x_btc                  # the carry: x's dtype before unit 0, fp32 after
    with torch.no_grad():
        for i, (u, d) in enumerate(zip(units, dils)):
            # the kernel reads the fp32 weights and rounds them to x's dtype
            w7, w1 = _f32(u.conv1.weight), _f32(u.conv2.weight)
            b7, b1 = _f32(u.conv1.bias), _f32(u.conv2.bias)
            a1, a2 = _f32(u.snake1.alpha), _f32(u.snake2.alpha)
            acc_f32 = int(acc.dtype == torch.float32)
            h2 = torch.empty_like(x_btc)
            _check(lib.resunit_tm_conv7(acc.data_ptr(), acc_f32, w7.data_ptr(),
                                        b7.data_ptr(), a1.data_ptr(), a2.data_ptr(),
                                        h2.data_ptr(), B, C, T, d, is_bf16, stream),
                   "resunit_tm_conv7")
            launches += 1
            last = i == len(units) - 1
            post = _f32(post_alpha) if last and post_alpha is not None else None
            out = torch.empty_like(x_btc, dtype=x_btc.dtype if last else torch.float32)
            _check(lib.resunit_tm_conv1(acc.data_ptr(), acc_f32, h2.data_ptr(),
                                        w1.data_ptr(), b1.data_ptr(),
                                        post.data_ptr() if post is not None else None,
                                        out.data_ptr(), int(out.dtype == torch.float32),
                                        B, C, T, is_bf16, stream),
                   "resunit_tm_conv1")
            launches += 1
            acc = out
    return acc
