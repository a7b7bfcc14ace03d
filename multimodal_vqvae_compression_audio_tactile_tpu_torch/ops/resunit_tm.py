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
(fp32 on FFMA through the product core ``csrc/resunit_ffma.cuh`` that K1
shares, with the tile of ``resunit.pick_ffma_tile``, two launches per unit;
bf16 on the tensor cores through the product core ``csrc/resunit_mma.cuh``
that K1 shares, with the tile of ``resunit.pick_tile``, two launches per unit
and one prologue) and a CPU tensor through ``resunit_stack_tm_ref``. It
never sends a CUDA tensor to the plain version: what the kernel does not
take raises, a call that autograd would record included
(``resunit.refuse_autograd``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .. import _build
from .resunit import (DILATIONS, ResUnit, _check, _f32, _ptr, pick_ffma_tile, pick_tile,
                      prologue_ptrs, refuse_autograd, stack_ptrs)
from .timeconv import snake_tm

# The TPU kernel's limits, which the wrapper keeps: its haloed window covers a
# stack's receptive field up to 40 rows, and a single tap shifts by at most 27.
HALO = 40
MAX_SHIFT = 27

# Kernel launches made by ``resunit_stack_tm`` (``resunit.stack_launches`` a
# stack); reset it to 0 before a run to count that run's launches.
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
    "resunit_tm_prologue": ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
                            + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "resunit_tm_conv7": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "resunit_tm_conv1": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
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


def _stack_tm_bf16(lib, units: Sequence[ResUnit], x_btc: torch.Tensor, dils: tuple,
                   post_alpha: Optional[torch.Tensor], stream: int) -> torch.Tensor:
    """The bf16 launches of one stack: the prologue, then two per unit, with
    hs = bf16(snake_a1(carry)) into each k=7 launch and h2 into each k=1
    launch in one bf16 workspace, and the fp32 carry between units in a
    ping-pong pair."""
    global launches
    B, T, C = x_btc.shape
    n, btc, es = len(units), B * T * C, x_btc.element_size()
    tile = pick_tile(C, T, B)
    kept, ptrs = stack_ptrs(units)      # kept alive until the launches are queued
    post = _f32(post_alpha) if post_alpha is not None else None
    ws = x_btc.new_empty(n * 8 * C * C + 3 * btc)
    wp = ws.data_ptr()
    hs = [wp + (n * 8 * C * C + k * btc) * es for k in range(2)]
    h2 = wp + (n * 8 * C * C + 2 * btc) * es
    carry = x_btc.new_empty(2, btc, dtype=torch.float32) if n > 1 else None
    out = torch.empty_like(x_btc)
    _check(lib.resunit_tm_prologue(x_btc.data_ptr(), *prologue_ptrs(ptrs, hs[0], wp), B, C,
                                   T, stream), "resunit_tm_prologue")
    launches += 1
    acc, acc_f32 = x_btc.data_ptr(), 0
    for i, d in enumerate(dils):
        w7 = wp + i * 8 * C * C * es
        _, b7, _, b1, a1, a2 = ptrs[i]
        _check(lib.resunit_tm_conv7(hs[i % 2], w7, b7, a1, a2, h2, B, C, T, d, 1, *tile,
                                    stream), "resunit_tm_conv7")
        launches += 1
        last = i == n - 1
        # the last unit: the trailing snake, x's dtype; the others: the next
        # unit's operand and the fp32 carry
        post_i, a1_next, hs_next = ((_ptr(post), None, None) if last
                                    else (None, ptrs[i + 1][4], hs[(i + 1) % 2]))
        dst = out.data_ptr() if last else carry.data_ptr() + (i % 2) * btc * 4
        _check(lib.resunit_tm_conv1(acc, acc_f32, h2, w7 + 7 * C * C * es, b1, post_i,
                                    a1_next, hs_next, dst, int(not last), B, C, T, 1,
                                    *tile, stream), "resunit_tm_conv1")
        launches += 1
        acc, acc_f32 = dst, 1
    return out


def _stack_tm_fp32(lib, units: Sequence[ResUnit], x_btc: torch.Tensor, dils: tuple,
                   post_alpha: Optional[torch.Tensor], stream: int) -> torch.Tensor:
    """The fp32 launches of one stack, two per unit, all [B, T, C] and the
    carry fp32 throughout: unit 0's k=7 launch snakes x on the way in; each
    k=1 launch but the last also writes the next unit's snaked operand hs,
    which the next k=7 launch reads as it is."""
    global launches
    B, T, C = x_btc.shape
    n = len(units)
    tile = pick_ffma_tile(C, T, B)
    kept, ptrs = stack_ptrs(units)      # kept alive until the launches are queued
    post = _f32(post_alpha) if post_alpha is not None else None
    hs = torch.empty_like(x_btc) if n > 1 else None
    acc = x_btc
    for i, d in enumerate(dils):
        w7, b7, w1, b1, a1, a2 = ptrs[i]
        h2 = torch.empty_like(x_btc)
        src, a1_in = (x_btc.data_ptr(), a1) if i == 0 else (hs.data_ptr(), None)
        _check(lib.resunit_tm_conv7(src, w7, b7, a1_in, a2, h2.data_ptr(), B, C, T, d, 0,
                                    *tile, stream), "resunit_tm_conv7")
        launches += 1
        last = i == n - 1
        post_i, a1_next, hs_next = ((_ptr(post), None, None) if last
                                    else (None, ptrs[i + 1][4], hs.data_ptr()))
        out = torch.empty_like(x_btc)
        _check(lib.resunit_tm_conv1(acc.data_ptr(), 1, h2.data_ptr(), w1, b1, post_i,
                                    a1_next, hs_next, out.data_ptr(), 1, B, C, T, 0, *tile,
                                    stream), "resunit_tm_conv1")
        launches += 1
        acc = out
    return acc


def resunit_stack_tm(units: Sequence[ResUnit], x_btc: torch.Tensor,
                     dilations: Sequence[int] = DILATIONS,
                     post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stack of residual units over time-major x [B, T, C], then the optional
    trailing snake ``post_alpha`` [C]. CUDA tensors go through the kernel
    (fp32 or bf16, contiguous, on the same device as the weights); CPU
    tensors through ``resunit_stack_tm_ref``."""
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
    refuse_autograd("resunit_stack_tm", units, x_btc, post_alpha)

    lib = _lib()
    stream = torch.cuda.current_stream(x_btc.device).cuda_stream
    with torch.no_grad():
        if x_btc.dtype == torch.bfloat16:
            return _stack_tm_bf16(lib, units, x_btc, dils, post_alpha, stream)
        return _stack_tm_fp32(lib, units, x_btc, dils, post_alpha, stream)
