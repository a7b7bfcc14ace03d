"""Residual-unit stack (K1): the CUDA kernel's wrapper and its plain version.

A residual unit is snake -> dilated k=7 conv -> snake -> k=1 conv -> residual
add (``models/dac.py::_resunit_apply`` in the JAX package); a stack is up to
three units at dilations 1/3/9, optionally followed by the block's trailing
snake. ``resunit_stack`` sends a CUDA tensor through ``csrc/resunit_stack.cu``
(fp32 on FFMA, two launches per unit; bf16 on the tensor cores through the
product core ``csrc/resunit_mma.cuh`` that K3 shares, two launches per unit
and one prologue that snakes the first unit's input and packs the stack's
weights in bf16) and a CPU tensor through ``resunit_stack_ref``. It never
sends a CUDA tensor to the plain version: what the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import _build

DILATIONS = (1, 3, 9)
MAX_HALO_PER_UNIT = 27     # the kernel's shared-memory window: 3 * dilation <= 27
SMS = 132                  # streaming multiprocessors of an H100 SXM
# (t_tile, co_tile) of the bf16 tensor-core kernels (csrc/resunit_mma.cuh), in
# order of preference: a taller t tile stages each weight for more rows
TILES = ((128, 32), (64, 32), (32, 32))
FFMA_TILE = (64, 64)       # the fp32 kernels' [T x C_out] tile

# Kernel launches made by ``resunit_stack`` (``stack_launches`` a stack);
# reset it to 0 before a run to count that run's launches.
launches = 0


def stack_launches(n_units: int, dtype: torch.dtype) -> int:
    """Launches of one K1 or K3 stack of ``n_units``: two per unit, and in
    bf16 one prologue."""
    return 2 * n_units + (dtype == torch.bfloat16)


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


def _blocks(C: int, T: int, B: int, tile: Tuple[int, int]) -> int:
    return math.ceil(T / tile[0]) * math.ceil(C / tile[1]) * B


def pick_tile(C: int, T: int, B: int = 1) -> Tuple[int, int]:
    """The (t_tile, co_tile) of the bf16 tensor-core kernels for [B, C, T]
    (or [B, T, C]): the first of ``TILES`` whose grid fills the card's
    ``SMS`` multiprocessors, the smallest where none does."""
    for tile in TILES:
        if _blocks(C, T, B, tile) >= SMS:
            return tile
    return TILES[-1]


def launch_grid(C: int, T: int, B: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The grid (t tiles, C_out tiles, batch) of each launch of a K1 or K3
    stack at this shape and operand type."""
    tile = pick_tile(C, T, B) if dtype == torch.bfloat16 else FFMA_TILE
    return (math.ceil(T / tile[0]), math.ceil(C / tile[1]), B)


# (library name, source under csrc/)
LIBRARY = ("resunit", "resunit_stack.cu")
_SIGNATURES = {
    "resunit_prologue": ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "resunit_conv7": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "resunit_conv1": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "resunit_smem_bytes": [ctypes.c_int] * 4,
}


def _lib() -> ctypes.CDLL:
    return _build.load(*LIBRARY, _SIGNATURES)


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous fp32 tensor; t itself when it is one (the common
    case, kept free of dispatcher calls: a stack call makes some thirty)."""
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return t.detach().float().contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stack_ptrs(units: Sequence[ResUnit]) -> tuple:
    """(kept, pointers) of a stack's fp32 parameters for the bf16 kernels:
    ``pointers[u]`` = (w7, b7, w1, b1, a1, a2) of unit u; ``kept`` holds any
    converted copies, which must outlive the launches."""
    kept, ptrs = [], []
    for u in units:
        ts = [_f32(p) for p in (u.conv1.weight, u.conv1.bias, u.conv2.weight,
                                u.conv2.bias, u.snake1.alpha, u.snake2.alpha)]
        kept += ts
        ptrs.append(tuple(t.data_ptr() for t in ts))
    return kept, ptrs


def prologue_ptrs(ptrs: list, hs: int, wp: int) -> tuple:
    """(a1, hs, w7_0..2, w1_0..2, n_units, wp) as the prologue takes them."""
    pad = (None,) * (3 - len(ptrs))
    return (ptrs[0][4], hs, *(p[0] for p in ptrs), *pad, *(p[2] for p in ptrs), *pad,
            len(ptrs), wp)


def _stack_bf16(lib, units: Sequence[ResUnit], x: torch.Tensor, dils: tuple,
                post_alpha: Optional[torch.Tensor], stream: int) -> torch.Tensor:
    """The bf16 launches of one stack: the prologue, then two per unit. The
    kernels pass time-major operands [B, T, C] between them (hs =
    bf16(snake_a1(x)) into each k=7 launch, h2 into each k=1 launch) and the
    units' outputs but the last in a ping-pong pair, all in one workspace."""
    global launches
    B, C, T = x.shape
    n, btc, es = len(units), B * T * C, x.element_size()
    tile = pick_tile(C, T, B)
    kept, ptrs = stack_ptrs(units)      # kept alive until the launches are queued
    post = _f32(post_alpha) if post_alpha is not None else None
    ws = x.new_empty(n * 8 * C * C + (3 + 2 * (n > 1)) * btc)
    wp = ws.data_ptr()
    hs = [wp + (n * 8 * C * C + k * btc) * es for k in range(2)]
    h2 = wp + (n * 8 * C * C + 2 * btc) * es
    mid = [wp + (n * 8 * C * C + (3 + k) * btc) * es for k in range(2)]
    out = torch.empty_like(x)
    _check(lib.resunit_prologue(x.data_ptr(), *prologue_ptrs(ptrs, hs[0], wp), B, C, T,
                                stream), "resunit_prologue")
    launches += 1
    cur = x.data_ptr()
    for i, d in enumerate(dils):
        w7 = wp + i * 8 * C * C * es
        _, b7, _, b1, a1, a2 = ptrs[i]
        _check(lib.resunit_conv7(hs[i % 2], w7, b7, a1, a2, h2, B, C, T, d, 1, *tile,
                                 stream), "resunit_conv7")
        launches += 1
        last = i == n - 1
        # the last unit: the trailing snake; the others: the next unit's operand
        post_i, a1_next, hs_next = ((_ptr(post), None, None) if last
                                    else (None, ptrs[i + 1][4], hs[(i + 1) % 2]))
        dst = out.data_ptr() if last else mid[i % 2]
        _check(lib.resunit_conv1(cur, h2, w7 + 7 * C * C * es, b1, post_i, a1_next, hs_next,
                                 dst, B, C, T, 1, *tile, stream), "resunit_conv1")
        launches += 1
        cur = dst
    return out


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
    for u in units:
        if (u.conv1.weight.shape != (C, C, 7) or u.conv2.weight.shape != (C, C, 1)
                or u.conv1.weight.device != x.device):
            raise ValueError("resunit_stack: unit weights do not match x")
    if post_alpha is not None and post_alpha.shape != (C,):
        raise ValueError("resunit_stack: post_alpha must be [C]")

    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.no_grad():
        if x.dtype == torch.bfloat16:
            return _stack_bf16(lib, units, x, dils, post_alpha, stream)
        for i, (u, d) in enumerate(zip(units, dils)):
            w7, w1 = _f32(u.conv1.weight), _f32(u.conv2.weight)
            b7, b1 = _f32(u.conv1.bias), _f32(u.conv2.bias)
            a1, a2 = _f32(u.snake1.alpha), _f32(u.snake2.alpha)
            h2 = torch.empty_like(x)
            _check(lib.resunit_conv7(x.data_ptr(), w7.data_ptr(), b7.data_ptr(),
                                     a1.data_ptr(), a2.data_ptr(), h2.data_ptr(),
                                     B, C, T, d, 0, 0, 0, stream), "resunit_conv7")
            launches += 1
            post = (_f32(post_alpha) if post_alpha is not None
                    and i == len(units) - 1 else None)
            out = torch.empty_like(x)
            _check(lib.resunit_conv1(x.data_ptr(), h2.data_ptr(), w1.data_ptr(),
                                     b1.data_ptr(), _ptr(post), None, None, out.data_ptr(),
                                     B, C, T, 0, 0, 0, stream), "resunit_conv1")
            launches += 1
            x = out
    return x
