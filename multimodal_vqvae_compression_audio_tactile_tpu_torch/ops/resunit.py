"""Residual-unit stack (K1): the CUDA kernel's wrapper and its plain version.

A residual unit is snake -> dilated k=7 conv -> snake -> k=1 conv -> residual
add (``models/dac.py::_resunit_apply`` in the JAX package); a stack is up to
three units at dilations 1/3/9, optionally followed by the block's trailing
snake. ``resunit_stack`` sends a CUDA tensor through ``csrc/resunit_stack.cu``
(fp32 on FFMA through the product core ``csrc/resunit_ffma.cuh`` that K3
shares, two launches per unit, with the tile of ``pick_ffma_tile`` and every
output summed in cuDNN's order, so bit-equal to the plain version; bf16 on
the tensor cores through the product core ``csrc/resunit_mma.cuh`` that K3
shares, two launches per unit and one prologue that snakes the first unit's
input and packs the stack's weights in bf16) and a CPU tensor through
``resunit_stack_ref``. It never sends a CUDA tensor to the plain version:
what the kernel does not take raises. The kernel has no backward (nor has the JAX package's, which trains
through XLA): a CUDA call that autograd would record raises too
(``refuse_autograd``), where the result would otherwise come back detached
and the gradient silently cut.
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
# (t_tile, co_tile) of the fp32 FFMA kernels (csrc/resunit_ffma.cuh), with
# the time steps a thread takes at a stride of the dilation: 4 warps sharing
# 64 channels' weights over 64 steps, or 32 channels over 128; 32 x 64 (4
# steps a thread, twice the threads) where 64 x 64 gives an SM fewer than
# two blocks; 64 x 32 where C is not a multiple of 32
FFMA_STEPS = {(64, 64): 8, (128, 32): 8, (32, 64): 4, (64, 32): 8}
FFMA_TILES = tuple(FFMA_STEPS)

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


def refuse_autograd(fn: str, units: Sequence[ResUnit], x: torch.Tensor,
                    post_alpha: Optional[torch.Tensor] = None) -> None:
    """Raise when autograd would record a call of the kernel ``fn``: grad
    mode on and x, a unit's weight or snake, or ``post_alpha`` requiring a
    gradient. The kernels have no backward; a caller that trains through a
    stack runs the plain version (``resunit_stack_ref``), one that does not
    calls under ``torch.no_grad()``."""
    if not torch.is_grad_enabled():
        return
    tensors = [x, post_alpha] + [p for u in units for p in u.parameters()]
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{fn}: the CUDA kernel has no backward, and autograd would record this "
            "call; run it under torch.no_grad(), or train through the plain version")


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


def pick_ffma_tile(C: int, T: int, B: int = 1) -> Tuple[int, int]:
    """The (t_tile, co_tile) of the fp32 FFMA kernels for [B, C, T] (or
    [B, T, C]): where C is a multiple of 64, 64 x 64 if its grid gives each
    of the card's ``SMS`` multiprocessors two blocks, else 32 x 64 (4 steps a
    thread, twice the warps); else 128 x 32 where C is a multiple of 32, so
    that no channel tile is part-empty, else 64 x 32. (Timed on the H100 at
    the stack shapes, 64 x 64 and 128 x 32 were within a few percent of each
    other where both give two blocks an SM.)"""
    if C % 64 == 0:
        return (64, 64) if _blocks(C, T, B, (64, 64)) >= 2 * SMS else (32, 64)
    return (128, 32) if C % 32 == 0 else (64, 32)


def launch_grid(C: int, T: int, B: int, dtype: torch.dtype,
                dil: int = 1) -> Tuple[int, int, int]:
    """The grid (t tiles, C_out tiles, batch) of a launch of a K1 or K3 stack
    at this shape and operand type: every bf16 launch's, and the fp32 k=7
    launch's at dilation ``dil`` (the k=1 launches' at 1). An fp32 thread
    takes ``FFMA_STEPS[tile]`` steps at a stride of d, d neighbouring threads
    d residues, so time is cut into d ceil(T / (steps d)) such runs."""
    if dtype == torch.bfloat16:
        tile = pick_tile(C, T, B)
        return (math.ceil(T / tile[0]), math.ceil(C / tile[1]), B)
    tile = pick_ffma_tile(C, T, B)
    steps = FFMA_STEPS[tile]
    runs = dil * math.ceil(T / (steps * dil))
    return (math.ceil(runs / (tile[0] // steps)), math.ceil(C / tile[1]), B)


# (library name, source under csrc/)
LIBRARY = ("resunit", "resunit_stack.cu")
_SIGNATURES = {
    "resunit_prologue": ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "resunit_conv7": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "resunit_conv1": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "resunit_smem_bytes": [ctypes.c_int] * 4,
    "resunit_ffma_smem_bytes": [ctypes.c_int] * 3,
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
    """(kept, pointers) of a stack's fp32 parameters for the kernels:
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


def _stack_fp32(lib, units: Sequence[ResUnit], x: torch.Tensor, dils: tuple,
                post_alpha: Optional[torch.Tensor], stream: int) -> torch.Tensor:
    """The fp32 launches of one stack, two per unit, all [B, C, T]: unit 0's
    k=7 launch snakes x on the way in; each k=1 launch but the last also
    writes the next unit's snaked operand hs, which the next k=7 launch reads
    as it is."""
    global launches
    B, C, T = x.shape
    n = len(units)
    tile = pick_ffma_tile(C, T, B)
    kept, ptrs = stack_ptrs(units)      # kept alive until the launches are queued
    post = _f32(post_alpha) if post_alpha is not None else None
    hs = torch.empty_like(x) if n > 1 else None
    cur = x
    for i, d in enumerate(dils):
        w7, b7, w1, b1, a1, a2 = ptrs[i]
        h2 = torch.empty_like(x)
        src, a1_in = (x.data_ptr(), a1) if i == 0 else (hs.data_ptr(), None)
        _check(lib.resunit_conv7(src, w7, b7, a1_in, a2, h2.data_ptr(), B, C, T, d, 0, *tile,
                                 stream), "resunit_conv7")
        launches += 1
        last = i == n - 1
        post_i, a1_next, hs_next = ((_ptr(post), None, None) if last
                                    else (None, ptrs[i + 1][4], hs.data_ptr()))
        out = torch.empty_like(x)
        _check(lib.resunit_conv1(cur.data_ptr(), h2.data_ptr(), w1, b1, post_i, a1_next,
                                 hs_next, out.data_ptr(), B, C, T, 0, *tile, stream),
               "resunit_conv1")
        launches += 1
        cur = out
    return cur


def resunit_stack(units: Sequence[ResUnit], x: torch.Tensor,
                  dilations: Sequence[int] = DILATIONS,
                  post_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stack of residual units over x [B, C, T], then the optional trailing
    snake ``post_alpha`` [C]. CUDA tensors go through the kernel (fp32 or
    bf16, contiguous, on the same device as the weights); CPU tensors through
    ``resunit_stack_ref``."""
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
    refuse_autograd("resunit_stack", units, x, post_alpha)

    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.no_grad():
        if x.dtype == torch.bfloat16:
            return _stack_bf16(lib, units, x, dils, post_alpha, stream)
        return _stack_fp32(lib, units, x, dils, post_alpha, stream)
