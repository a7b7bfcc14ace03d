"""Time-major ``[B, T, C]`` conv primitives of the DAC backbone.

Port of the JAX package's ``ops/timeconv.py``. Every conv is a matrix product
over the channel axis, which is contiguous in this layout:

- ``conv_tm``: stride-1 SAME k-tap dilated conv, one product per tap,
  ``sum_j x[t + (j - (k-1)/2) d] @ W_j``;
- ``down_tm``: the strided down-conv (k = 2r, stride r, padding ceil(r/2)) as
  one product over consecutive frame pairs of the padded input (the
  polyphase fold; needs r | T);
- ``up_tm``: the transposed up-conv (k = 2r, stride r) as one product over
  consecutive input pairs, then depth-to-space and the torch crop
  (padding ceil(r/2), output_padding r % 2), which gives exactly T * r.

The weights are the port's modules in PyTorch's layouts (``nn.Conv1d.weight``
``[C_out, C_in, k]``, ``nn.ConvTranspose1d.weight`` ``[C_in, C_out, k]``).
Products take their operands in x's dtype and are widened to fp32 before the
taps are summed and the bias added; the result is cast back to x's dtype.
In fp32 they are true fp32 as long as TF32 is off, as ``eval/serving.py``
sets it. These are plain ``torch.matmul`` products, as the JAX package left
them to XLA outside any kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resunit import ResUnit


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, I] @ [I, O] -> [B, T, O] in fp32 (operands in x's dtype)."""
    return torch.matmul(x, w.to(x.dtype)).float()


def _bias(y: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (y + b.float()).to(dtype)


def snake_tm(alpha: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x + sin^2(a x) / (a + 1e-9) with channels last, computed in fp32."""
    a = alpha.float()
    xf = x.float()
    return (xf + torch.sin(a * xf) ** 2 / (a + 1e-9)).to(x.dtype)


def conv_tm(m: nn.Conv1d, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """SAME k-tap conv, x [B, T, C_in] -> [B, T, C_out]."""
    k = m.weight.shape[-1]
    wt = m.weight.permute(2, 1, 0)                       # [k, I, O]
    T = x.shape[1]
    if k == 1:
        acc = _dot(x, wt[0])
    else:
        pad = dilation * (k - 1) // 2
        xp = F.pad(x, (0, 0, pad, pad))
        acc = _dot(xp[:, :T], wt[0])
        for j in range(1, k):
            acc = acc + _dot(xp[:, j * dilation:j * dilation + T], wt[j])
    return _bias(acc, m.bias, x.dtype)


def down_tm(m: nn.Conv1d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Strided down-conv as one product: x [B, T, C_in] -> [B, T / r, C_out]."""
    c_out, c_in, k = m.weight.shape
    r = stride
    if k != 2 * r:
        raise ValueError(f"down_tm requires k == 2*stride, got {k}, {r}")
    B, T, _ = x.shape
    t_out = T // r
    p0 = (r + 1) // 2
    xp = F.pad(x, (0, 0, p0, r - p0))                    # (t_out + 1) * r
    frames = xp.reshape(B, t_out + 1, r * c_in)
    z = torch.cat([frames[:, :-1], frames[:, 1:]], dim=-1)
    w2 = m.weight.permute(2, 1, 0).reshape(2 * r * c_in, c_out)
    return _bias(_dot(z, w2), m.bias, x.dtype)


def up_tm(m: nn.ConvTranspose1d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Transposed up-conv as one product: x [B, T, C_in] -> [B, T * r, C_out].
    Output sample t0 * r + j is x[t0 - 1] . w[:, :, j + r] + x[t0] . w[:, :, j]."""
    c_in, c_out, k = m.weight.shape
    r = stride
    if k != 2 * r:
        raise ValueError(f"up_tm requires k == 2*stride, got {k}, {r}")
    B, T, _ = x.shape
    pad, op = (r + 1) // 2, r % 2
    xp = F.pad(x, (0, 0, 1, 1))
    pairs = torch.cat([xp[:, :-1], xp[:, 1:]], dim=-1)  # [B, T + 1, 2 C_in]
    wt = m.weight.permute(2, 0, 1)                       # [2r, I, O]
    # column (j, o) = j * C_out + o; rows 0..C_in-1 multiply x[t0 - 1] (taps
    # j + r), rows C_in..2 C_in - 1 multiply x[t0] (taps j)
    wp = torch.cat([wt[r:].transpose(0, 1).reshape(c_in, r * c_out),
                    wt[:r].transpose(0, 1).reshape(c_in, r * c_out)], dim=0)
    y = _dot(pairs, wp).reshape(B, (T + 1) * r, c_out)
    y = y[:, pad:(T + 1) * r - (pad - op)]               # torch crop -> T * r
    return _bias(y, m.bias, x.dtype)


def resunit_tm(u: ResUnit, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """One residual unit, time-major: snake, k7 dilated conv, snake, k1 conv,
    residual add in x's dtype."""
    y = snake_tm(u.snake1.alpha, x)
    y = conv_tm(u.conv1, y, dilation=dilation)
    y = snake_tm(u.snake2.alpha, y)
    y = conv_tm(u.conv2, y)
    return x + y
