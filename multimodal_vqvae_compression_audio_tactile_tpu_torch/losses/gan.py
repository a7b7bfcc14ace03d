"""Adversarial losses of backbone pretraining (the DAC-family GAN recipe).

The JAX package's ``losses/gan.py``: multi-period discriminators (HiFi-GAN's
MPD, one 2D conv stack per period over the waveform folded to
``[B, 1, T / p, p]``) and multi-scale STFT discriminators (one 2D conv stack
per FFT size over the complex spectrogram as two channels), hinge or
least-squares adversarial terms and relative L1 feature matching over every
intermediate map.

The modules keep the JAX tree's names (``mpd[i].layers[j].{w, b}``,
``mpd[i].post``, ``mstftd[i].{pre, mid[j], tail, post}``), with conv weights
in OIHW, PyTorch's layout and the JAX package's. A conv pads as JAX's
``padding="SAME"`` does, which with a stride pads less on the low side than
on the high one (``same_pads``): PyTorch's ``padding="same"`` takes no
stride. Everything runs in fp32, on a card without TF32 (``fp32_exact``),
the convs as cuDNN ``F.conv2d`` calls.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import GanConfig
from ..core.precision import fp32_exact
from ..dsp.stft import reflect_pad_right, stft_complex
from ..parallel.mesh import batch_mean

MPD_CHANNELS = (32, 128, 512, 1024)
MSTFT_CHANNELS = 32


class Conv2d(nn.Module):
    """One conv's leaves as the JAX tree holds them: w [C_out, C_in, kh, kw], b [C_out]."""

    def __init__(self, c_in: int, c_out: int, k: Tuple[int, int]):
        super().__init__()
        self.w = nn.Parameter(torch.empty(c_out, c_in, *k))
        self.b = nn.Parameter(torch.zeros(c_out))


def same_pads(size: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    """(low, high) padding of one axis under JAX's ``padding="SAME"``: the
    output has ceil(size / stride) samples, and the low side gets the
    smaller half of the padding."""
    total = max((math.ceil(size / stride) - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Conv2d, x: torch.Tensor, stride: Tuple[int, int] = (1, 1),
           dilation: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    kh, kw = p.w.shape[-2:]
    h_lo, h_hi = same_pads(x.shape[-2], kh, stride[0], dilation[0])
    w_lo, w_hi = same_pads(x.shape[-1], kw, stride[1], dilation[1])
    x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
    return F.conv2d(x, p.w.to(x.dtype), p.b.to(x.dtype), stride=stride, dilation=dilation)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class MPD(nn.Module):
    """One period's discriminator: four (5, 1) convs of stride (3, 1), then a
    (3, 1) conv to one channel."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 1
        for c_out in MPD_CHANNELS:
            layers.append(Conv2d(c_in, c_out, (5, 1)))
            c_in = c_out
        self.layers = nn.ModuleList(layers)
        self.post = Conv2d(c_in, 1, (3, 1))

    def forward(self, x: torch.Tensor, period: int):
        """x [B, 1, T] -> (logits [B, 1, T', p], feature maps)."""
        B, C, T = x.shape
        pad = (-T) % period
        if pad:
            x = reflect_pad_right(x, pad)
        y = x.reshape(B, C, (T + pad) // period, period)
        feats = []
        for layer in self.layers:
            y = _lrelu(conv2d(layer, y, stride=(3, 1)))
            feats.append(y)
        y = conv2d(self.post, y)
        feats.append(y)
        return y, feats


class MSTFTD(nn.Module):
    """One FFT size's discriminator over [real, imag] of the STFT."""

    def __init__(self):
        super().__init__()
        c = MSTFT_CHANNELS
        self.pre = Conv2d(2, c, (3, 9))
        self.mid = nn.ModuleList(Conv2d(c, c, (3, 9)) for _ in range(3))
        self.tail = Conv2d(c, c, (3, 3))
        self.post = Conv2d(c, 1, (3, 3))

    def forward(self, x: torch.Tensor, n_fft: int):
        """x [B, 1, T] -> (logits, feature maps)."""
        spec = stft_complex(x[:, 0, :].float(), n_fft=n_fft, hop=n_fft // 4)  # [B, F, T']
        y = torch.stack([spec.real, spec.imag], dim=1).to(x.dtype)
        feats = []
        y = _lrelu(conv2d(self.pre, y))
        feats.append(y)
        for i, layer in enumerate(self.mid):
            y = _lrelu(conv2d(layer, y, stride=(1, 2), dilation=(2 ** i, 1)))
            feats.append(y)
        y = _lrelu(conv2d(self.tail, y))
        feats.append(y)
        y = conv2d(self.post, y)
        feats.append(y)
        return y, feats


class Discriminators(nn.Module):
    """Every discriminator of a ``GanConfig``: ``mpd`` (one per period) and
    ``mstftd`` (one per FFT size)."""

    def __init__(self, gcfg: GanConfig):
        super().__init__()
        self.mpd = nn.ModuleList(MPD() for _ in gcfg.periods)
        self.mstftd = nn.ModuleList(MSTFTD() for _ in gcfg.fft_sizes)


@torch.no_grad()
def disc_init(gcfg: GanConfig, gen: torch.Generator) -> Discriminators:
    """Discriminators with the JAX package's distribution: every weight and
    bias U(+-1/sqrt(fan_in)), fan_in = C_in kh kw, drawn from ``gen``."""
    d = Discriminators(gcfg)
    for mod in d.modules():
        if isinstance(mod, Conv2d):
            bound = 1.0 / math.sqrt(math.prod(mod.w.shape[1:]))
            mod.w.uniform_(-bound, bound, generator=gen)
            mod.b.uniform_(-bound, bound, generator=gen)
    return d


def disc_apply(d: Discriminators, gcfg: GanConfig, x: torch.Tensor):
    """x [B, 1, T] -> (list of logits, list of per-discriminator feature
    lists), MPDs first."""
    logits, feats = [], []
    with fp32_exact(x.device.type == "cuda"):
        for m, period in zip(d.mpd, gcfg.periods):
            y, f = m(x, period)
            logits.append(y)
            feats.append(f)
        for m, n_fft in zip(d.mstftd, gcfg.fft_sizes):
            y, f = m(x, n_fft)
            logits.append(y)
            feats.append(f)
    return logits, feats


def _mean_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x.float())


def disc_loss(real_logits: Sequence[torch.Tensor], fake_logits: Sequence[torch.Tensor],
              kind: str = "hinge") -> torch.Tensor:
    """The discriminators' objective, averaged over them."""
    total = real_logits[0].new_zeros((), dtype=torch.float32)
    for r, f in zip(real_logits, fake_logits):
        if kind == "hinge":
            total = total + _mean_f32(F.relu(1.0 - r)) + _mean_f32(F.relu(1.0 + f))
        else:
            total = total + _mean_f32((1.0 - r) ** 2) + _mean_f32(f ** 2)
    return total / len(real_logits)


def gen_adv_loss(fake_logits: Sequence[torch.Tensor], kind: str = "hinge") -> torch.Tensor:
    """The generator's adversarial objective, averaged over the discriminators."""
    total = fake_logits[0].new_zeros((), dtype=torch.float32)
    for f in fake_logits:
        total = total + (-_mean_f32(f) if kind == "hinge" else _mean_f32((1.0 - f) ** 2))
    return total / len(fake_logits)


def feature_matching_loss(real_feats: List[List[torch.Tensor]],
                          fake_feats: List[List[torch.Tensor]]) -> torch.Tensor:
    """Mean over every map of L1(real, fake) / (mean |real| + 1e-6), both
    means over the global batch inside ``parallel/mesh.py::batch_scope``."""
    total, count = None, 0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            r32, f32 = r.float(), f.float()
            term = (batch_mean(torch.mean(torch.abs(r32 - f32)))
                    / (batch_mean(torch.mean(torch.abs(r32))) + 1e-6))
            total = term if total is None else total + term
            count += 1
    return total / max(count, 1)


def gan_losses(d: Discriminators, gcfg: GanConfig, real: torch.Tensor,
               fake: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The generator's terms (adv, feature matching). The real signal is
    detached; the caller takes the gradient toward the generator only
    (``torch.autograd.grad`` over its leaves), so no discriminator leaf
    accumulates one."""
    real_logits, real_feats = disc_apply(d, gcfg, real.detach())
    fake_logits, fake_feats = disc_apply(d, gcfg, fake)
    return gen_adv_loss(fake_logits, gcfg.loss_kind), feature_matching_loss(real_feats,
                                                                             fake_feats)
