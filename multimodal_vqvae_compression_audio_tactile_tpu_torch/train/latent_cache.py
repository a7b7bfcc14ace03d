"""Device-resident frozen-backbone latent cache for head training.

Port of the JAX package's ``train/latent_cache.py``. The codec head (and the
PLC head) train against frozen backbones, so every step of every run of a
sweep would encode the same corpus again. This module runs the encoders
once over a corpus and keeps the full-length latents on the device (about
1.2 GB fp32 for 1000 two-second pairs), serving token-aligned random crops
from there:

    cache = build_latent_cache(backbones, cfg, batches)
    qa, zt, tc = gather_crops(cache, idx, tok0, seg_tok, hop)

A cached step then runs only the AR roll (or the PLC predictor) and the
tactile decoder, whose output the loss compares with the waveform. Crops lie
on the token grid; the encoders' receptive field reaches past a token's 320
samples, so crops keep ``EDGE_TOKENS`` away from the file edges.

The crop plans draw from ``np.random.default_rng((seed, epoch))`` exactly as
the JAX package's, so both packages train on the same crops, and
``save_cache``/``load_cache`` use its ``.npz`` keys (``qa``, ``zt``, ``tc``),
so a cache file moves between the packages. ``build_latent_cache`` runs the
frozen encoders in fp32 under ``no_grad``: on the card through the kernel
K1 (8 stacks a batch: 48 launches).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import CodecConfig
from ..core.precision import fp32_exact
from ..eval.serving import resolve_device
from ..models import allpred_ar

# tokens kept clear of each file edge when offsets are drawn: tokens near a
# file edge differ from what a cropped waveform would give
EDGE_TOKENS = 2


class LatentCache(NamedTuple):
    qa: torch.Tensor   # [N, C, T_tok] quantized audio latents
    zt: torch.Tensor   # [N, C, T_tok] tactile teacher latents
    tc: torch.Tensor   # [N, 1, T_tok * hop] tactile waveforms (the loss target)

    def to(self, device) -> "LatentCache":
        return LatentCache(*(t.to(device) for t in self))


def build_latent_cache(backbones: dict, cfg: CodecConfig,
                       batches: Iterable, log=None, device=None) -> LatentCache:
    """The latents of an iterable of (a, tc) waveform batches [B, 1, T] (all
    of one T), on ``device`` (None: the card). The backbones
    ({"audio": DAC, "tactile": DAC}) run where the cache lives, frozen."""
    dev = resolve_device(device)
    audio = backbones["audio"].to(dev).requires_grad_(False)
    tactile = backbones["tactile"].to(dev).requires_grad_(False)
    m = allpred_ar.codec_of(audio, tactile, None, cfg)
    hop = cfg.dac.hop
    qas, zts, tcs = [], [], []
    n = 0
    with torch.no_grad(), fp32_exact(dev.type == "cuda"):
        for a, tc in batches:
            a = torch.as_tensor(np.asarray(a, np.float32)).to(dev)
            tc = torch.as_tensor(np.asarray(tc, np.float32)).to(dev)
            qa, zt = allpred_ar.backbone_latents(m, a, tc, cfg)
            t_tok = min(qa.shape[-1], zt.shape[-1], tc.shape[-1] // hop)
            qas.append(qa[..., :t_tok])
            zts.append(zt[..., :t_tok])
            tcs.append(tc[..., :t_tok * hop])
            n += a.shape[0]
            if log is not None:
                log(f"  [latent-cache] {n} pairs")
    return LatentCache(torch.cat(qas), torch.cat(zts), torch.cat(tcs))


def save_cache(path: str, cache: LatentCache) -> None:
    """Write the cache as ``.npz`` (``qa``, ``zt``, ``tc``), the JAX
    package's format. The cache depends on the backbone weights and on the
    corpus; the caller deletes the file when either changes."""
    np.savez(path, **{k: t.detach().cpu().numpy() for k, t in zip(cache._fields, cache)})


def load_cache(path: str, device=None) -> LatentCache:
    """A ``save_cache`` file (from either package) on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return LatentCache(*(torch.from_numpy(np.asarray(z[k])).to(dev)
                             for k in LatentCache._fields))


def gather_crops(cache: LatentCache, idx: torch.Tensor, tok0: torch.Tensor,
                 seg_tok: int, hop: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-aligned crops (qa [B, C, seg_tok], zt [B, C, seg_tok], tc [B, 1,
    seg_tok * hop]) of pair rows ``idx`` [B] at token offsets ``tok0`` [B]:
    one indexed gather each, on the cache's device, with no host sync. The
    offsets must lie in the crop range (``_crop_range``)."""
    dev = cache.qa.device
    idx, tok0 = idx.to(dev, torch.int64), tok0.to(dev, torch.int64)
    C = cache.qa.shape[1]
    t = tok0[:, None, None] + torch.arange(seg_tok, device=dev)[None, None, :]
    rows, chans = idx[:, None, None], torch.arange(C, device=dev)[None, :, None]
    s = (tok0 * hop)[:, None] + torch.arange(seg_tok * hop, device=dev)[None, :]
    return cache.qa[rows, chans, t], cache.zt[rows, chans, t], \
        cache.tc[idx[:, None], 0, s][:, None, :]


def _crop_range(t_tok_total: int, seg_tok: int) -> Tuple[int, int]:
    """Valid [lo, hi) token-offset range for a ``seg_tok`` crop.

    Raises when the cache is shorter than a segment, rather than clamping
    (clamped crops would be shifted or duplicated). When the files are
    barely longer than a segment there is no room for the ``EDGE_TOKENS``
    margin; a whole-file crop crops no waveform and so has no edge effect,
    and the whole offset range is used."""
    if t_tok_total < seg_tok:
        raise ValueError(f"cache too short: t_tok_total={t_tok_total} < seg_tok={seg_tok}")
    if t_tok_total < seg_tok + 2 * EDGE_TOKENS:
        return 0, t_tok_total - seg_tok + 1
    # hi is exclusive; an exactly minimal cache has the one offset EDGE_TOKENS
    return EDGE_TOKENS, max(EDGE_TOKENS + 1, t_tok_total - seg_tok - EDGE_TOKENS)


def crop_indices(n_pairs: int, t_tok_total: int, seg_tok: int, batch: int,
                 steps: int, seed: int, epoch: int):
    """Deterministic (idx [B], tok0 [B]) int32 numpy pairs per step for one
    epoch."""
    rng = np.random.default_rng((seed, epoch))
    lo, hi = _crop_range(t_tok_total, seg_tok)
    for _ in range(steps):
        idx = rng.integers(0, n_pairs, size=batch)
        tok0 = rng.integers(lo, hi, size=batch)
        yield idx.astype(np.int32), tok0.astype(np.int32)


def crop_index_arrays(rows: Sequence[int], t_tok_total: int, seg_tok: int,
                      batch: int, steps: int, seed: int, epoch: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """A whole epoch's crop plan as two [steps, batch] int32 arrays (pair
    rows taken from ``rows``, token offsets), made on the host and sent to
    the device once an epoch (``train/loop.py::make_cached_epoch_fns``)."""
    rows = np.asarray(rows, np.int32)
    rng = np.random.default_rng((seed, epoch))
    lo, hi = _crop_range(t_tok_total, seg_tok)
    idx = rng.integers(0, rows.shape[0], size=(steps, batch))
    tok0 = rng.integers(lo, hi, size=(steps, batch)).astype(np.int32)
    return rows[idx], tok0


def cached_batches(cache: LatentCache, cfg: CodecConfig, batch: int, steps: int,
                   seg_tok: int, seed: int, epoch: int,
                   indices: Optional[Sequence[int]] = None):
    """Yield (qa, zt, tc) crop batches from the cache, on its device: the
    ``crop_indices`` plan, sent to the device once. ``indices``: the pair
    rows to draw from (a train/val split of one cache); all rows when
    None."""
    dev = cache.qa.device
    rows = np.asarray(indices, np.int32) if indices is not None else None
    n = rows.shape[0] if rows is not None else cache.qa.shape[0]
    plan = list(crop_indices(n, cache.qa.shape[-1], seg_tok, batch, steps, seed, epoch))
    if not plan:
        return
    idxs = np.stack([rows[i] if rows is not None else i for i, _ in plan])
    idxs, tok0s = (torch.from_numpy(x).to(dev) for x in (idxs, np.stack([t for _, t in plan])))
    for s in range(len(plan)):
        yield gather_crops(cache, idxs[s], tok0s[s], seg_tok, cfg.dac.hop)
