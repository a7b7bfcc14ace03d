"""Packet-loss mask generators (a copy of the JAX package's ``plc/masks.py``:
the same ``numpy.random.Generator`` gives the same masks, bit for bit).

Fault injection is a first-class modeled feature of the reference: simulated packet
loss on latent tokens, either uniform packets
(reference: PLC/PLC1.py:326-347 — packets of ``packet_tok`` tokens each dropped with
probability ``p_loss``) or PLC-Challenge-style burst categories
(reference: PLC/PLC1_low_mid_high.py:355-414 — category sampled 0.52/0.32/0.16, burst
lengths 20-120/120-320/320-1000 ms, 1-2/1-3/1-4 bursts per second).

Masks are generated HOST-SIDE with ``numpy.random.Generator`` and fed to the
model as plain boolean inputs, the same structure the reference uses for its
deterministic per-file eval seeds (reference: PLC/PLC1_eval.py:588-590 — ``BASE_SEED + idx``;
PLC/PLC1_low_mid_high_eval.py:565 — ``BASE_SEED + cat_idx*100000 + f_idx``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.config import PLCConfig

CATEGORIES = ("low", "medium", "high")


def make_token_loss_mask(
    rng: np.random.Generator,
    batch_size: int,
    t_lat: int,
    packet_tok: int = 2,
    p_loss: float = 0.5,
) -> np.ndarray:
    """Uniform packet mask [B, T_lat] bool (True = token lost).

    Reference: PLC/PLC1.py:326-347 — note the reference only draws
    ``T_lat // packet_tok`` packets and zero-pads the remainder tokens, so a trailing
    partial packet is never dropped; preserved here.
    """
    if packet_tok <= 0 or t_lat <= 0:
        return np.zeros((batch_size, max(t_lat, 0)), bool)
    num_packets = max(1, t_lat // packet_tok)
    lost = rng.random((batch_size, num_packets)) < p_loss
    mask = np.repeat(lost, packet_tok, axis=1)
    if mask.shape[1] > t_lat:
        mask = mask[:, :t_lat]
    elif mask.shape[1] < t_lat:
        pad = np.zeros((batch_size, t_lat - mask.shape[1]), bool)
        mask = np.concatenate([mask, pad], axis=1)
    return mask


def sample_category(rng: np.random.Generator, cfg: PLCConfig = PLCConfig()) -> str:
    """Sample low/medium/high with probabilities 0.52/0.32/0.16
    (reference: PLC/PLC1_low_mid_high.py:355-363)."""
    r = rng.random()
    if r < cfg.cat_probs[0]:
        return "low"
    if r < cfg.cat_probs[0] + cfg.cat_probs[1]:
        return "medium"
    return "high"


def _burst_mask_one(
    rng: np.random.Generator,
    t_lat: int,
    tokens_per_sec: float,
    cat: str,
    cfg: PLCConfig,
) -> np.ndarray:
    ci = CATEGORIES.index(cat)
    min_ms, max_ms = cfg.cat_burst_ms[ci]
    nb_min, nb_max = cfg.cat_n_bursts[ci]
    min_tok = max(1, int(round(min_ms * tokens_per_sec / 1000.0)))
    max_tok = max(min_tok, int(round(max_ms * tokens_per_sec / 1000.0)))
    max_tok = min(max_tok, t_lat)
    mask = np.zeros(t_lat, bool)
    n_bursts = int(rng.integers(nb_min, nb_max + 1))
    for _ in range(n_bursts):
        L = int(rng.integers(min_tok, max_tok + 1))
        if L >= t_lat:
            mask[:] = True
            break
        s = int(rng.integers(0, max(0, t_lat - L) + 1))
        mask[s: s + L] = True
    return mask


def make_category_token_loss_mask(
    rng: np.random.Generator,
    batch_size: int,
    t_lat: int,
    tokens_per_sec: float,
    cfg: PLCConfig = PLCConfig(),
    category: Optional[str] = None,
) -> np.ndarray:
    """Category burst mask [B, T_lat] bool.

    category=None samples per example (training,
    reference: PLC/PLC1_low_mid_high.py:365-414); a fixed category reproduces the
    per-category eval (reference: PLC/PLC1_low_mid_high_eval.py:372-416).
    """
    if t_lat <= 0:
        return np.zeros((batch_size, 0), bool)
    out = np.zeros((batch_size, t_lat), bool)
    for b in range(batch_size):
        cat = category if category is not None else sample_category(rng, cfg)
        out[b] = _burst_mask_one(rng, t_lat, tokens_per_sec, cat, cfg)
    return out


def eval_mask_seed(base_seed: int, file_idx: int,
                   cat_idx: Optional[int] = None) -> int:
    """Deterministic per-file eval seeds.

    Uniform eval: BASE_SEED + idx (reference: PLC/PLC1_eval.py:588-590);
    category eval: BASE_SEED + cat_idx*100000 + f_idx
    (reference: PLC/PLC1_low_mid_high_eval.py:565).
    """
    if cat_idx is None:
        return base_seed + file_idx
    return base_seed + cat_idx * 100000 + file_idx


def mask_statistics(mask: np.ndarray) -> dict:
    """Diagnostics: loss rate, burst count/length distribution per example."""
    mask = np.asarray(mask, bool)
    rates = mask.mean(axis=-1)
    bursts = []
    for row in mask:
        d = np.diff(np.concatenate([[0], row.astype(np.int8), [0]]))
        starts = np.where(d == 1)[0]
        ends = np.where(d == -1)[0]
        bursts.append(list(ends - starts))
    return {
        "loss_rate_mean": float(rates.mean()),
        "bursts_per_example": [len(b) for b in bursts],
        "burst_lengths": [l for b in bursts for l in b],
    }
