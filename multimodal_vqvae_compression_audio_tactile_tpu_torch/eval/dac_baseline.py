"""Rate-scalable backbone-codec baseline evaluation (the "DAC-24k" rows).

Port of the JAX package's ``eval/dac_baseline.py``, with its row schema: for
each n_q, every file, scaled by max |tactile| and resampled to 24 kHz, is
encoded and decoded through the backbone's first n_q books, resampled back,
xcorr-aligned at its own rate and scored by global-peak PSNR and ST-SIM at
24 kHz; kbps = tps * n_q * log2(bins) / 1000, the compression ratio against
the 48 kbps PCM baseline, and the latency per n_q. The forwards run batched
(``eval/prepared.py``) in true fp32 on ``device`` (``None``: the card);
latency is timed on the bf16 path, every stack through K1, unless a
pre-measured map gives it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import DacConfig, EvalConfig
from ..data.pairs import Pair
from ..dsp.resample import resample
from ..models.dac import DAC, decode, encode, encode_quantized
from . import metrics as M
from .latency import buffer_delay_ms, latency_row, measure_codec_latency_stats, row_delays
from .prepared import equal_length_batches, prepare_pairs
from .serving import resolve_device


def probe_tokens_per_sec(m: DAC, cfg: DacConfig) -> float:
    """Tokens of a 1 s encode, by a forward on zeros."""
    x = torch.zeros(1, 1, cfg.sample_rate, device=next(m.parameters()).device)
    return float(encode(m, cfg, x).shape[-1])


def measure_latency(m: DAC, cfg: DacConfig, n_q: int, ecfg: EvalConfig = EvalConfig(),
                    device=None) -> dict:
    """One latency-map entry of the backbone at ``n_q`` books
    (``eval/latency.py::latency_row``): ``encode_quantized`` and ``decode`` of
    a 1 s signal at batch 1 in bf16."""
    enc, dec = measure_codec_latency_stats(
        lambda a, t: encode_quantized(m, cfg, t.to(torch.bfloat16), n_quantizers=n_q)[0],
        lambda z: decode(m, cfg, z), sr_native=cfg.sample_rate,
        warmup=ecfg.latency_warmup, repeats=ecfg.latency_repeats, device=device)
    return latency_row(enc, dec)


def eval_backbone_codec(
    m: DAC,
    cfg: DacConfig,
    pairs: Sequence[Pair],
    peak_global: float,
    ecfg: EvalConfig = EvalConfig(),
    n_q_list: Optional[Sequence[int]] = None,
    latency_map: Optional[dict] = None,
    prepared: Optional[list] = None,
    forward_batch: int = 16,
    log=print,
    device=None,
) -> dict:
    """-> {n_q: row}. latency_map: {str(n_q): latency-map entry}
    (``scripts/measure_latencies.py``), measured here where absent.
    ``prepared``: pairs loaded once, shared across depths and evaluators."""
    dev = resolve_device(device)
    m = m.to(dev).eval()
    n_q_list = list(n_q_list or ecfg.dac_nq_list)
    if prepared is None:
        prepared = prepare_pairs(pairs, cfg.sample_rate, log=log)
    tps = probe_tokens_per_sec(m, cfg)
    bits_per_code = math.log2(cfg.codebook_size)
    buf_ms = buffer_delay_ms(tps)

    out = {}
    for n_q in n_q_list:
        log(f"[backbone] n_q={n_q}")
        lat = (latency_map or {}).get(str(n_q))
        if lat is None:
            lat = measure_latency(m, cfg, n_q, ecfg, dev)
        st_vals, ps_vals = [], []
        for idxs, _A, T in equal_length_batches(prepared, forward_batch):
            zq, _ = encode_quantized(m, cfg, torch.from_numpy(T).to(dev), n_quantizers=n_q)
            Y = decode(m, cfg, zq).cpu().numpy()
            for j, i in enumerate(idxs):
                p = prepared[i]
                est = np.asarray(resample(Y[j], cfg.sample_rate, p.sr_t)) * p.scale
                psnr, r_a, e_a = M.align_and_psnr_raw(p.t_raw, est, peak_global,
                                                      ecfg.max_align_shift)
                ps_vals.append(psnr)
                r24 = np.asarray(resample(r_a, p.sr_t, ecfg.eval_sr))
                e24 = np.asarray(resample(e_a, p.sr_t, ecfg.eval_sr))
                st_vals.append(M.stsim_batch(r24[None], e24[None])[0])

        st_m, st_ci = M.mean_ci95(st_vals)
        ps_m, ps_ci = M.mean_ci95(ps_vals)
        kbps = tps * n_q * bits_per_code / 1000.0
        out[int(n_q)] = {
            "stsim_mean": st_m, "stsim_ci95": st_ci,
            "psnr_mean": ps_m, "psnr_ci95": ps_ci,
            "kbps": kbps,
            "compression_ratio": ecfg.pcm_kbps_baseline / kbps if kbps else None,
            "n": len(ps_vals), "tps": tps, "bins": cfg.codebook_size,
            **row_delays(lat),
            "buffer_delay_ms": buf_ms,
        }
    return out
