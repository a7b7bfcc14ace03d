"""Proposed-codec sweep evaluation: discover the runs, rate and distortion
of each.

Port of the JAX package's ``eval/proposed.py``, with its row schema and both
PSNR protocols. Runs are the ``rvqB*_K*`` directories of a sweep, their
(books, embed) read from meta.json or the directory's name; each run's head
is read strictly onto the backbones, which the session loads and moves to
the device once. Per file: raw PSNR with the per-file tactile scale and
ST-SIM at 24 kHz (or the ``3k`` protocol), and the entropy-coded bytes of the
codes. The model's forwards run batched, in true fp32 (the JAX package's
HIGHEST precision) on ``device`` (``None``: the card); the metrics run on the
host. Latency is timed on the bf16 serving path (``StreamingCodec``'s calls,
as the JAX package times ``cfg.fast_serving()``), unless a pre-measured map
gives it (``scripts/measure_latencies.py``).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import convert
from ..core.config import CodecConfig, EvalConfig
from ..data.pairs import Pair
from ..dsp.resample import resample
from ..models import allpred_ar, dac
from ..utils import artifacts
from . import bitstream
from . import metrics as M
from .latency import buffer_delay_ms, latency_row, measure_codec_latency_stats, row_delays
from .prepared import equal_length_batches, prepare_pairs
from .serving import StreamingCodec, resolve_device


def measure_latency(modules: allpred_ar.CodecModules, books_use: int,
                    ecfg: EvalConfig = EvalConfig(), device=None) -> dict:
    """One latency-map entry of a codec (``eval/latency.py::latency_row``):
    encode and ``decode(z_run)`` of a 1 s signal at batch 1 on the bf16
    serving path."""
    sc = StreamingCodec(modules, batch=1, n_books_use=books_use, device=device)
    enc, dec = measure_codec_latency_stats(
        lambda a, t: sc.encode(a, t)[0], sc.decode, sr_native=sc.frame,
        warmup=ecfg.latency_warmup, repeats=ecfg.latency_repeats, device=sc.device)
    return latency_row(enc, dec)


def evaluate_proposed_model(
    modules: allpred_ar.CodecModules,
    pairs: Sequence[Pair],
    peak_global: float,
    books_use: Optional[int] = None,
    ecfg: EvalConfig = EvalConfig(),
    protocol: str = "raw",
    latency: Optional[dict] = None,
    prepared: Optional[list] = None,
    forward_batch: int = 16,
    device=None,
) -> dict:
    """One trained codec over the pairs -> its metric row.

    protocol="raw": global-peak PSNR at the original rate; "3k": align at
    24 kHz, downsample to 3 kHz, peak 1.0 (the two differ by ~10 dB on the
    same model; rows carry ``psnr_protocol``). ``prepared``: pairs loaded
    once (``eval/prepared.py``) and shared across runs. ``latency``: a
    latency-map entry; measured here when None."""
    dev = resolve_device(device)
    modules = modules.to(dev).eval()
    cfg = modules.cfg
    books_use = books_use or cfg.rvq.n_books
    sr24 = cfg.dac.sample_rate
    if prepared is None:
        prepared = prepare_pairs(pairs, sr24)
    if latency is None:
        latency = measure_latency(modules, books_use, ecfg, dev)

    st_vals, ps_vals = [], []
    total_bytes, total_sec = 0, 0.0
    for idxs, A, T in equal_length_batches(prepared, forward_batch):
        z_run, codes_b = allpred_ar.encode_latents(
            modules, torch.from_numpy(A).to(dev), torch.from_numpy(T).to(dev),
            n_books_use=books_use)
        Y = dac.decode(modules.tactile_dac, cfg.dac, z_run).cpu().numpy()
        codes_b = codes_b.cpu().numpy()
        L = A.shape[-1]
        for j, i in enumerate(idxs):
            p = prepared[i]
            y24 = Y[j]
            est = np.asarray(resample(y24 * p.scale, sr24, p.sr_t))
            # the real transmitter's accounting: entropy-coded bytes per file
            total_bytes += len(bitstream.pack_codes(codes_b[j], cfg.rvq.n_embed))
            total_sec += L / float(sr24)
            if protocol == "3k":
                t24_ref = p.t24[0] if ecfg.eval_sr == sr24 else np.asarray(
                    resample(p.t_raw / p.scale, p.sr_t, ecfg.eval_sr))[0]
                Lm = min(t24_ref.shape[-1], y24.shape[-1])
                ps_vals.append(M.psnr_3k_aligned_batch(
                    t24_ref[None, None, :Lm], y24[None, :, :Lm], eval_sr=ecfg.eval_sr,
                    orig_sr=ecfg.orig_tactile_sr, max_shift=ecfg.max_align_shift)[0])
                st_vals.append(M.stsim_batch(t24_ref[None, None, :Lm], y24[None, :, :Lm])[0])
            else:
                psnr, r_a, e_a = M.align_and_psnr_raw(p.t_raw, est, peak_global,
                                                      ecfg.max_align_shift)
                ps_vals.append(psnr)
                r24 = np.asarray(resample(r_a, p.sr_t, ecfg.eval_sr))
                e24 = np.asarray(resample(e_a, p.sr_t, ecfg.eval_sr))
                st_vals.append(M.stsim_batch(r24[None], e24[None])[0])

    st_m, st_ci = M.mean_ci95(st_vals)
    ps_m, ps_ci = M.mean_ci95(ps_vals)
    tps = cfg.dac.tokens_per_sec
    bits = math.log2(cfg.rvq.n_embed)
    kbps = tps * books_use * bits / 1000.0
    kbps_coded = (bitstream.empirical_kbps(total_bytes, total_sec)
                  if total_sec > 0 else float("nan"))
    return {
        "psnr_protocol": protocol,
        "books": books_use, "embed": cfg.rvq.n_embed,
        "bits_per_code": bits, "tps": tps, "kbps": kbps,
        # nominal kbps is the reference's rate model; entropy-coded is the
        # range coder's real rate
        "kbps_entropy_coded": kbps_coded,
        "compression_ratio": ecfg.pcm_kbps_baseline / kbps if kbps else None,
        "n": len(ps_vals),
        "stsim_mean": st_m, "stsim_ci95": st_ci,
        "psnr_mean": ps_m, "psnr_ci95": ps_ci,
        **row_delays(latency),
        "buffer_delay_ms": buffer_delay_ms(tps),
    }


def eval_proposed_runs(
    sweep_root: str,
    base_cfg: CodecConfig,
    backbones: dict,
    pairs: Sequence[Pair],
    peak_global: float,
    ecfg: EvalConfig = EvalConfig(),
    checkpoint_name: str = "best.msgpack",
    protocol: str = "raw",
    latency_map: Optional[dict] = None,
    prepared: Optional[list] = None,
    log: Callable = print,
    device=None,
) -> list:
    """Every ``rvqB*_K*`` run under ``sweep_root`` on ``backbones``
    ({"audio": DAC, "tactile": DAC}) -> one row each, with ``run``, ``path``
    and ``checkpoint``. A run without ``best.msgpack`` is evaluated on its
    ``last.msgpack`` (an interrupted run can lose the best checkpoint's
    write) and labelled so; a run with neither is skipped. latency_map:
    {"rvqB{B}_K{K}": latency-map entry}, measured per run where absent."""
    runs = artifacts.discover_runs(sweep_root)
    if not runs:
        raise RuntimeError(f"No runs found under {sweep_root} (expected rvqB*_K*/)")
    dev = resolve_device(device)
    backbones = {k: v.to(dev).eval() for k, v in backbones.items()}   # once
    if prepared is None:
        log(f"[prepare] loading/resampling {len(pairs)} pairs once for all runs")
        prepared = prepare_pairs(pairs, base_cfg.dac.sample_rate, log=log)
    results = []
    for run in runs:
        parsed = artifacts.parse_run_dir(run)
        ckpt_path = os.path.join(run, checkpoint_name)
        ckpt_used = checkpoint_name
        if parsed is not None and not os.path.isfile(ckpt_path):
            alt = os.path.join(run, "last.msgpack")
            if checkpoint_name == "best.msgpack" and os.path.isfile(alt):
                log(f"[fallback] {run}: best.msgpack missing, using last")
                ckpt_path, ckpt_used = alt, "last.msgpack"
        if parsed is None or not os.path.isfile(ckpt_path):
            log(f"[skip] {run}")
            continue
        books, embed = parsed
        cfg = base_cfg.with_rvq(books, embed)
        modules = convert.codec_from_backbones(backbones["audio"], backbones["tactile"],
                                               ckpt_path, cfg)
        name = artifacts.run_dir_name(books, embed)
        log(f"[proposed] {name}")
        row = evaluate_proposed_model(modules, pairs, peak_global, books_use=books,
                                      ecfg=ecfg, protocol=protocol,
                                      latency=(latency_map or {}).get(name),
                                      prepared=prepared, device=dev)
        results.append({"run": os.path.basename(run), "path": run,
                        "checkpoint": ckpt_used, **row})
    return results
