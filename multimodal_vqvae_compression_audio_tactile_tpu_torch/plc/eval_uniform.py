"""PLC evaluator (uniform packet loss): per-file deterministic masks, metric splits.

Port of the JAX package's ``plc/eval_uniform.py``: every pair through the
concealment model with a mask seeded per file (``seed * 1000`` plus the
file's 1-based index), global / masked / unmasked PSNR, SNR, MAE and ST-SIM
through the token-to-sample mask projection, and the zero-fill floor on the
same mask. Writes ``eval_metrics.csv`` (the same fields) and
``eval_summary.json`` (the same keys).

The model runs on ``device`` (``None`` means the card) in fp32; resampling,
alignment and the metrics run on the host. Not ported yet: the inpainting
decoder (``dec_ft``, which comes with the PLC trainer) and the example
plots (``plot_top_k``); asking for either raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.config import EvalConfig, PLCConfig
from ..data.pairs import Pair
from ..dsp.align import align_by_xcorr, crop_match
from ..dsp.resample import resample
from ..eval import metrics as M
from ..eval.serving import resolve_device
from ..utils import artifacts
from ..utils.wav_io import load_wav_mono
from . import masks
from . import model as plc_model
from .model import PLCModules


def _nanmean_or_nan(vals) -> float:
    a = np.asarray(vals, dtype=np.float64)
    finite = a[np.isfinite(a)]
    return float(finite.mean()) if finite.size else float("nan")


def _refuse_unported(dec_ft=None, plot_top_k: int = 0) -> None:
    if dec_ft is not None:
        raise NotImplementedError("dec_ft: the inpainting decoder comes with the PLC "
                                  "trainer, which is not ported yet")
    if plot_top_k > 0:
        raise NotImplementedError("plot_top_k: the PLC plots are not ported yet")


CSV_FIELDS = [
    "stem", "len_samples",
    "psnr_global_db", "stsim_global",
    "psnr_masked_db", "psnr_unmasked_db",
    "snr_masked_db", "snr_unmasked_db",
    "mae_masked", "mae_unmasked",
    "stsim_masked", "stsim_unmasked",
    # the zero-fill (no-concealment) floor on the same mask, so the PLC
    # benefit is a measured gain, not an absolute number
    "psnr_masked_zero_db", "stsim_global_zero",
    # with an inpainting decoder (dec_ft): the same conceal fill decoded by
    # the stock decoder (NaN when no dec_ft is in play, always here)
    "psnr_masked_stockdec_db",
]


def _prepare(a_path: str, t_path: str, sr24: int) -> tuple:
    """(audio, peak-normalised tactile, raw tactile, the tactile's peak), all
    at 24 kHz; the first two [1, L], cut to a common length and made finite
    in [-1, 1]."""
    a_raw, sr_a = load_wav_mono(a_path)
    t_raw, sr_t = load_wav_mono(t_path)
    scale = max(float(np.abs(t_raw).max()), 1e-8)
    a24 = np.asarray(resample(a_raw, sr_a, sr24))
    t24n = np.asarray(resample(t_raw / scale, sr_t, sr24))
    L = min(a24.shape[-1], t24n.shape[-1])
    a24, t24n = a24[..., :L], t24n[..., :L]
    a24 = np.clip(np.nan_to_num(a24, nan=0, posinf=0.9999, neginf=-0.9999), -1, 1)
    t24n = np.clip(np.nan_to_num(t24n, nan=0, posinf=0.9999, neginf=-0.9999), -1, 1)
    ref24 = np.asarray(resample(t_raw, sr_t, sr24))[0]
    return a24, t24n, ref24, scale


def _aligned(ref24: np.ndarray, est24: np.ndarray, max_shift: int) -> tuple:
    """(ref, est), each [1, T'], cut to a common length and aligned by xcorr."""
    r_c, e_c = crop_match(ref24.reshape(1, -1), est24.reshape(1, -1))
    r_a, e_a, _ = align_by_xcorr(r_c, e_c, max_shift)
    return crop_match(r_a, e_a)


def eval_plc_file(
    modules: PLCModules,
    a_path: str,
    t_path: str,
    mask_fn: Callable[[int], np.ndarray],
    peak_global: float,
    ecfg: EvalConfig = EvalConfig(),
    mask_embed: bool = False,
    dec_ft=None,
    device=None,
) -> dict:
    """One file through the concealment model with a deterministic mask ->
    its CSV row. ``mask_embed`` must match the run's training condition (its
    meta.json)."""
    _refuse_unported(dec_ft)
    dev = resolve_device(device)
    modules = modules.to(dev).eval()
    cfg = modules.cfg
    a24, t24n, ref24, scale = _prepare(a_path, t_path, cfg.dac.sample_rate)

    t_lat = a24.shape[-1] // cfg.dac.hop
    latent_mask = mask_fn(t_lat)                        # [T_lat] bool
    a = torch.from_numpy(a24[None]).to(dev)
    tc = torch.from_numpy(t24n[None]).to(dev)
    mk = torch.from_numpy(np.asarray(latent_mask[None], bool)).to(dev)
    y_norm = plc_model.forward_step(modules, a, tc, mk, mask_embed=mask_embed).y_hat
    y0_norm = plc_model.forward_zero_fill(modules, a, tc, mk).y_hat

    r_a, e_a = _aligned(ref24, y_norm[0, 0].cpu().numpy() * scale, ecfg.max_align_shift)
    psnr_global = M.psnr_global_peak_db(r_a, e_a, peak_global)
    stsim_g, stsim_m, stsim_u = M.stsim_mel_with_mask(
        r_a[0], e_a[0], latent_mask, sr=ecfg.eval_sr)

    # zero-fill baseline on the identical mask (aligned the same way)
    r0_a, e0_a = _aligned(ref24, y0_norm[0, 0].cpu().numpy() * scale, ecfg.max_align_shift)
    sm0 = M.token_mask_to_sample_mask(latent_mask, r0_a.shape[-1])
    psnr_masked_zero = M.psnr_subset_db(r0_a[0], e0_a[0], sm0, peak_global)
    stsim_g0, _, _ = M.stsim_mel_with_mask(r0_a[0], e0_a[0], latent_mask,
                                           sr=ecfg.eval_sr)

    ref_vec, est_vec = r_a[0], e_a[0]
    sm = M.token_mask_to_sample_mask(latent_mask, ref_vec.shape[0])
    return {
        "psnr_masked_zero_db": psnr_masked_zero,
        "stsim_global_zero": stsim_g0,
        "psnr_masked_stockdec_db": float("nan"),
        "stem": os.path.splitext(os.path.basename(t_path))[0],
        "len_samples": int(ref_vec.shape[0]),
        "psnr_global_db": psnr_global,
        "stsim_global": stsim_g,
        "psnr_masked_db": M.psnr_subset_db(ref_vec, est_vec, sm, peak_global),
        "psnr_unmasked_db": M.psnr_subset_db(ref_vec, est_vec, ~sm, peak_global),
        "snr_masked_db": M.snr_subset_db(ref_vec, est_vec, sm),
        "snr_unmasked_db": M.snr_subset_db(ref_vec, est_vec, ~sm),
        "mae_masked": M.mae_subset(ref_vec, est_vec, sm),
        "mae_unmasked": M.mae_subset(ref_vec, est_vec, ~sm),
        "stsim_masked": stsim_m,
        "stsim_unmasked": stsim_u,
    }


def _mean(rows: list, key: str) -> float:
    return float(np.nanmean([r[key] for r in rows]))


def eval_plc_uniform(
    modules: PLCModules,
    pairs: Sequence[Pair],
    out_dir: str,
    pcfg: PLCConfig = PLCConfig(),
    ecfg: EvalConfig = EvalConfig(),
    seed: int = 7,
    plot_top_k: int = 0,
    dec_ft=None,
    log: Callable = print,
    device=None,
) -> dict:
    """Metrics over all pairs -> ``eval_metrics.csv`` and ``eval_summary.json``
    in ``out_dir``; returns the summary."""
    _refuse_unported(dec_ft, plot_top_k)
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    modules = modules.to(dev).eval()
    peak_global = M.compute_global_peak([t for _, t, _ in pairs])
    base_seed = seed * 1000

    rows = []
    for idx, (ap, tp, stem) in enumerate(pairs, start=1):
        def mask_fn(t_lat, idx=idx):
            rng = np.random.default_rng(masks.eval_mask_seed(base_seed, idx))
            return masks.make_token_loss_mask(
                rng, 1, t_lat, pcfg.packet_tok, pcfg.packet_loss_prob)[0]

        row = eval_plc_file(modules, ap, tp, mask_fn, peak_global, ecfg,
                            mask_embed=pcfg.mask_embed, device=dev)
        rows.append(row)
        log(f"[plc-eval {idx}/{len(pairs)}] {stem} "
            f"PSNR {row['psnr_global_db']:.2f} dB ST-SIM {row['stsim_global']:.4f}")

    artifacts.write_csv(os.path.join(out_dir, "eval_metrics.csv"), rows, CSV_FIELDS)
    summary = {f"mean_{k}": _mean(rows, k) for k in (
        "psnr_global_db", "stsim_global", "psnr_masked_db", "psnr_unmasked_db",
        "snr_masked_db", "snr_unmasked_db", "mae_masked", "mae_unmasked",
        "stsim_masked", "stsim_unmasked", "psnr_masked_zero_db", "stsim_global_zero")}
    summary["plc_gain_masked_db"] = float(np.nanmean(
        [r["psnr_masked_db"] - r["psnr_masked_zero_db"] for r in rows]))
    summary.update(stockdec_summary(rows))
    summary["num_files"] = len(rows)
    summary["peak_global"] = peak_global
    artifacts.write_json(os.path.join(out_dir, "eval_summary.json"), summary)
    return summary


def stockdec_summary(rows: list) -> dict:
    """The decoder-lever split (NaN without dec_ft, kept NaN without numpy's
    empty-mean warning)."""
    return {
        "mean_psnr_masked_stockdec_db": _nanmean_or_nan(
            [r["psnr_masked_stockdec_db"] for r in rows]),
        "dec_ft_gain_masked_db": _nanmean_or_nan(
            [r["psnr_masked_db"] - r["psnr_masked_stockdec_db"] for r in rows]),
    }
