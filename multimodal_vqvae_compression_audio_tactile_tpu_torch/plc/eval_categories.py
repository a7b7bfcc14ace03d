"""PLC evaluator with fixed loss categories (low / medium / high).

Port of the JAX package's ``plc/eval_categories.py``: for each category, every
pair with a burst mask seeded per file (``seed * 1000 + cat_idx * 100000`` plus
the file's 1-based index); ``eval_metrics_<cat>.csv`` per category and
``eval_cat_summary.json``, with the same fields and keys. The model runs on
``device`` (``None`` means the card).
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

from ..core.config import EvalConfig, PLCConfig
from ..data.pairs import Pair
from ..eval import metrics as M
from ..eval.serving import resolve_device
from ..utils import artifacts
from . import masks
from .eval_uniform import CSV_FIELDS, _mean, _refuse_unported, eval_plc_file, stockdec_summary
from .model import PLCModules


def eval_plc_categories(
    modules: PLCModules,
    pairs: Sequence[Pair],
    out_dir: str,
    pcfg: PLCConfig = PLCConfig(),
    ecfg: EvalConfig = EvalConfig(),
    seed: int = 7,
    dec_ft=None,
    log: Callable = print,
    device=None,
) -> dict:
    """Per-category metrics over all pairs, written to ``out_dir``; returns
    ``{category: summary, ..., "peak_global": peak}``."""
    _refuse_unported(dec_ft)
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    modules = modules.to(dev).eval()
    peak_global = M.compute_global_peak([t for _, t, _ in pairs])
    base_seed = seed * 1000
    tps = modules.cfg.dac.tokens_per_sec

    summary = {}
    for cat_idx, cat in enumerate(masks.CATEGORIES):
        rows = []
        for f_idx, (ap, tp, stem) in enumerate(pairs, start=1):
            def mask_fn(t_lat, f_idx=f_idx, cat_idx=cat_idx, cat=cat):
                rng = np.random.default_rng(
                    masks.eval_mask_seed(base_seed, f_idx, cat_idx=cat_idx))
                return masks.make_category_token_loss_mask(
                    rng, 1, t_lat, tps, pcfg, category=cat)[0]

            rows.append(eval_plc_file(modules, ap, tp, mask_fn, peak_global, ecfg,
                                      mask_embed=pcfg.mask_embed, device=dev))
        artifacts.write_csv(os.path.join(out_dir, f"eval_metrics_{cat}.csv"), rows,
                            CSV_FIELDS)
        summary[cat] = {f"mean_{k}": _mean(rows, k) for k in (
            "psnr_global_db", "stsim_global", "mae_masked", "psnr_masked_db",
            "psnr_masked_zero_db")}
        summary[cat]["plc_gain_masked_db"] = float(np.nanmean(
            [r["psnr_masked_db"] - r["psnr_masked_zero_db"] for r in rows]))
        summary[cat].update(stockdec_summary(rows))
        summary[cat]["num_files"] = len(rows)
        log(f"[plc-cat {cat}] PSNR {summary[cat]['mean_psnr_global_db']:.2f} dB "
            f"ST-SIM {summary[cat]['mean_stsim_global']:.4f}")

    summary["peak_global"] = peak_global
    artifacts.write_json(os.path.join(out_dir, "eval_cat_summary.json"), summary)
    return summary
