"""Rate-distortion sweep over the head RVQ's shapes.

Port of the JAX package's ``train/sweep.py``: one ``train_codec`` run for
every (books, embed) pair of the grid, each in its own ``rvqB{B}_K{K}/`` run
directory (last/best/hist/meta), the nominal rate tps * B * log2(K) / 1000
kbps, and ``sweep_summary.csv`` sorted by (kbps, best validation loss). A
run whose ``meta.json`` records the sweep's epochs and which has a
checkpoint is not trained again; a partial run resumes from its
``last.msgpack``. With ``cache=`` every run trains on the same latent cache
(``train/latent_cache.py``), the encoders having run once for the whole
grid. Runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Iterable, Optional

from ..core.config import CodecConfig, SweepConfig, TrainConfig
from ..eval.serving import resolve_device
from ..utils import artifacts
from .loop import train_codec

CSV_FIELDS = ["run", "rvq_books", "rvq_embed", "bits_per_code", "tokens_per_sec",
              "est_kbps", "best_val", "epochs"]


def run_sweep(
    base_cfg: CodecConfig,
    tcfg: TrainConfig,
    sweep: SweepConfig,
    backbones: dict,
    train_batches: Optional[Callable[[int], Iterable]],
    val_batches: Optional[Callable[[], Iterable]],
    out_root: str,
    tokens_per_sec: Optional[float] = None,
    save_every: int = 1,
    steps_per_epoch: Optional[int] = None,
    cache=None,
    cache_train_rows=None,
    cache_val_rows=None,
    seg_tok: Optional[int] = None,
    val_steps: Optional[int] = None,
    log: Callable[[str], None] = print,
    device=None,
) -> list:
    """Train every (books, embed) pair; -> the summary rows (also written as
    ``out_root/sweep_summary.csv``)."""
    dev = resolve_device(device)
    os.makedirs(out_root, exist_ok=True)
    tps = tokens_per_sec or base_cfg.dac.tokens_per_sec
    rows = []
    for books in sweep.books_grid:
        for embed in sweep.embed_grid:
            cfg = base_cfg.with_rvq(books, embed)
            name = artifacts.run_dir_name(books, embed)
            run_dir = os.path.join(out_root, name)
            kbps = cfg.kbps(tps)
            # meta.json is written only once train_codec has returned, so a
            # meta with the sweep's epochs and a checkpoint mark a finished
            # run (a short run may have only last.msgpack)
            prior = artifacts.read_meta(run_dir)
            has_ckpt = any(os.path.isfile(os.path.join(run_dir, f))
                           for f in ("best.msgpack", "last.msgpack"))
            if has_ckpt and prior and prior.get("epochs", 0) >= tcfg.epochs:
                log(f"[sweep] rvqB{books}_K{embed} already trained — skip")
                rows.append({"run": name, **prior})
                continue
            log(f"[sweep] rvqB{books}_K{embed} ~ {kbps:.3f} kbps")
            hist = train_codec(cfg, tcfg, backbones, train_batches, val_batches, run_dir,
                               save_every=save_every, steps_per_epoch=steps_per_epoch,
                               resume=True, cache=cache, cache_train_rows=cache_train_rows,
                               cache_val_rows=cache_val_rows, seg_tok=seg_tok,
                               val_steps=val_steps, log=log, device=dev)
            meta = {
                "rvq_books": books,
                "rvq_embed": embed,
                "bits_per_code": math.log2(embed),
                "tokens_per_sec": tps,
                "est_kbps": kbps,
                "best_val": min(hist["val"]) if hist["val"] else float("nan"),
                "epochs": tcfg.epochs,
            }
            artifacts.write_meta(run_dir, meta)
            rows.append({"run": name, **meta})

    rows.sort(key=lambda r: (r["est_kbps"], r["best_val"]))
    artifacts.write_csv(os.path.join(out_root, "sweep_summary.csv"), rows, CSV_FIELDS)
    return rows
