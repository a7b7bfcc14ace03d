"""Fine-tune the tactile decoder on concealed latents for an existing PLC run.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.train_plc_decft \\
        --run-dir R --backbone CKPT (--cache-file C | --audio-dir A --tact-dir T) \\
        [--mode uniform|category] [--epochs 10] [--batch 8] [--pairs 256] \\
        [--val-pairs 32] [--steps-per-epoch 0] [--lr 1e-4] [--w-masked-ft 1.0] \\
        [--cat-probs L,M,H] [--seed 7] [--resume] [--cpu]

The JAX package's ``scripts/train_plc_decft.py`` with the same flags and
defaults: the head of ``--run-dir`` (its best, else its last) stays frozen,
its ``PLCConfig`` read from the run's ``meta.json``, and
``plc/train.py::finetune_inpaint_decoder`` trains the decoder alone, writing
``R/dec_plc.msgpack``, which ``eval_plc`` picks up. ``--cache-file``: a
latent cache (``build_latent_cache``; either package's), from which train
rows (``--pairs``) and validation rows (``--val-pairs``) are drawn by a
seeded permutation, no encoder running per step; ``--audio-dir/--tact-dir``
instead: waveform batches of the corpus, encoded in each step (K1 on the
card). Runs on the card, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from ..convert import load_dac, load_plc_head
from ..core.config import CodecConfig, LossConfig, PLCConfig, TrainConfig
from ..data import SegmentDataset, batch_iterator, pair_stems, split_items
from ..eval.serving import resolve_device
from ..plc.train import finetune_inpaint_decoder, plc_config_from_meta
from ..train import latent_cache as lc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--backbone", required=True)
    ap.add_argument("--cache-file",
                    help="latent cache; mutually exclusive with --audio-dir/--tact-dir")
    ap.add_argument("--audio-dir", help="corpus path (the encoders run every step)")
    ap.add_argument("--tact-dir")
    ap.add_argument("--mode", choices=["uniform", "category"], default=None,
                    help="default: the run's meta.json mode")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=256,
                    help="train-subset size from the cache (0 = all rows)")
    ap.add_argument("--val-pairs", type=int, default=32)
    ap.add_argument("--steps-per-epoch", type=int, default=0, help="0 = pairs//batch")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--w-masked-ft", type=float, default=1.0)
    ap.add_argument("--cat-probs", default="",
                    help="category mode: override the low,medium,high mask sampling "
                         "probabilities for the fine-tune only (e.g. '0.2,0.4,0.4'); "
                         "evaluation keeps the reference probabilities")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = CodecConfig()
    pcfg = plc_config_from_meta(args.run_dir, PLCConfig())
    if args.cat_probs:
        try:
            probs = tuple(float(x) for x in args.cat_probs.split(","))
        except ValueError:
            ap.error(f"--cat-probs must be three comma-separated floats, got "
                     f"{args.cat_probs!r}")
        if len(probs) != 3 or abs(sum(probs) - 1.0) > 1e-6:
            ap.error(f"--cat-probs needs exactly 3 probabilities summing to 1.0, got {probs}")
        pcfg = dataclasses.replace(pcfg, cat_probs=probs)
    mode = args.mode
    if mode is None:
        try:
            with open(os.path.join(args.run_dir, "meta.json")) as f:
                mode = json.load(f).get("mode", "uniform")
        except FileNotFoundError:
            mode = "uniform"

    best = os.path.join(args.run_dir, "best.msgpack")
    head = load_plc_head(best if os.path.exists(best)
                         else os.path.join(args.run_dir, "last.msgpack"), cfg, pcfg.n_layers)
    bb = load_dac(args.backbone, cfg.dac)
    backbones = {"audio": bb, "tactile": bb}
    tcfg = TrainConfig(epochs=args.epochs, batch=args.batch, lr=args.lr, seed=args.seed,
                       loss=LossConfig())
    if bool(args.cache_file) == bool(args.audio_dir):
        raise SystemExit("pass exactly one of --cache-file or --audio-dir/--tact-dir")

    if args.cache_file:
        print(f"[decft] loading cache {args.cache_file}", flush=True)
        cache = lc.load_cache(args.cache_file, device=device)
        n_rows = int(cache.qa.shape[0])
        perm = np.random.default_rng(args.seed).permutation(n_rows)
        n_tr = min(args.pairs or n_rows, n_rows - args.val_pairs)
        rows_tr, rows_va = perm[:n_tr], perm[n_tr:n_tr + args.val_pairs]
        seg_tok = int(round(tcfg.seg_sec * cfg.dac.tokens_per_sec))
        steps = args.steps_per_epoch or max(1, n_tr // args.batch)

        def train_batches(ep):
            return lc.cached_batches(cache, cfg, args.batch, steps, seg_tok, args.seed, ep,
                                     indices=rows_tr)

        def val_batches():
            return lc.cached_batches(cache, cfg, args.batch, max(1, len(rows_va) // args.batch),
                                     seg_tok, args.seed + 999, 0, indices=rows_va)
    else:
        pairs = pair_stems(args.audio_dir, args.tact_dir)
        tr, va = split_items(pairs, tcfg.val_frac, tcfg.max_val, tcfg.seed)
        if args.pairs:
            tr = tr[:args.pairs]
        va = va[:args.val_pairs]
        n_tr = len(tr)
        ds_tr = SegmentDataset(tr, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
        ds_va = SegmentDataset(va, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
        steps = args.steps_per_epoch or max(1, n_tr // args.batch)

        def train_batches(ep):
            return batch_iterator(ds_tr, tcfg.batch, seed=tcfg.seed, epoch=ep)

        def val_batches():
            return batch_iterator(ds_va, tcfg.batch, shuffle=False, drop_last=False)

    print(f"[decft] mode={mode} n_layers={pcfg.n_layers} mask_embed={pcfg.mask_embed} "
          f"train_rows={n_tr} steps={steps}", flush=True)
    return finetune_inpaint_decoder(cfg, tcfg, pcfg, backbones, head,
                                    train_batches=train_batches, val_batches=val_batches,
                                    out_dir=args.run_dir, mode=mode, seed=args.seed,
                                    epochs=args.epochs, w_masked_ft=args.w_masked_ft,
                                    resume=args.resume, device=device)


if __name__ == "__main__":
    main()
