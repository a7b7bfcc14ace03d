"""Evaluate a trained PLC run.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.eval_plc \\
        --run-dir R --audio-dir A --tact-dir T [--mode uniform|category] \\
        [--backbone CKPT] [--checkpoint best.msgpack] [--seed 7] [--max-files N] \\
        [--no-dec-ft] [--cpu]

The JAX package's ``scripts/eval_plc.py`` with the same flags: the run's
``PLCConfig`` from its ``meta.json``, its head (``--checkpoint``, or
``last.msgpack`` where a run has no best), and, unless ``--no-dec-ft``, the
inpainting decoder ``R/dec_plc.msgpack`` where there is one (for the
concealed path only); then ``eval_plc_uniform`` or ``eval_plc_categories``,
whose CSV and summary JSON go into ``R``. The backbone checkpoint serves as
both backbones; without one both are random from ``--seed``, with a
warning. Runs on the card, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..convert import load_decoder, load_plc_head
from ..core.config import CodecConfig, PLCConfig
from ..data.pairs import pair_stems
from ..eval.serving import resolve_device
from ..plc.eval_categories import eval_plc_categories
from ..plc.eval_uniform import eval_plc_uniform
from ..plc.model import plc_of
from ..plc.train import plc_config_from_meta
from .train_codec import default_backbones


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["uniform", "category"], default="uniform")
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--audio-dir", required=True)
    ap.add_argument("--tact-dir", required=True)
    ap.add_argument("--backbone")
    ap.add_argument("--checkpoint", default="best.msgpack")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--max-files", type=int, default=0,
                    help="evaluate an evenly-spaced subset of N pairs (0 = all)")
    ap.add_argument("--no-dec-ft", action="store_true",
                    help="ignore dec_plc.msgpack even if present")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = CodecConfig()
    backbones = default_backbones(cfg, args.backbone, args.seed)
    # the training condition (packet shape, mask_embed, predictor depth)
    pcfg = plc_config_from_meta(args.run_dir, PLCConfig())
    ckpt_path = os.path.join(args.run_dir, args.checkpoint)
    if args.checkpoint == "best.msgpack" and not os.path.exists(ckpt_path):
        # a run cut short may never write best
        ckpt_path = os.path.join(args.run_dir, "last.msgpack")
        print(f"[eval_plc] best.msgpack missing, falling back to {ckpt_path}")
    modules = plc_of(backbones["audio"], backbones["tactile"],
                     load_plc_head(ckpt_path, cfg, pcfg.n_layers), cfg)

    dec_ft = None
    dec_path = os.path.join(args.run_dir, "dec_plc.msgpack")
    if not args.no_dec_ft and os.path.exists(dec_path):
        dec_ft = load_decoder(dec_path, cfg.dac)
        print(f"[eval_plc] using inpainting decoder {dec_path}")

    pairs = pair_stems(args.audio_dir, args.tact_dir)
    if args.max_files and len(pairs) > args.max_files:
        # an evenly spaced subset keeps the material classes (stems sort by class)
        idx = np.linspace(0, len(pairs) - 1, args.max_files).astype(int)
        pairs = [pairs[i] for i in idx]
    evaluate = eval_plc_uniform if args.mode == "uniform" else eval_plc_categories
    return evaluate(modules, pairs, args.run_dir, pcfg, seed=args.seed, dec_ft=dec_ft,
                    device=device)


if __name__ == "__main__":
    main()
