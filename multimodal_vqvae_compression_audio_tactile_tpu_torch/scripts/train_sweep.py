"""RVQ rate sweep: a grid over books x embed, one run directory each.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.train_sweep \\
        --out-root O (--audio-dir A --tact-dir T | --synth N) [--backbone CKPT] \\
        [--books 1,2,3,4,6,8] [--embeds 128,256,512] [--epochs 100] [--batch 6] \\
        [--seed 7] [--cpu]

The JAX package's ``scripts/train_sweep.py`` with the same flags and
defaults: ``train/sweep.py::run_sweep`` at full width on waveform batches,
writing ``O/rvqB{B}_K{K}/`` per pair and ``O/sweep_summary.csv``; a finished
run is skipped and a partial one resumes, so the command can be run again
after a stop. The sweep on a latent cache has no flag here, as in the JAX
package: it is driven from Python (``run_sweep(..., cache=...)``). Runs on
the card, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import os

from ..core.config import CodecConfig, SweepConfig, TrainConfig
from ..data import SegmentDataset, batch_iterator, pair_stems, split_items
from ..data.synth import make_synth_corpus
from ..eval.serving import resolve_device
from ..train.sweep import run_sweep
from .train_codec import default_backbones


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--audio-dir")
    ap.add_argument("--tact-dir")
    ap.add_argument("--out-root", required=True)
    ap.add_argument("--backbone")
    ap.add_argument("--books", default="1,2,3,4,6,8")
    ap.add_argument("--embeds", default="128,256,512")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--synth", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = CodecConfig()
    tcfg = TrainConfig(epochs=args.epochs, batch=args.batch, seed=args.seed)
    sweep = SweepConfig(books_grid=tuple(int(x) for x in args.books.split(",")),
                        embed_grid=tuple(int(x) for x in args.embeds.split(",")))
    if args.synth:
        pairs = make_synth_corpus(os.path.join(args.out_root, "_synth"), n_pairs=args.synth,
                                  seed=args.seed)
    else:
        pairs = pair_stems(args.audio_dir, args.tact_dir)
    tr, va = split_items(pairs, tcfg.val_frac, tcfg.max_val, tcfg.seed)
    ds_tr = SegmentDataset(tr, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
    ds_va = SegmentDataset(va, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)

    backbones = default_backbones(cfg, args.backbone, args.seed)
    return run_sweep(
        cfg, tcfg, sweep, backbones,
        train_batches=lambda ep: batch_iterator(ds_tr, tcfg.batch, seed=tcfg.seed, epoch=ep),
        val_batches=lambda: batch_iterator(ds_va, tcfg.batch, shuffle=False, drop_last=False),
        out_root=args.out_root, device=device)


if __name__ == "__main__":
    main()
