"""Pretrain the DAC-class backbone codec on waveform reconstruction.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.pretrain_backbone \\
        --out-dir O (--wav-dir D | --synth N | --stream STEPS) [--epochs 100] \\
        [--batch 8] [--gan [--gan-start-epoch E]] [--no-nq-dropout] \\
        [--resume CKPT] [--tiny] [--cpu]

The JAX package's ``scripts/pretrain_backbone.py`` with the same flags and
defaults: batch 8, 1-s segments, lr 2e-4, clip 3.0, Adam betas (0.8, 0.99)
(DAC's pretraining betas), quantizer dropout on. ``--wav-dir`` trains on one
directory of WAVs (a fifth held out for validation), ``--synth N`` on N
synthetic pairs' tactile side written under ``O/_synth``, ``--stream S`` on
S freshly generated batches an epoch (``data/synth.py::
stream_pretrain_batches``, int16 wire batches unless ``--no-wire-i16``)
against 8 held-out batches from seed + 10000. ``--gan`` adds the MPD +
MS-STFT adversary after ``--gan-start-epoch - 1`` reconstruction-only
epochs; ``--resume`` continues from a backbone checkpoint. Training runs on
the card, or on the CPU with ``--cpu``; ``--tiny`` is the tiny width.
"""

from __future__ import annotations

import argparse
import glob
import os
from itertools import islice

from ..core.config import DacConfig, GanConfig, TrainConfig
from ..data import SegmentDataset, batch_iterator
from ..data.synth import make_synth_corpus, stream_pretrain_batches
from ..eval.serving import resolve_device
from ..train.pretrain_backbone import pretrain_backbone


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wav-dir", help="directory of training WAVs (one modality)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seg-sec", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--clip", type=float, default=3.0)
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="0 = auto (total/20 capped at 500)")
    ap.add_argument("--synth", type=int, default=0)
    ap.add_argument("--stream", type=int, default=0, metavar="STEPS_PER_EPOCH",
                    help="endless fresh synthetic data: each epoch is STEPS_PER_EPOCH "
                         "new batches; validation is a fixed held-out generated set")
    ap.add_argument("--no-wire-i16", action="store_true",
                    help="ship float32 batches instead of int16 wire batches "
                         "(stream mode only; see data/wire.py)")
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--gan", action="store_true",
                    help="adversarial recipe (MPD + MS-STFT discriminators)")
    ap.add_argument("--gan-start-epoch", type=int, default=1,
                    help="reconstruction-only warm-up epochs before the GAN")
    ap.add_argument("--no-nq-dropout", action="store_true")
    ap.add_argument("--resume", metavar="CKPT",
                    help="continue an interrupted run from this backbone checkpoint "
                         "(epoch read from the file; the LR schedule resumes at its place)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    cfg = DacConfig().tiny() if args.tiny else DacConfig()
    tcfg = TrainConfig(epochs=args.epochs, batch=args.batch, seed=args.seed,
                       seg_sec=args.seg_sec, lr=args.lr, grad_clip=args.clip,
                       adam_b1=0.8, adam_b2=0.99)

    if args.stream:
        wire_i16 = not args.no_wire_i16
        stream = stream_pretrain_batches(tcfg.batch, seg=tcfg.seg, sr=cfg.sample_rate,
                                         seed=tcfg.seed, wire_i16=wire_i16)
        val_set = list(islice(stream_pretrain_batches(
            tcfg.batch, seg=tcfg.seg, sr=cfg.sample_rate, seed=tcfg.seed + 10_000,
            prefetch=1, wire_i16=wire_i16), 8))
        train_batches = lambda ep: islice(stream, args.stream)  # noqa: E731
        val_batches = lambda: iter(val_set)                     # noqa: E731
        steps_per_epoch = args.stream
    else:
        if args.synth:
            pairs = make_synth_corpus(os.path.join(args.out_dir, "_synth"),
                                      n_pairs=args.synth, seed=args.seed)
            wavs = [t for _, t, _ in pairs]          # the tactile side
        else:
            wavs = sorted(glob.glob(os.path.join(args.wav_dir, "*.wav")))
        # one modality: each file paired with itself
        items = [(w, w, os.path.basename(w)) for w in wavs]
        n_val = max(1, len(items) // 5)
        ds_tr = SegmentDataset(items[n_val:], sr=cfg.sample_rate, seg=tcfg.seg)
        ds_va = SegmentDataset(items[:n_val], sr=cfg.sample_rate, seg=tcfg.seg)
        train_batches = lambda ep: (a for a, _ in batch_iterator(  # noqa: E731
            ds_tr, tcfg.batch, seed=tcfg.seed, epoch=ep))
        val_batches = lambda: (a for a, _ in batch_iterator(       # noqa: E731
            ds_va, tcfg.batch, shuffle=False, drop_last=False))
        steps_per_epoch = None

    return pretrain_backbone(
        cfg, tcfg, train_batches=train_batches, val_batches=val_batches,
        out_dir=args.out_dir, seed=tcfg.seed, steps_per_epoch=steps_per_epoch,
        save_every=args.save_every, nq_dropout=not args.no_nq_dropout,
        warmup_steps=args.warmup_steps or None, resume_from=args.resume,
        gan=GanConfig(start_epoch=args.gan_start_epoch) if args.gan else None,
        device=device)


if __name__ == "__main__":
    main()
