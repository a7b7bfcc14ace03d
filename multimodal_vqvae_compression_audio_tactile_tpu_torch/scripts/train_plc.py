"""Train a packet-loss-concealment head (and, optionally, its inpainting
decoder).

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.train_plc \\
        --out-dir O (--audio-dir A --tact-dir T | --synth N) [--mode uniform|category] \\
        [--backbone CKPT] [--epochs 50] [--batch 6] [--seed 7] [--plc-latent-w 1.0] \\
        [--plc-masked-w 0.5] [--no-mask-embed] [--plc-latent-epochs 0] [--plc-layers 1] \\
        [--decoder-ft-epochs 0] [--w-masked-ft 1.0] [--resume] [--cpu]

The JAX package's ``scripts/train_plc.py`` with the same flags and defaults
(50 epochs, packets of 2 tokens at p 0.5, categories 52/32/16%, the masked
latent and time terms at 1.0 and 0.5, the learned mask token on):
``plc/train.py::train_plc`` at full width, then, with
``--decoder-ft-epochs``, ``finetune_inpaint_decoder`` on the run's best head
(its last where there is no best), which writes ``O/dec_plc.msgpack``. The
backbone checkpoint serves as both the audio and the tactile backbone;
without one both are random from ``--seed``, with a warning. Runs on the
card, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import os

from ..convert import load_plc_head
from ..core.config import CodecConfig, LossConfig, PLCConfig, TrainConfig
from ..data import SegmentDataset, batch_iterator, pair_stems, split_items
from ..data.synth import make_synth_corpus
from ..eval.serving import resolve_device
from ..plc.train import finetune_inpaint_decoder, train_plc
from .train_codec import default_backbones


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["uniform", "category"], default="uniform")
    ap.add_argument("--audio-dir")
    ap.add_argument("--tact-dir")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--backbone")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--synth", type=int, default=0)
    ap.add_argument("--plc-latent-w", type=float, default=1.0,
                    help="masked-token latent regression weight")
    ap.add_argument("--plc-masked-w", type=float, default=0.5,
                    help="masked-span time-domain relative-MSE weight")
    ap.add_argument("--no-mask-embed", action="store_true",
                    help="disable the learned lost-token embedding")
    ap.add_argument("--plc-latent-epochs", type=int, default=0,
                    help="decoder-free masked-latent pretrain epochs")
    ap.add_argument("--plc-layers", type=int, default=1,
                    help="stacked predictor depth (1 = reference structure)")
    ap.add_argument("--decoder-ft-epochs", type=int, default=0,
                    help="inpainting-decoder fine-tune epochs after head training "
                         "(predictor frozen; writes dec_plc.msgpack)")
    ap.add_argument("--w-masked-ft", type=float, default=1.0,
                    help="masked-span weight in the decoder fine-tune loss")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = CodecConfig()
    tcfg = TrainConfig(epochs=args.epochs, batch=args.batch, seed=args.seed,
                       loss=LossConfig(w_plc_latent=args.plc_latent_w,
                                       w_plc_masked=args.plc_masked_w))
    pcfg = PLCConfig(mask_embed=not args.no_mask_embed, n_layers=args.plc_layers)
    if args.synth:
        pairs = make_synth_corpus(os.path.join(args.out_dir, "_synth"), n_pairs=args.synth,
                                  seed=args.seed)
    else:
        pairs = pair_stems(args.audio_dir, args.tact_dir)
    tr, va = split_items(pairs, tcfg.val_frac, tcfg.max_val, tcfg.seed)
    ds_tr = SegmentDataset(tr, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
    ds_va = SegmentDataset(va, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)

    backbones = default_backbones(cfg, args.backbone, args.seed)

    def train_batches(ep):
        return batch_iterator(ds_tr, tcfg.batch, seed=tcfg.seed, epoch=ep)

    def val_batches():
        return batch_iterator(ds_va, tcfg.batch, shuffle=False, drop_last=False)

    hist = train_plc(cfg, tcfg, pcfg, backbones, train_batches=train_batches,
                     val_batches=val_batches, out_dir=args.out_dir, mode=args.mode,
                     seed=tcfg.seed, resume=args.resume,
                     latent_pretrain_epochs=args.plc_latent_epochs, device=device)
    if args.decoder_ft_epochs > 0:
        best = os.path.join(args.out_dir, "best.msgpack")
        head = load_plc_head(best if os.path.exists(best)
                             else os.path.join(args.out_dir, "last.msgpack"),
                             cfg, args.plc_layers)
        finetune_inpaint_decoder(cfg, tcfg, pcfg, backbones, head, train_batches=train_batches,
                                 val_batches=val_batches, out_dir=args.out_dir, mode=args.mode,
                                 seed=tcfg.seed, epochs=args.decoder_ft_epochs,
                                 w_masked_ft=args.w_masked_ft, resume=args.resume,
                                 device=device)
    return hist


if __name__ == "__main__":
    main()
