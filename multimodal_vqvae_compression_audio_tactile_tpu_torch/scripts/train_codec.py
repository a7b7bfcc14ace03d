"""Train the AR cross-modal codec's head (one configuration).

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.train_codec \\
        --out-dir O (--audio-dir A --tact-dir T | --synth N) [--backbone CKPT] \\
        [--books 10] [--embed 128] [--epochs 100] [--batch 6] [--seed 7] \\
        [--tiny] [--cpu] [--resume]

The JAX package's ``scripts/train_codec.py`` with the same flags and
defaults (batch 6, 100 epochs, lr 2e-4, seed 7; ``best.msgpack`` is kept
only after ``TrainConfig.best_after_epoch``, epoch 6). The backbone
checkpoint (read strictly by ``convert.load_dac``) serves as both the audio
and the tactile backbone; without one, both are random from ``--seed``,
with a warning. ``--synth N`` writes N synthetic pairs under ``O/_synth``
instead of reading directories. Training runs on the card, or on the CPU
with ``--cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..convert import load_dac
from ..core.config import CodecConfig, PredictorConfig, RVQConfig, TrainConfig
from ..data import SegmentDataset, batch_iterator, pair_stems, split_items
from ..data.synth import make_synth_corpus
from ..eval.serving import resolve_device
from ..models.dac import DAC, init_dac_
from ..train.loop import train_codec


def default_backbones(cfg: CodecConfig, backbone_ckpt, seed: int = 7) -> dict:
    """{"audio", "tactile"}: one checkpoint's backbone for both, or, without
    one, two random backbones from ``seed`` (with a warning)."""
    if backbone_ckpt and os.path.exists(backbone_ckpt):
        bb = load_dac(backbone_ckpt, cfg.dac)
        return {"audio": bb, "tactile": bb}
    print("[warn] no backbone checkpoint given: using random-init backbones")
    gen = torch.Generator().manual_seed(seed)
    return {"audio": init_dac_(DAC(cfg.dac), gen), "tactile": init_dac_(DAC(cfg.dac), gen)}


def codec_config(books: int, embed: int, tiny: bool) -> CodecConfig:
    """The script's configuration: full width, or the tiny CPU-test one."""
    cfg = CodecConfig(rvq=RVQConfig(n_books=books, n_embed=embed))
    if tiny:
        d = cfg.dac.tiny()
        cfg = dataclasses.replace(
            cfg, dac=d, predictor=PredictorConfig(dim=d.latent_dim, heads=8),
            rvq=RVQConfig(code_dim=16, n_books=books, n_embed=embed), ar_chunk_tok=4)
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--audio-dir")
    ap.add_argument("--tact-dir")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--backbone", help="pretrained backbone checkpoint (.msgpack)")
    ap.add_argument("--books", type=int, default=10)
    ap.add_argument("--embed", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--synth", type=int, default=0,
                    help="generate N synthetic pairs instead of reading dirs")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--tiny", action="store_true", help="tiny model (CPU testing)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from out-dir/last.msgpack")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = codec_config(args.books, args.embed, args.tiny)
    tcfg = TrainConfig(epochs=args.epochs, batch=args.batch, seed=args.seed)
    if args.synth:
        pairs = make_synth_corpus(os.path.join(args.out_dir, "_synth"), n_pairs=args.synth,
                                  seed=args.seed)
    else:
        pairs = pair_stems(args.audio_dir, args.tact_dir)
    tr, va = split_items(pairs, tcfg.val_frac, tcfg.max_val, tcfg.seed)
    ds_tr = SegmentDataset(tr, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
    ds_va = SegmentDataset(va, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)

    backbones = default_backbones(cfg, args.backbone, args.seed)
    return train_codec(
        cfg, tcfg, backbones,
        train_batches=lambda ep: batch_iterator(ds_tr, tcfg.batch, seed=tcfg.seed, epoch=ep),
        val_batches=lambda: batch_iterator(ds_va, tcfg.batch, shuffle=False, drop_last=False),
        out_dir=args.out_dir, seed=tcfg.seed, resume=args.resume, device=device)


if __name__ == "__main__":
    main()
