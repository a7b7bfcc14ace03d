"""Build a frozen-backbone latent cache of a corpus and write it as ``.npz``.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.build_latent_cache \\
        --audio-dir A --tact-dir T --backbone CKPT --out cache.npz \\
        [--batch 8] [--max-pairs N] [--seed 7] [--tiny] [--cpu]

The JAX package's ``scripts/build_latent_cache.py`` with the same flags:
every pair, whole (cut to its shorter side), through the frozen encoders
(``train/latent_cache.py::build_latent_cache``) in batches of ``--batch``
pairs of one length, then ``save_cache``; the file loads in either package.
The backbone checkpoint (read strictly by ``convert.load_dac``) serves as
both the audio and the tactile backbone; without one both are random from
``--seed``, with a warning. Runs on the card (the encoders through K1), or
on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.config import CodecConfig, TrainConfig
from ..data import SegmentDataset, pair_stems
from ..eval.serving import resolve_device
from ..train import latent_cache as lc
from .train_codec import default_backbones


def full_batches(ds: SegmentDataset, pairs: list, batch: int):
    """Whole files, ``batch`` pairs at a time, each batch cut to its
    shortest file: (a, tc) [B, 1, L]."""
    for i in range(0, len(pairs), batch):
        arrs = [(ds._prep(ap), ds._prep(tp)) for ap, tp, _ in pairs[i:i + batch]]
        L = min(min(a.shape[-1], t.shape[-1]) for a, t in arrs)
        yield (np.stack([a[..., :L] for a, _ in arrs]),
               np.stack([t[..., :L] for _, t in arrs]))


def main(argv=None) -> lc.LatentCache:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--audio-dir", required=True)
    ap.add_argument("--tact-dir", required=True)
    ap.add_argument("--backbone", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-pairs", type=int, default=0,
                    help="cache only the first N pairs (0 = all; smoke runs)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny CodecConfig (evidence_tiny artifacts)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = CodecConfig().tiny() if args.tiny else CodecConfig()
    tcfg = TrainConfig()
    pairs = pair_stems(args.audio_dir, args.tact_dir)
    if not pairs:
        raise SystemExit("no pairs found")
    if args.max_pairs:
        pairs = pairs[:args.max_pairs]
    ds = SegmentDataset(pairs, sr=tcfg.target_sr, seg=tcfg.seg, seed=args.seed)
    backbones = default_backbones(cfg, args.backbone, args.seed)
    t0 = time.time()
    cache = lc.build_latent_cache(backbones, cfg, full_batches(ds, pairs, args.batch),
                                  log=print, device=device)
    print(f"[cache] built in {time.time() - t0:.0f}s qa={tuple(cache.qa.shape)}")
    lc.save_cache(args.out, cache)
    print(f"[cache] saved {args.out}")
    return cache


if __name__ == "__main__":
    main()
