"""End-to-end demonstration of the whole framework on one card.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.demo_end_to_end \\
        --root R [--pairs 48] [--pretrain-epochs 30] [--codec-epochs 30] [--plc-epochs 10] \\
        [--cached-heads] [--plc-category] [--tiny] [--cpu] ...

The JAX package's ``scripts/demo_end_to_end.py`` with every flag, its name
and its default, and the same stages:

  1. a paired audio/tactile corpus of ``--pairs`` synthetic pairs
     (``data/synth.py``) under ``R/corpus``, split 80/20 (seeded);
  2. the DAC-class backbone pretrained on the tactile side
     (``train/pretrain_backbone.py``; ``--gan`` adds the adversary), skipped
     when ``R/backbone/best.msgpack`` exists;
  3. the head sweep over ``--books-grid`` x ``--embed-grid``
     (``train/sweep.py``), with ``--cached-heads`` on the frozen-backbone
     latent cache (``train/latent_cache.py``; ``--cache-file`` keeps it as
     ``.npz``);
  4. the uniform and, with ``--plc-category``, the category PLC heads
     (``plc/train.py``; ``--plc-resume`` continues from ``last.msgpack``);
  5. (a) the VC-PWQ codec on the tactile corpus at ``EvalConfig().vc_b_list``,
     (b) the codec benchmark (``demo_eval_only.codec_benchmark``: latency
     map, backbone baseline, the sweep's runs, VC-PWQ; the combined JSON
     with the JAX package's keys, the rate-distortion figures and the best
     run's example figures), (c) both PLC evaluators, on ``--plc-eval-files``
     evenly spaced held-out pairs when given;
  6. every file of the reference contract: ``R/backbone/{best,last}.msgpack``
     with ``hist.json`` and ``vq_counts.msgpack``; ``R/sweep/rvqB*_K*/`` with
     ``{best,last}.msgpack``, ``hist.json``, ``meta.json`` and
     ``curves.png``, and ``R/sweep/sweep_summary.csv``;
     ``R/sweep/eval_vs_backbone/eval_all_vs_backbone_rawPSNR_latency.json``
     with the five rate-distortion PNGs and ``proposed_example_NN.png`` /
     ``_mel.png``; ``R/plc_uniform/`` and ``R/plc_category/`` with their
     checkpoints, ``hist.json``, ``meta.json``, ``curves.png`` and
     ``eval_metrics.csv`` + ``eval_summary.json`` (uniform) or
     ``eval_metrics_{low,medium,high}.csv`` + ``eval_cat_summary.json``
     (category); ``R/vc_decoded`` and ``R/vc_compressed``.

Everything runs on the card unless ``--cpu`` is given; without a card and
without ``--cpu`` it raises. Departures from the JAX script:

  (a) the latency map is measured in this process
      (``scripts/measure_latencies.py::measure``), as ``demo_eval_only``
      measures it; the JAX script measures it in a subprocess to step round
      a property of its TPU runtime;
  (b) where matplotlib is missing (the card's machine has none), the figures
      are not drawn and one line names them; the model work behind them
      (the examples' forwards) runs all the same;
  (c) the VC-PWQ codec is the binary that ``eval/vcpwq.py::build_codec``
      builds from ``native/vcpwq`` into ``build/vcpwq/``.

``main`` returns the run's numbers: each stage's wall seconds, the combined
JSON, the examples and both PLC summaries.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import os
import time
from itertools import islice

import numpy as np

from ..convert import load_dac, load_plc
from ..core.config import (CodecConfig, EvalConfig, GanConfig, PLCConfig, SweepConfig,
                           TrainConfig)
from ..data import SegmentDataset, batch_iterator, split_items
from ..data.synth import make_synth_corpus
from ..eval import vcpwq
from ..eval.plots import RD_FIGURES
from ..eval.serving import resolve_device
from ..plc.eval_categories import eval_plc_categories
from ..plc.eval_uniform import eval_plc_uniform
from ..plc.train import plc_config_from_meta, train_plc
from ..train import latent_cache as lc
from ..train.pretrain_backbone import pretrain_backbone
from ..train.sweep import run_sweep
from .build_latent_cache import full_batches
from .demo_eval_only import codec_benchmark
from .eval_codecs import OUT_JSON


def contract_files(root: str, runs, n_examples: int, pretrained: bool = True,
                   figures: bool = True) -> list:
    """The files of the reference contract (item 6 above) that a finished
    run with ``--plc-category`` under ``root`` holds: ``runs`` the sweep's
    run names, ``n_examples`` the examples drawn; ``pretrained`` False where
    the backbone was reused (its checkpoint alone), ``figures`` False where
    matplotlib is missing. The VC-PWQ directories are listed, not their
    files."""
    ev = os.path.join("sweep", "eval_vs_backbone")
    out = [os.path.join("backbone", "best.msgpack"), os.path.join("sweep", "sweep_summary.csv"),
           os.path.join(ev, OUT_JSON), "vc_decoded", "vc_compressed"]
    if pretrained:
        out += [os.path.join("backbone", f) for f in ("last.msgpack", "hist.json",
                                                      "vq_counts.msgpack")]
    run_files = ["best.msgpack", "last.msgpack", "hist.json", "meta.json"]
    run_figures = ["curves.png"] if figures else []
    for run in runs:
        out += [os.path.join("sweep", run, f) for f in run_files + run_figures]
    plc = {"plc_uniform": ["eval_metrics.csv", "eval_summary.json"],
           "plc_category": [f"eval_metrics_{c}.csv" for c in ("low", "medium", "high")]
           + ["eval_cat_summary.json"]}
    for d, evals in plc.items():
        out += [os.path.join(d, f) for f in run_files + run_figures + evals]
    if figures:
        out += [os.path.join(ev, f) for f in RD_FIGURES]
        out += [os.path.join(ev, f"proposed_example_{i:02d}{s}.png")
                for i in range(1, n_examples + 1) for s in ("", "_mel")]
    return [os.path.join(root, f) for f in out]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--pairs", type=int, default=48)
    ap.add_argument("--dur-sec", type=float, default=2.0)
    ap.add_argument("--pretrain-epochs", type=int, default=30)
    ap.add_argument("--codec-epochs", type=int, default=30)
    ap.add_argument("--plc-epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--books-grid", default="2,6,10")
    ap.add_argument("--embed-grid", default="128")
    ap.add_argument("--steps-per-epoch", type=int, default=0,
                    help="cap codec/PLC train steps per epoch (0 = full pass)")
    ap.add_argument("--val-batches", type=int, default=0,
                    help="cap validation batches per epoch (0 = all)")
    ap.add_argument("--eval-all-pairs", action="store_true",
                    help="evaluate on the full corpus (train+val) instead of val only")
    ap.add_argument("--cached-heads", action="store_true",
                    help="train every sweep head and the PLC heads on the frozen-backbone "
                         "latent cache (train/latent_cache.py)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--decorrelate", type=float, default=0.0,
                    help="corpus-hardness knob: fraction of per-modality independent "
                         "contact events (data/synth.py)")
    ap.add_argument("--jitter-ms", type=float, default=0.0,
                    help="corpus-hardness knob: per-modality timing jitter")
    ap.add_argument("--no-plc", action="store_true",
                    help="codec sweep + rate-distortion evaluation only")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    ap.add_argument("--tiny", action="store_true", help="CodecConfig().tiny()")
    ap.add_argument("--gan", action="store_true",
                    help="adversarial backbone pretraining (MPD + MS-STFT)")
    ap.add_argument("--gan-start-epoch", type=int, default=0,
                    help="reconstruction-only warm-up epochs (default: half the run)")
    ap.add_argument("--plc-category", action="store_true",
                    help="also train + evaluate the category-burst PLC model")
    ap.add_argument("--plc-latent-w", type=float, default=1.0)
    ap.add_argument("--plc-masked-w", type=float, default=0.5)
    ap.add_argument("--no-mask-embed", action="store_true")
    ap.add_argument("--plc-layers", type=int, default=1,
                    help="stacked cross-attention predictor depth (1 = reference structure)")
    ap.add_argument("--plc-latent-epochs", type=int, default=0,
                    help="decoder-free masked-latent pretrain epochs before the full loss")
    ap.add_argument("--plc-resume", action="store_true",
                    help="continue interrupted PLC runs from last.msgpack")
    ap.add_argument("--only-plc-category", action="store_true",
                    help="corpus + backbone (reused if present) + the category PLC "
                         "model trained and evaluated; nothing else")
    ap.add_argument("--only-plc", action="store_true",
                    help="corpus + backbone (reused if present) + both PLC models "
                         "trained and evaluated; no sweep, VC-PWQ or codec benchmark")
    ap.add_argument("--cache-file", default="",
                    help="keep / reuse the latent cache as .npz at this path (the caller "
                         "deletes it when the backbone or the corpus changes)")
    ap.add_argument("--plc-eval-files", type=int, default=0,
                    help="evaluate the PLC models on N evenly spaced eval pairs (0 = all)")
    return ap


def main(argv=None, stage=None) -> dict:
    """Run the demo. ``stage(name)``: a context manager around each stage
    (default: wall seconds, printed); the returned ``stages`` holds the
    default's seconds."""
    args = build_parser().parse_args(argv)
    if args.only_plc_category:
        args.plc_category = True
    do_uniform_plc = not (args.only_plc_category or args.no_plc)
    if args.no_plc:
        args.plc_category = False
    do_codec = not (args.only_plc_category or args.only_plc)
    device = resolve_device("cpu" if args.cpu else None)

    seconds: dict = {}

    @contextlib.contextmanager
    def timed(name):
        t0 = time.time()
        with (stage(name) if stage is not None else contextlib.nullcontext()):
            yield
        seconds[name] = time.time() - t0
        print(f"[demo] {name} in {seconds[name]:.0f}s", flush=True)

    t_start = time.time()
    root = args.root
    os.makedirs(root, exist_ok=True)
    print(f"[demo] device={device} root={root}", flush=True)
    cfg = CodecConfig().tiny() if args.tiny else CodecConfig()
    sr = cfg.dac.sample_rate

    # ---- 1. corpus
    with timed("corpus"):
        pairs = make_synth_corpus(os.path.join(root, "corpus"), n_pairs=args.pairs,
                                  dur_sec=args.dur_sec, seed=args.seed,
                                  decorrelate=args.decorrelate, jitter_ms=args.jitter_ms)
    tact_dir = os.path.join(root, "corpus", "tactile")
    print(f"[demo] corpus: {len(pairs)} pairs", flush=True)
    tr, va = split_items(pairs, 0.2, 300, args.seed)
    seg = int(1.0 * sr)
    ds_tr = SegmentDataset(tr, sr=sr, seg=seg, seed=args.seed)
    ds_va = SegmentDataset(va, sr=sr, seg=seg, seed=args.seed)

    # ---- 2. backbone pretraining (skipped when a checkpoint exists)
    bb_dir = os.path.join(root, "backbone")
    bb_path = os.path.join(bb_dir, "best.msgpack")

    def tactile_only(it):
        return (tc for _, tc in it)

    with timed("backbone"):
        if os.path.exists(bb_path):
            print("[demo] reusing existing backbone checkpoint", flush=True)
        else:
            pretrain_backbone(
                cfg.dac, TrainConfig(epochs=args.pretrain_epochs, batch=args.batch,
                                     seed=args.seed),
                train_batches=lambda ep: tactile_only(
                    batch_iterator(ds_tr, args.batch, seed=args.seed, epoch=ep)),
                val_batches=lambda: tactile_only(
                    batch_iterator(ds_va, args.batch, shuffle=False, drop_last=False)),
                out_dir=bb_dir, seed=args.seed, save_every=10,
                gan=(GanConfig(start_epoch=args.gan_start_epoch
                               or max(1, args.pretrain_epochs // 2)) if args.gan else None),
                device=device)
    bb = load_dac(bb_path, cfg.dac).to(device)
    backbones = {"audio": bb, "tactile": bb}

    # ---- 3. codec sweep
    def capped(it, n):
        return islice(it, n) if n else it

    def train_it(ep):
        return capped(batch_iterator(ds_tr, args.batch, seed=args.seed, epoch=ep),
                      args.steps_per_epoch)

    def val_it():
        return capped(batch_iterator(ds_va, args.batch, shuffle=False, drop_last=False),
                      args.val_batches)

    sweep_root = os.path.join(root, "sweep")
    tcfg_cd = TrainConfig(epochs=args.codec_epochs, batch=args.batch, seed=args.seed,
                          best_after_epoch=min(6, args.codec_epochs - 1))
    sweep = SweepConfig(books_grid=tuple(int(x) for x in args.books_grid.split(",")),
                        embed_grid=tuple(int(x) for x in args.embed_grid.split(",")))
    sweep_train_it, sweep_val_it, sweep_steps = train_it, val_it, None
    cache = tr_rows = va_rows = seg_tok = n_val = None
    if args.cached_heads:
        with timed("latent_cache"):
            if args.cache_file and os.path.exists(args.cache_file):
                cache = lc.load_cache(args.cache_file, device=device)
                print(f"[demo] latent cache loaded from {args.cache_file} "
                      f"{tuple(cache.qa.shape)}", flush=True)
            else:
                cache = lc.build_latent_cache(backbones, cfg, full_batches(ds_tr, pairs, 8),
                                              log=print, device=device)
                if args.cache_file:
                    lc.save_cache(args.cache_file, cache)
                    print(f"[demo] latent cache saved to {args.cache_file}", flush=True)
        tr_stems = {s for _, _, s in tr}
        tr_rows = [i for i, (_, _, s) in enumerate(pairs) if s in tr_stems]
        va_rows = [i for i, (_, _, s) in enumerate(pairs) if s not in tr_stems]
        seg_tok = int(round(1.0 * cfg.dac.tokens_per_sec))
        sweep_steps = args.steps_per_epoch or max(1, len(tr_rows) // args.batch)
        n_val = args.val_batches or max(1, len(va_rows) // args.batch)
        sweep_train_it = lambda ep: lc.cached_batches(   # noqa: E731
            cache, cfg, args.batch, sweep_steps, seg_tok, args.seed, ep, indices=tr_rows)
        sweep_val_it = lambda: lc.cached_batches(        # noqa: E731
            cache, cfg, args.batch, n_val, seg_tok, args.seed + 77, 0, indices=va_rows)

    if do_codec:
        with timed("sweep"):
            run_sweep(cfg, tcfg_cd, sweep, backbones, train_batches=sweep_train_it,
                      val_batches=sweep_val_it, out_root=sweep_root, save_every=5,
                      steps_per_epoch=sweep_steps, cache=cache, cache_train_rows=tr_rows,
                      cache_val_rows=va_rows, seg_tok=seg_tok, val_steps=n_val,
                      device=device)

    # ---- 4. PLC
    plc_dir = os.path.join(root, "plc_uniform")
    plc_cat_dir = os.path.join(root, "plc_category")
    tcfg_plc = TrainConfig(epochs=args.plc_epochs, batch=args.batch, seed=args.seed,
                           best_after_epoch=0,
                           loss=dataclasses.replace(TrainConfig().loss,
                                                    w_plc_latent=args.plc_latent_w,
                                                    w_plc_masked=args.plc_masked_w))
    pcfg_train = PLCConfig(mask_embed=not args.no_mask_embed, n_layers=args.plc_layers)
    for mode, run_dir, on in (("uniform", plc_dir, do_uniform_plc),
                              ("category", plc_cat_dir, args.plc_category)):
        if on:
            with timed(f"plc_{mode}_train"):
                train_plc(cfg, tcfg_plc, pcfg_train, backbones, train_batches=sweep_train_it,
                          val_batches=sweep_val_it, out_dir=run_dir, mode=mode,
                          seed=args.seed, steps_per_epoch=sweep_steps, save_every=5,
                          resume=args.plc_resume,
                          latent_pretrain_epochs=args.plc_latent_epochs, device=device)

    # ---- 5a. VC-PWQ on the tactile corpus
    vc_dec = os.path.join(root, "vc_decoded")
    vc_comp = os.path.join(root, "vc_compressed")
    vc_b_list = EvalConfig().vc_b_list
    if do_codec:
        with timed("vc_pwq"):
            n_t = len(glob.glob(os.path.join(tact_dir, "*.wav")))
            todo = [b for b in vc_b_list
                    if len(glob.glob(os.path.join(vc_dec, f"*_{b}.wav"))) < n_t]
            if todo:                # already coded budgets stay (idempotent reruns)
                vcpwq.code_corpus(tact_dir, vc_dec, vc_comp, todo)

    # ---- 5b. the codec benchmark
    eval_pairs = pairs if args.eval_all_pairs else va
    combined, examples = None, []
    if do_codec:
        with timed("codec_eval"):
            combined, examples = codec_benchmark(
                bb, cfg, eval_pairs, sweep_root, (vc_dec, vc_comp, tact_dir), vc_b_list,
                device, corpus_knobs={"decorrelate": args.decorrelate,
                                      "jitter_ms": args.jitter_ms},
                log=lambda *a: print(*a, flush=True))

    # ---- 5c. PLC evaluation
    plc_eval_pairs = eval_pairs
    if args.plc_eval_files and len(eval_pairs) > args.plc_eval_files:
        sel = np.linspace(0, len(eval_pairs) - 1, args.plc_eval_files).astype(int)
        plc_eval_pairs = [eval_pairs[i] for i in sel]
    summaries = {}
    for mode, run_dir, on, evaluate in (
            ("uniform", plc_dir, do_uniform_plc, eval_plc_uniform),
            ("category", plc_cat_dir, args.plc_category, eval_plc_categories)):
        if on:
            p = plc_config_from_meta(run_dir)
            m = load_plc(bb_path, run_dir, cfg, p.n_layers)
            with timed(f"plc_{mode}_eval"):
                summaries[mode] = evaluate(m, plc_eval_pairs, run_dir, p, EvalConfig(),
                                           seed=args.seed, device=device)

    # ---- summary
    print("\n===== DEMO SUMMARY =====")
    if combined is not None:
        for r in sorted(combined["proposed_runs"], key=lambda x: x["kbps"]):
            print(f"  proposed {r['run']}: {r['kbps']:.2f} kbps | PSNR {r['psnr_mean']:.2f} dB"
                  f" | ST-SIM {r['stsim_mean']:.4f} | enc {r['encoding_delay_ms']:.2f} ms")
        for q, d in sorted(combined["dac_24khz"].items(), key=lambda kv: kv[1]["kbps"]):
            print(f"  backbone n_q={q}: {d['kbps']:.2f} kbps | PSNR {d['psnr_mean']:.2f} dB | "
                  f"ST-SIM {d['stsim_mean']:.4f}")
        for r in combined["vc_pwq_runs"]:
            print(f"  vcpwq b={r['b']}: {r['kbps']:.2f} kbps | PSNR {r['psnr_mean']:.2f} dB | "
                  f"ST-SIM {r['stsim_mean']:.4f}")
    if "uniform" in summaries:
        u = summaries["uniform"]
        print(f"  PLC: PSNR {u['mean_psnr_global_db']:.2f} dB | "
              f"ST-SIM {u['mean_stsim_global']:.4f}")
    print(f"[demo] total {time.time() - t_start:.0f}s", flush=True)
    return {"stages": seconds, "combined": combined, "examples": examples,
            "plc_uniform": summaries.get("uniform"), "plc_category": summaries.get("category"),
            "pairs": pairs, "eval_pairs": eval_pairs, "plc_eval_pairs": plc_eval_pairs}


if __name__ == "__main__":
    main()
