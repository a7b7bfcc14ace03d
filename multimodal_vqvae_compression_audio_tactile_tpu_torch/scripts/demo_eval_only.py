"""Evaluation phase of the end-to-end demo, on a root of trained artifacts.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.demo_eval_only \\
        --root R [--seed 7] [--tiny] [--cpu]

The JAX package's ``scripts/demo_eval_only.py`` on a root that holds
``corpus/{audio,tactile}``, ``backbone/best.msgpack``, ``sweep/rvqB*_K*`` and
optionally ``plc_uniform/``: the held-out split ``split_items(pairs, 0.2,
300, seed)``; the VC-PWQ codec, built from ``native/vcpwq`` into
``build/vcpwq/``, run on the corpus at b 8, 24 and 48 unless
``R/vc_decoded`` exists; then ``codec_benchmark``, the evaluation that the
demo's stage 5b runs too: the latencies (``measure_latencies.measure``, in
this process), the backbone baseline at n_q 1, 2, 4, 8, the sweep's runs and
the VC-PWQ rows, written to ``R/sweep/eval_vs_backbone/``
``eval_all_vs_backbone_rawPSNR_latency.json``, the five rate-distortion
figures and the best run's example figures beside it; and, where the root
has a uniform PLC head, the port's uniform PLC evaluator (its CSV and
summary in ``R/plc_uniform/``) with the figures of its top 4 files. The JAX
script draws no example figures here; the demo does, and both share one
function. Where matplotlib is missing, the figures are not drawn and one
line names them; the model work behind them runs all the same. The model
runs on the card, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Tuple

from ..convert import load_dac, load_plc
from ..core.config import CodecConfig, EvalConfig
from ..data.pairs import pair_stems, split_items
from ..eval import dac_baseline, plots, proposed, vcpwq
from ..eval import metrics as M
from ..eval.prepared import prepare_pairs
from ..eval.serving import resolve_device
from ..models.dac import DAC
from ..plc.eval_uniform import eval_plc_uniform
from ..plc.train import plc_config_from_meta
from .eval_codecs import OUT_JSON
from .measure_latencies import measure

NQ = (1, 2, 4, 8)             # the backbone baseline's depths
VC_B_LIST = (8, 24, 48)


def codec_benchmark(bb: DAC, cfg: CodecConfig, eval_pairs: list, sweep_root: str,
                    vc_dirs: Tuple[str, str, str], vc_b_list, device,
                    corpus_knobs: Optional[dict] = None, log=print) -> Tuple[dict, list]:
    """The codec benchmark of a trained root, on ``device``: the latency map
    (``measure_latencies.measure``, in this process), the backbone ``bb``
    (serving as both backbones) at n_q 1, 2, 4, 8, every run under
    ``sweep_root`` and, where ``vc_dirs`` = (decoded, compressed, tactile
    corpus) has decoded files, the VC-PWQ rows at ``vc_b_list``, on
    ``eval_pairs``. Writes ``sweep_root/eval_vs_backbone/`` + ``OUT_JSON``
    (the JAX demo's keys; ``corpus_knobs`` adds the corpus's hardness knobs
    to its config), the rate-distortion figures and the best run's (by
    ST-SIM) example figures of the first 10 pairs there. The examples'
    model work (``eval/plots.py::example_signals``) runs always; the figures
    are drawn where matplotlib is installed, else one line names them.
    -> (the combined JSON, the examples)."""
    ecfg = EvalConfig()
    out_dir = os.path.join(sweep_root, "eval_vs_backbone")
    os.makedirs(out_dir, exist_ok=True)
    peak_global = M.compute_global_peak([t for _, t, _ in eval_pairs])
    t0 = time.time()
    lat = measure(bb, cfg, sweep_root, NQ, ecfg, device)
    log(f"[eval] latencies in {time.time() - t0:.0f}s")
    t0 = time.time()
    prepared = prepare_pairs(eval_pairs, cfg.dac.sample_rate)
    backbones = {"audio": bb, "tactile": bb}
    dac24 = dac_baseline.eval_backbone_codec(bb, cfg.dac, eval_pairs, peak_global, ecfg,
                                             n_q_list=NQ, latency_map=lat["backbone"],
                                             prepared=prepared, log=log, device=device)
    proposed_rows = proposed.eval_proposed_runs(sweep_root, cfg, backbones, eval_pairs,
                                                peak_global, ecfg, latency_map=lat["runs"],
                                                prepared=prepared, log=log, device=device)
    vc_dec, vc_comp, tact_dir = vc_dirs
    vc_rows = (vcpwq.eval_vc_pwq(vc_dec, vc_comp, tact_dir, peak_global, ecfg,
                                 b_list=vc_b_list, log=log)
               if os.path.isdir(vc_dec) else [])
    combined = {
        "dac_24khz": dac24,
        "proposed_runs": proposed_rows,
        "vc_pwq_runs": vc_rows,
        "config": {"eval_sr": ecfg.eval_sr, "peak_global_raw": peak_global,
                   "n_pairs": len(eval_pairs), "synthetic_corpus": True,
                   **(corpus_knobs or {}),
                   "latency_protocol": lat["latency_protocol"],
                   "device_time": lat.get("device_time"),
                   # the "dac_24khz" rows keep the reference's schema but
                   # evaluate the repository's own pretrained backbone
                   "dac_24khz_backbone": "own-pretrained"},
    }
    with open(os.path.join(out_dir, OUT_JSON), "w") as f:
        json.dump(combined, f, indent=2)
    best = plots.best_by_stsim(proposed_rows)
    examples = ([] if best is None else
                plots.example_signals(best, cfg, backbones, eval_pairs, device=device,
                                      peak=peak_global))
    plots.draw_benchmark(dac24, proposed_rows, vc_rows, examples, out_dir, log=log)
    log(f"[eval] codec eval in {time.time() - t0:.0f}s")
    return combined, examples


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tiny", action="store_true", help="CodecConfig().tiny() checkpoints")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    root = args.root
    cfg = CodecConfig().tiny() if args.tiny else CodecConfig()
    tact_dir = os.path.join(root, "corpus", "tactile")
    sweep_root = os.path.join(root, "sweep")
    backbone = os.path.join(root, "backbone", "best.msgpack")
    pairs = pair_stems(os.path.join(root, "corpus", "audio"), tact_dir)
    _, eval_pairs = split_items(pairs, 0.2, 300, args.seed)
    print(f"[eval] {len(eval_pairs)} held-out pairs", flush=True)
    bb = load_dac(backbone, cfg.dac).to(device)

    vc_dec = os.path.join(root, "vc_decoded")
    vc_comp = os.path.join(root, "vc_compressed")
    if not os.path.isdir(vc_dec):
        vcpwq.code_corpus(tact_dir, vc_dec, vc_comp, VC_B_LIST)
    log = lambda *a: print(*a, flush=True)   # noqa: E731
    combined, _ = codec_benchmark(bb, cfg, eval_pairs, sweep_root, (vc_dec, vc_comp, tact_dir),
                                  VC_B_LIST, device, log=log)
    dac24, proposed_rows, vc_rows = (combined[k] for k in
                                     ("dac_24khz", "proposed_runs", "vc_pwq_runs"))

    plc_dir = os.path.join(root, "plc_uniform")
    plc_summary = None
    if os.path.exists(os.path.join(plc_dir, "best.msgpack")):
        pcfg = plc_config_from_meta(plc_dir)
        plc_m = load_plc(backbone, plc_dir, cfg, pcfg.n_layers)
        t0 = time.time()
        plc_summary = eval_plc_uniform(plc_m, eval_pairs, plc_dir, pcfg, EvalConfig(),
                                       seed=args.seed, plot_top_k=4, log=log, device=device)
        print(f"[eval] PLC in {time.time() - t0:.0f}s", flush=True)

    print("\n===== EVAL SUMMARY =====")
    for r in sorted(proposed_rows, key=lambda x: x["kbps"]):
        print(f"  proposed {r['run']}: {r['kbps']:.2f} kbps | PSNR {r['psnr_mean']:.2f} dB | "
              f"ST-SIM {r['stsim_mean']:.4f} | enc {r['encoding_delay_ms']:.2f} ms dec "
              f"{r['decoding_delay_ms']:.2f} ms")
    for q, d in sorted(dac24.items(), key=lambda kv: kv[1]["kbps"]):
        print(f"  backbone n_q={q}: {d['kbps']:.2f} kbps | PSNR {d['psnr_mean']:.2f} dB | "
              f"ST-SIM {d['stsim_mean']:.4f}")
    for r in vc_rows:
        print(f"  vcpwq b={r['b']}: {r['kbps']:.2f} kbps | PSNR {r['psnr_mean']:.2f} dB | "
              f"ST-SIM {r['stsim_mean']:.4f}")
    if plc_summary:
        print(f"  PLC: PSNR {plc_summary['mean_psnr_global_db']:.2f} dB | masked PSNR "
              f"{plc_summary['mean_psnr_masked_db']:.2f} dB | unmasked "
              f"{plc_summary['mean_psnr_unmasked_db']:.2f} dB")
    return {**combined, "plc_uniform": plc_summary}


if __name__ == "__main__":
    main()
