"""The codec benchmark: backbone baseline, proposed sweep, VC-PWQ, latency.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.eval_codecs \\
        --audio-dir A --tact-dir T --sweep-root S --backbone CKPT \\
        [--vc-dec-dir D --vc-comp-dir C] [--out-dir O] [--tiny] [--cpu]

The JAX package's ``scripts/eval_codecs.py``: the corpus-wide tactile peak,
the backbone baseline at ``EvalConfig().dac_nq_list``, every ``rvqB*_K*`` run
of the sweep and, given the VC-PWQ codec's output directories, its rows;
written as one JSON with the JAX script's keys
(``eval_all_vs_backbone_rawPSNR_latency.json`` in ``--out-dir``, by default
``S/eval_vs_backbone``), the five rate-distortion figures and the example
figures of the best run by ST-SIM on the first 10 pairs beside it, and a
printed latency summary. Latency is measured in this process (bf16, CUDA
events on the card). The examples' model work runs always; where matplotlib
is missing the figures are not drawn and one line names them. The backbone
checkpoint serves as both the audio and the tactile backbone. The model runs
on the card, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

from ..convert import load_dac
from ..core.config import CodecConfig, EvalConfig
from ..data.pairs import pair_stems
from ..eval import metrics as M
from ..eval import plots
from ..eval.dac_baseline import eval_backbone_codec
from ..eval.proposed import eval_proposed_runs
from ..eval.serving import resolve_device
from ..eval.vcpwq import eval_vc_pwq

OUT_JSON = "eval_all_vs_backbone_rawPSNR_latency.json"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--audio-dir", required=True)
    ap.add_argument("--tact-dir", required=True)
    ap.add_argument("--sweep-root", required=True)
    ap.add_argument("--backbone", required=True)
    ap.add_argument("--vc-dec-dir")
    ap.add_argument("--vc-comp-dir")
    ap.add_argument("--out-dir")
    ap.add_argument("--tiny", action="store_true", help="CodecConfig().tiny() checkpoints")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = CodecConfig().tiny() if args.tiny else CodecConfig()
    ecfg = EvalConfig()
    out_dir = args.out_dir or os.path.join(args.sweep_root, "eval_vs_backbone")
    os.makedirs(out_dir, exist_ok=True)
    pairs = pair_stems(args.audio_dir, args.tact_dir)
    if not pairs:
        raise RuntimeError("No audio/tactile pairs found.")
    print(f"[Pairs] Found {len(pairs)} audio/tactile pairs.")
    peak_global = M.compute_global_peak([t for _, t, _ in pairs])
    print(f"[Global] MAX amplitude over all tactile files = {peak_global:.6f}")

    bb = load_dac(args.backbone, cfg.dac)          # serving as both backbones
    bbs = {"audio": bb, "tactile": bb}
    dac24 = eval_backbone_codec(bb, cfg.dac, pairs, peak_global, ecfg, device=device)
    proposed_rows = eval_proposed_runs(args.sweep_root, cfg, bbs, pairs, peak_global, ecfg,
                                       device=device)
    vc_rows = []
    if args.vc_dec_dir and args.vc_comp_dir:
        vc_rows = eval_vc_pwq(args.vc_dec_dir, args.vc_comp_dir, args.tact_dir,
                              peak_global, ecfg)

    combined = {
        "dac_24khz": dac24,
        "proposed_runs": proposed_rows,
        "vc_pwq_runs": vc_rows,
        "config": {
            "eval_sr": ecfg.eval_sr,
            "orig_tact_sr_baseline": ecfg.orig_tactile_sr,
            "pcm_kbps_tact_orig": ecfg.pcm_kbps_baseline,
            "dac_nq_list": list(ecfg.dac_nq_list),
            "max_align_shift_samples": ecfg.max_align_shift,
            "sweep_root": args.sweep_root,
            "peak_global_raw": peak_global,
            "vc_buffer_delay_ms": ecfg.vc_buffer_ms,
            # the "dac_24khz" rows keep the reference's schema but evaluate
            # the repository's own pretrained backbone
            "dac_24khz_backbone": "own-pretrained",
        },
    }
    out_json = os.path.join(out_dir, OUT_JSON)
    with open(out_json, "w") as f:
        json.dump(combined, f, indent=2)
    print(f"Saved JSON -> {out_json}")
    best = plots.best_by_stsim(proposed_rows)
    examples = ([] if best is None else
                plots.example_signals(best, cfg, bbs, pairs, device=device, peak=peak_global))
    plots.draw_benchmark(dac24, proposed_rows, vc_rows, examples, out_dir)

    print("\n==== Latency summary (ms) ====")
    for q in sorted(dac24, key=lambda q: dac24[q]["kbps"]):
        d = dac24[q]
        print(f"  n_q={q}: enc={d['encoding_delay_ms']:.2f} dec={d['decoding_delay_ms']:.2f} "
              f"buffer={d['buffer_delay_ms']:.2f} kbps={d['kbps']:.2f}")
    for r in sorted(proposed_rows, key=lambda x: x["kbps"]):
        print(f"  {r['run']}: enc={r['encoding_delay_ms']:.2f} "
              f"dec={r['decoding_delay_ms']:.2f} kbps={r['kbps']:.2f}")
    return combined


if __name__ == "__main__":
    main()
