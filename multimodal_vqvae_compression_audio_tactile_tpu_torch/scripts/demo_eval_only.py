"""Evaluation phase of the end-to-end demo, on a root of trained artifacts.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.demo_eval_only \\
        --root R [--seed 7] [--tiny] [--cpu]

The JAX package's ``scripts/demo_eval_only.py`` on a root that holds
``corpus/{audio,tactile}``, ``backbone/best.msgpack``, ``sweep/rvqB*_K*`` and
optionally ``plc_uniform/``: the held-out split ``split_items(pairs, 0.2,
300, seed)``; the VC-PWQ codec, built from ``native/vcpwq`` into
``build/vcpwq/``, run on the corpus at b 8, 24 and 48 unless
``R/vc_decoded`` exists; the latencies (``measure_latencies.measure``, in
this process); the backbone baseline at n_q 1, 2, 4, 8, the sweep's runs and
the VC-PWQ rows, written to ``R/sweep/eval_vs_backbone/``
``eval_all_vs_backbone_rawPSNR_latency.json``; and, where the root has a
uniform PLC head, the port's uniform PLC evaluator (its CSV and summary in
``R/plc_uniform/``). It draws no plots: they are not ported. The model runs
on the card, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..convert import load_dac, load_plc
from ..core.config import CodecConfig, EvalConfig
from ..data.pairs import pair_stems, split_items
from ..eval import metrics as M
from ..eval.dac_baseline import eval_backbone_codec
from ..eval.proposed import eval_proposed_runs
from ..eval.serving import resolve_device
from ..eval.vcpwq import code_corpus, eval_vc_pwq
from ..plc.eval_uniform import eval_plc_uniform
from ..plc.train import plc_config_from_meta
from .eval_codecs import OUT_JSON
from .measure_latencies import measure

VC_B_LIST = (8, 24, 48)


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
    ecfg = EvalConfig()
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
        code_corpus(tact_dir, vc_dec, vc_comp, VC_B_LIST)

    out_dir = os.path.join(sweep_root, "eval_vs_backbone")
    os.makedirs(out_dir, exist_ok=True)
    peak_global = M.compute_global_peak([t for _, t, _ in eval_pairs])

    t0 = time.time()
    lat = measure(bb, cfg, sweep_root, (1, 2, 4, 8), ecfg, device)
    print(f"[eval] latencies in {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    dac24 = eval_backbone_codec(bb, cfg.dac, eval_pairs, peak_global, ecfg,
                                n_q_list=(1, 2, 4, 8), latency_map=lat["backbone"],
                                device=device)
    print(f"[eval] backbone baseline in {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    proposed_rows = eval_proposed_runs(sweep_root, cfg, {"audio": bb, "tactile": bb},
                                       eval_pairs, peak_global, ecfg,
                                       latency_map=lat["runs"], device=device)
    print(f"[eval] proposed sweep in {time.time() - t0:.0f}s", flush=True)
    vc_rows = eval_vc_pwq(vc_dec, vc_comp, tact_dir, peak_global, ecfg, b_list=VC_B_LIST)

    combined = {
        "dac_24khz": dac24,
        "proposed_runs": proposed_rows,
        "vc_pwq_runs": vc_rows,
        "config": {"eval_sr": ecfg.eval_sr, "peak_global_raw": peak_global,
                   "n_pairs": len(eval_pairs), "synthetic_corpus": True,
                   "latency_protocol": lat["latency_protocol"],
                   "device_time": lat.get("device_time"),
                   "dac_24khz_backbone": "own-pretrained"},
    }
    with open(os.path.join(out_dir, OUT_JSON), "w") as f:
        json.dump(combined, f, indent=2)

    plc_dir = os.path.join(root, "plc_uniform")
    plc_summary = None
    if os.path.exists(os.path.join(plc_dir, "best.msgpack")):
        pcfg = plc_config_from_meta(plc_dir)
        plc_m = load_plc(backbone, plc_dir, cfg, pcfg.n_layers)
        t0 = time.time()
        plc_summary = eval_plc_uniform(plc_m, eval_pairs, plc_dir, pcfg, ecfg, seed=args.seed,
                                       device=device)
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
