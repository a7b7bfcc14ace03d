"""Collect a finished demo's artifacts into one evidence directory.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.collect_evidence \\
        --root R --out O

A copy of the JAX package's ``scripts/collect_evidence.py`` (it imports no
JAX): copies the combined benchmark JSON, the sweep summary, the
rate-distortion figures, the PLC evaluators' summaries and CSVs and a few
example figures from a finished ``demo_end_to_end`` root ``R`` into ``O``,
and writes ``O/SUMMARY.txt`` with the headline numbers (the proposed rows by
bitrate with their entropy-coded rate and codebook usage, the backbone and
VC-PWQ baselines, the PLC masked / unmasked / zero-fill split), so the
evidence reads without opening the JSON. A file the root lacks is reported
and skipped.
"""

import argparse
import glob
import json
import os
import shutil


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    ev = os.path.join(args.root, "sweep", "eval_vs_backbone")
    copied = []
    for src in (
        [os.path.join(ev, "eval_all_vs_backbone_rawPSNR_latency.json")]
        + sorted(glob.glob(os.path.join(ev, "*_vs_*.png")))
        + sorted(glob.glob(os.path.join(ev, "proposed_example_01*.png")))
        + [os.path.join(args.root, "sweep", "sweep_summary.csv")]
        + [os.path.join(args.root, "plc_uniform", "eval_summary.json"),
           os.path.join(args.root, "plc_uniform", "eval_metrics.csv"),
           # the category evaluator's artifact names differ (per-category
           # CSVs + eval_cat_summary.json, mirroring PLC1_low_mid_high_eval)
           os.path.join(args.root, "plc_category", "eval_cat_summary.json")]
        + sorted(glob.glob(os.path.join(args.root, "plc_category",
                                        "eval_metrics_*.csv")))
        + sorted(glob.glob(os.path.join(args.root, "plc_uniform",
                                        "plc_pair_*_wave.png")))[:1]
        + sorted(glob.glob(os.path.join(args.root, "plc_category",
                                        "plc_pair_*_wave.png")))[:1]
    ):
        if not os.path.exists(src):
            print(f"  [missing] {src}")
            continue
        parent = os.path.basename(os.path.dirname(src))
        base = os.path.basename(src)
        dst = os.path.join(
            args.out,
            base if parent.startswith(("eval_vs", "sweep"))
            else f"{parent}_{base}")
        shutil.copy2(src, dst)
        copied.append(dst)
    print(f"[collect] {len(copied)} files -> {args.out}")

    # headline summary
    lines = []
    jpath = os.path.join(ev, "eval_all_vs_backbone_rawPSNR_latency.json")
    if os.path.exists(jpath):
        with open(jpath) as f:
            j = json.load(f)
        lines.append(f"n_pairs = {j['config']['n_pairs']}  "
                     f"(peak_global_raw = {j['config']['peak_global_raw']:.4f})")
        lines.append("")
        lines.append("proposed sweep (cross-modal AR codec):")
        for r in sorted(j["proposed_runs"], key=lambda x: x["kbps"]):
            # final per-book codebook usage from the run's training history:
            # the round-1 review's collapse criterion was bits/book, so the
            # measured entropy rides along with each rate-distortion row.
            vq = ""
            hp = os.path.join(args.root, "sweep", r["run"], "hist.json")
            if os.path.exists(hp):
                with open(hp) as f:
                    h = json.load(f)
                if h.get("vq_bits"):
                    vq = (f" | VQ {h['vq_bits'][-1]:.2f}b/book"
                          f" (min {h['vq_bits_min'][-1]:.2f})")
            coded = r.get("kbps_entropy_coded")
            coded_s = f" ({coded:.2f} coded)" if coded else ""
            lines.append(
                f"  {r['run']:>14}: {r['kbps']:5.2f} kbps{coded_s} | "
                f"PSNR {r['psnr_mean']:.2f} dB | ST-SIM {r['stsim_mean']:.4f}"
                f" | enc {r.get('encoding_delay_ms', float('nan')):.2f} ms"
                + vq)
        lines.append("backbone codec alone:")
        for q, d in sorted(j["dac_24khz"].items(),
                           key=lambda kv: kv[1]["kbps"]):
            lines.append(f"  n_q={q:>2}: {d['kbps']:5.2f} kbps | "
                         f"PSNR {d['psnr_mean']:.2f} dB | "
                         f"ST-SIM {d['stsim_mean']:.4f}")
        lines.append("VC-PWQ (native C++ DWT codec):")
        for r in j["vc_pwq_runs"]:
            lines.append(f"  b={r['b']:>2}: {r['kbps']:5.2f} kbps | "
                         f"PSNR {r['psnr_mean']:.2f} dB | "
                         f"ST-SIM {r['stsim_mean']:.4f}")
    sp = os.path.join(args.root, "plc_uniform", "eval_summary.json")
    if os.path.exists(sp):
        with open(sp) as f:
            s = json.load(f)
        lines.append("plc_uniform:")
        for k in sorted(s):
            if isinstance(s[k], float):
                lines.append(f"  {k} = {s[k]:.4f}")
    sp = os.path.join(args.root, "plc_category", "eval_cat_summary.json")
    if os.path.exists(sp):
        with open(sp) as f:
            s = json.load(f)
        for cat in ("low", "medium", "high"):
            if cat not in s:
                continue
            lines.append(f"plc_category [{cat}]:")
            for k in sorted(s[cat]):
                if isinstance(s[cat][k], float):
                    lines.append(f"  {k} = {s[cat][k]:.4f}")
    out = os.path.join(args.out, "SUMMARY.txt")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"[collect] wrote {out}")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
