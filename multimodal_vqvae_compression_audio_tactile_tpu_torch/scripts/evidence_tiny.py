"""Seeded, committable, re-checkable end-to-end evidence, through the port.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.evidence_tiny \\
        check [--root DIR] [--cpu]
    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.evidence_tiny \\
        run [--root DIR] [--art DIR] [--cpu]

The JAX package's ``scripts/evidence_tiny.py`` with the same ``DEMO_FLAGS``,
``KEEP``, ``EVAL_OUTPUTS``, tolerances, ``_headline`` and ``_compare``, on
the port's ``demo_end_to_end`` (run in this process):

  run    the canonical tiny demo (16 synthetic 1-s pairs, tiny backbone, a
         2-head sweep, uniform and category PLC) into ``--root``, then the
         ``KEEP`` paths and a ``MANIFEST.json`` (headline numbers, flags,
         tolerances) into ``--art``;
  check  stage the committed ``artifacts/evidence_tiny`` into a fresh
         ``--root`` without its three evaluation outputs, run the demo
         there (the backbone is reused and the sweep's runs are skipped as
         trained) and compare the regenerated numbers with
         ``MANIFEST.json`` within its tolerances (PSNR 0.2 dB, ST-SIM 0.01,
         kbps 1e-6). Exit 0: the committed evidence reproduces.

``--cpu`` is not among ``DEMO_FLAGS``: the caller passes it, and without it
the demo runs on the card (and raises without one). Departures from the JAX
script:

  - ``check`` adds ``--plc-resume``. The JAX check retrains both PLC heads
    from scratch and gets the committed ones back only because its
    initialisation draws from the JAX generator that wrote them; the port's
    draws from a ``torch.Generator``, so a retrain would be another head and
    no test of the port. With ``--plc-resume`` the committed
    ``last.msgpack`` (epoch 4 of 4) is resumed at its end and nothing
    retrains; the evaluators read the committed heads.
  - ``run`` never writes into ``artifacts/evidence_tiny/``, which belongs to
    the JAX package: it writes into ``--art`` (default
    ``build/evidence_tiny``, which git ignores).
  - ``check`` also holds the regenerated corpus to the committed WAVs,
    byte for byte (the port's ``data/synth.py`` writes the JAX package's
    corpus).
"""

from __future__ import annotations

import argparse
import filecmp
import json
import math
import os
import shutil

from ..eval.serving import resolve_device
from . import demo_end_to_end

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ART = os.path.join(REPO, "artifacts", "evidence_tiny")
BUILD = os.path.join(REPO, "build")

# the canonical tiny run, as the committed MANIFEST.json records it (less --cpu)
DEMO_FLAGS = [
    "--tiny", "--pairs", "16", "--dur-sec", "1",
    "--pretrain-epochs", "8", "--codec-epochs", "6", "--plc-epochs", "4",
    "--plc-latent-epochs", "2", "--batch", "4", "--books-grid", "2,4",
    "--embed-grid", "32", "--cached-heads", "--plc-category",
    "--plc-eval-files", "6", "--plc-layers", "2", "--seed", "7",
]

# (sub)paths of a run kept in the evidence tree
KEEP = [
    "corpus",
    "backbone/best.msgpack",
    "backbone/last.msgpack",
    "backbone/vq_counts.msgpack",
    "backbone/hist.json",
    "sweep",
    "plc_uniform",
    "plc_category",
]

# the evaluation outputs that ``check`` removes and regenerates
EVAL_OUTPUTS = [
    "sweep/eval_vs_backbone/eval_all_vs_backbone_rawPSNR_latency.json",
    "plc_uniform/eval_summary.json",
    "plc_category/eval_cat_summary.json",
]

TOL_DB = 0.2       # PSNR (dB)
TOL_STSIM = 0.01
TOL_KBPS = 1e-6


def _run_demo(root: str, extra: list, stage=None) -> dict:
    argv = ["--root", root] + DEMO_FLAGS + extra
    print("[evidence] demo_end_to_end " + " ".join(argv), flush=True)
    return demo_end_to_end.main(argv, stage=stage)


def _headline(root: str) -> dict:
    """Quality-only summary of a finished run (the comparison contract).

    These are smoke-scale numbers (16 pairs, tiny backbone, 6-epoch heads):
    a seeded reproducibility check of the pipeline, not the framework's
    quality."""
    out: dict = {"proposed": [], "dac_baseline": [], "vc_pwq": []}
    with open(os.path.join(root, EVAL_OUTPUTS[0])) as f:
        ev = json.load(f)
    for r in ev["proposed_runs"]:
        out["proposed"].append({
            "run": r.get("run"), "kbps": r["kbps"],
            "psnr_mean": r["psnr_mean"], "stsim_mean": r["stsim_mean"]})
    for n_q, r in sorted(ev["dac_24khz"].items()):  # keyed by n_quantizers
        out["dac_baseline"].append({
            "n_q": n_q, "kbps": r.get("kbps"), "psnr_mean": r.get("psnr_mean"),
            "stsim_mean": r.get("stsim_mean")})
    for r in ev["vc_pwq_runs"]:
        out["vc_pwq"].append({
            "kbps": r.get("kbps"), "psnr_mean": r.get("psnr_mean"),
            "stsim_mean": r.get("stsim_mean")})
    with open(os.path.join(root, EVAL_OUTPUTS[1])) as f:
        u = json.load(f)
    out["plc_uniform"] = {k: u[k] for k in (
        "mean_psnr_global_db", "mean_stsim_global", "mean_psnr_masked_db",
        "mean_psnr_unmasked_db") if k in u}
    with open(os.path.join(root, EVAL_OUTPUTS[2])) as f:
        c = json.load(f)
    out["plc_category"] = {
        cat: {k: v for k, v in row.items()
              if k.startswith("mean_") or k == "num_files"}
        for cat, row in c.items() if isinstance(row, dict)}
    return out


def _close(a, b, tol: float) -> bool:
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    fa, fb = float(a), float(b)
    if math.isnan(fa) and math.isnan(fb):
        return True
    return abs(fa - fb) <= tol


def _tol_for(key: str) -> float:
    if "kbps" in key:
        return TOL_KBPS
    if "stsim" in key:
        return TOL_STSIM
    return TOL_DB


def _compare(committed: dict, fresh: dict, prefix: str = "") -> list:
    bad = []
    if isinstance(committed, dict):
        for k in committed:
            if k not in fresh:
                bad.append(f"{prefix}{k}: missing in re-run")
                continue
            bad += _compare(committed[k], fresh[k], f"{prefix}{k}.")
    elif isinstance(committed, list):
        if len(committed) != len(fresh):
            bad.append(f"{prefix}: row count {len(fresh)} != "
                       f"{len(committed)}")
        for i, (c, f) in enumerate(zip(committed, fresh)):
            bad += _compare(c, f, f"{prefix}[{i}].")
    elif isinstance(committed, (int, float)):
        key = prefix.rstrip(".")
        if not _close(committed, fresh, _tol_for(key.lower())):
            bad.append(f"{key}: committed {committed} vs re-run {fresh}")
    elif committed != fresh:
        bad.append(f"{prefix.rstrip('.')}: {fresh!r} != {committed!r}")
    return bad


def corpus_mismatches(root: str) -> list:
    """The WAVs of ``root/corpus`` that differ from the committed ones (or
    are missing on either side), by relative path."""
    bad = []
    for sub in ("audio", "tactile"):
        a, b = os.path.join(ART, "corpus", sub), os.path.join(root, "corpus", sub)
        names = sorted(set(os.listdir(a)) | set(os.listdir(b)))
        _, diff, missing = filecmp.cmpfiles(a, b, names, shallow=False)
        bad += [f"corpus/{sub}/{n}" for n in diff + missing]
    return bad


def run(root: str, art: str, cpu: bool = False) -> dict:
    """The canonical demo into ``root`` (unless it has already evaluated),
    then its evidence tree into ``art``; -> the manifest."""
    if os.path.abspath(art) == os.path.abspath(ART):
        raise ValueError(f"run writes its evidence elsewhere than {ART}")
    resolve_device("cpu" if cpu else None)          # no card and no --cpu: raise here
    extra = ["--cpu"] if cpu else []
    if not os.path.exists(os.path.join(root, EVAL_OUTPUTS[0])):
        _run_demo(root, extra)
    if os.path.isdir(art):
        shutil.rmtree(art)
    os.makedirs(art)
    for rel in KEEP:
        src = os.path.join(root, rel)
        dst = os.path.join(art, rel)
        if not os.path.exists(src):
            print(f"[evidence] missing {src}")
            continue
        if os.path.isdir(src):
            # regenerable figures and temporary files stay out
            shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
                "*.wav.tmp", "curves.png", "plc_pair_*_mel.png"))
        else:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(src, dst)
    manifest = {
        "NOTE": ("SMOKE-SCALE pipeline check (16 pairs, tiny config) - do not "
                 "quote these as the framework's quality"),
        "demo_flags": DEMO_FLAGS + extra,
        "smoke_numbers": _headline(root),
        "tolerances": {"psnr_db": TOL_DB, "stsim": TOL_STSIM, "kbps": TOL_KBPS},
    }
    with open(os.path.join(art, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    size = sum(os.path.getsize(os.path.join(d, x)) for d, _, xs in os.walk(art) for x in xs)
    print(f"[evidence] evidence tree: {art} ({size / 1e6:.1f} MB)")
    return manifest


def check(root: str, cpu: bool = False, stage=None) -> dict:
    """Stage the committed tree into ``root`` without its evaluation
    outputs, run the demo there with ``--plc-resume`` and compare; ->
    {"mismatches": [...] (empty: the evidence reproduces), "corpus": the
    corpus WAVs that differ, "committed", "fresh": the headline numbers,
    "demo": what ``demo_end_to_end.main`` returned}."""
    resolve_device("cpu" if cpu else None)          # no card and no --cpu: raise here
    with open(os.path.join(ART, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if os.path.isdir(root):
        shutil.rmtree(root)
    shutil.copytree(ART, root, ignore=shutil.ignore_patterns("MANIFEST.json"))
    for rel in EVAL_OUTPUTS:        # force re-evaluation
        p = os.path.join(root, rel)
        if os.path.exists(p):
            os.remove(p)
    demo = _run_demo(root, ["--plc-resume"] + (["--cpu"] if cpu else []), stage=stage)
    fresh = _headline(root)
    committed = manifest.get("smoke_numbers", manifest.get("headline"))
    return {"mismatches": _compare(committed, fresh), "corpus": corpus_mismatches(root),
            "committed": committed, "fresh": fresh, "demo": demo}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run")
    p_run.add_argument("--root", default=os.path.join(BUILD, "evidence_tiny_run"))
    p_run.add_argument("--art", default=os.path.join(BUILD, "evidence_tiny"))
    p_chk = sub.add_parser("check")
    p_chk.add_argument("--root", default=os.path.join(BUILD, "evidence_tiny_check"))
    for p in (p_run, p_chk):
        p.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        run(args.root, args.art, cpu=args.cpu)
        return 0
    res = check(args.root, cpu=args.cpu)
    bad = res["mismatches"] + [f"{p}: not the committed bytes" for p in res["corpus"]]
    if bad:
        print("[evidence] MISMATCHES:")
        for b in bad:
            print("  " + b)
        return 1
    print("[evidence] PASS: committed evidence reproduces "
          f"({len(json.dumps(res['committed']))} bytes of smoke-scale "
          "numbers within tolerance)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
