"""Measure the codec's serving latencies; print one JSON map.

    python -m multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.measure_latencies \\
        --backbone CKPT [--sweep-root DIR] [--nq 1,2,4,8] [--tiny] [--cpu]

The map the evaluators consume (``latency_map``), as the JAX package's
script prints it: ``{"backbone": {"1": {"enc_ms", "dec_ms", "enc_p50_ms",
"enc_p95_ms", "dec_p50_ms", "dec_p95_ms"}, ...}, "runs": {"rvqB8_K128":
{...}, ...}, "latency_protocol": ..., "device_time": {...}}``. Each entry
times a 1 s signal at batch 1 in bf16, every stack through K1: the backbone's
``encode_quantized``/``decode`` at each n_q, each sweep run's
``StreamingCodec`` encode and ``decode(z_run)``. On the card each call is
timed by CUDA events from an idle device to its end (``latency_protocol``
"cuda_events_p50"); with ``--cpu`` by the host clock ("host_clock_p50").
``device_time`` is ``StreamingCodec.device_time_ms`` of the last run: the
slope of chained calls, on the card replays of one call captured as a CUDA
graph (``cuda_graph_chain_slope``: the device's time of a call, as the JAX
package's ``device_time``), with ``--cpu`` eager calls by the host clock.
Without ``--cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Optional, Sequence

from ..convert import codec_from_backbones, load_dac
from ..core.config import CodecConfig, EvalConfig
from ..eval import dac_baseline, proposed
from ..eval.serving import StreamingCodec, resolve_device
from ..models.dac import DAC
from ..utils import artifacts


def measure(bb: DAC, cfg: CodecConfig, sweep_root: Optional[str], nq_list: Sequence[int],
            ecfg: EvalConfig = EvalConfig(), device=None,
            log: Callable = lambda *_: None) -> dict:
    """The latency map of the backbone ``bb`` at each n_q of ``nq_list`` and of
    every run under ``sweep_root`` that has a ``best.msgpack``."""
    dev = resolve_device(device)
    bb = bb.to(dev).eval()
    out: dict = {"backbone": {}, "runs": {}}
    for nq in nq_list:
        row = dac_baseline.measure_latency(bb, cfg.dac, nq, ecfg, dev)
        out["backbone"][str(nq)] = row
        log(f"[lat] backbone n_q={nq}: enc p50 {row['enc_p50_ms']:.3f} "
            f"dec p50 {row['dec_p50_ms']:.3f}")
    last = None
    for run in artifacts.discover_runs(sweep_root) if sweep_root else []:
        parsed = artifacts.parse_run_dir(run)
        ckpt_path = os.path.join(run, "best.msgpack")
        if parsed is None or not os.path.isfile(ckpt_path):
            continue
        books, embed = parsed
        modules = codec_from_backbones(bb, bb, ckpt_path, cfg.with_rvq(books, embed))
        name = artifacts.run_dir_name(books, embed)
        row = proposed.measure_latency(modules, books, ecfg, dev)
        out["runs"][name] = row
        log(f"[lat] {name}: enc p50 {row['enc_p50_ms']:.3f} dec p50 {row['dec_p50_ms']:.3f}")
        last = (modules, books, name)
    out["latency_protocol"] = "cuda_events_p50" if dev.type == "cuda" else "host_clock_p50"
    if last is not None:
        modules, books, name = last
        dt = StreamingCodec(modules, batch=1, n_books_use=books,
                            device=dev).device_time_ms(n_lo=4, n_hi=16, reps=2)
        out["device_time"] = {
            "run": name,
            "encode_device_ms": dt["encode_ms_per_batch"],
            "decode_device_ms": dt["decode_ms_per_batch"],
            "protocol": ("cuda_graph_chain_slope" if dev.type == "cuda"
                         else "host_clock_chain_slope"),
        }
        log(f"[lat] chained time ({name}): enc {dt['encode_ms_per_batch']:.3f} "
            f"dec {dt['decode_ms_per_batch']:.3f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backbone", required=True)
    ap.add_argument("--sweep-root", default=None)
    ap.add_argument("--nq", default="1,2,4,8")
    ap.add_argument("--tiny", action="store_true", help="CodecConfig().tiny() checkpoints")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    cfg = CodecConfig().tiny() if args.tiny else CodecConfig()
    out = measure(load_dac(args.backbone, cfg.dac), cfg, args.sweep_root,
                  [int(x) for x in args.nq.split(",")], EvalConfig(), device,
                  log=lambda *a: print(*a, file=sys.stderr, flush=True))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
