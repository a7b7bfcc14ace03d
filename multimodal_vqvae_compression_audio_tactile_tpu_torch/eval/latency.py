"""Latency measurement: the reference's protocol, timed by CUDA events.

Port of the JAX package's ``eval/latency.py``, with its names and return
schemas: 1-second dummy signals, ``warmup`` untimed calls, then ``repeats``
timed ones, in milliseconds; buffer delay = 1000 / tokens_per_sec ms (13.33
ms at 75 tokens/s).

Every timing function takes the device its calls run on. On a CUDA device a
call is timed by two ``torch.cuda.Event``s recorded around it after a
``synchronize``, so a time runs from the moment the call starts, the device
idle, to the moment the device has finished its work: the host's enqueue
and the device's execution both count, as a live stream feels them. On the
CPU (only when the caller asked for it) the host clock times the call,
which computes synchronously.

``measure_device_ms`` keeps the JAX package's chained protocol and keys:
``n`` calls each feed a tiny tanh-squashed scalar of their output into the
next input, so they run one after the other, and the slope between two chain
lengths is the time of one call with every fixed cost (the first enqueue,
the final synchronisation) taken out. The JAX package chains the calls
inside one ``lax.scan`` program, so its slope is the device's time of one
call. On the card the port does the same with a CUDA graph: one chained step
is captured after a warm-up, and a chain is ``n`` replays of it, timed by
CUDA events. A replay issues the step's kernels with no Python between them,
so the slope is the device's time of one call (its kernels plus the short
gaps between them), not the host's enqueue time. A step that cannot be
captured (a host synchronisation inside it, such as ``.item()`` or
``.cpu()``) raises, naming the operation. On the CPU (only when the caller
asked for it) the chain is run eagerly and timed by the host clock.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .serving import resolve_device


def _ms(fn: Callable[[], object], device: torch.device) -> float:
    """One call of ``fn``, in ms, from an idle device to its end."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_ms_stats(fn: Callable[[], object], warmup: int = 3, repeats: int = 10,
                     device=None) -> dict:
    """Latency distribution of ``fn()`` on ``device`` (None: the card):
    mean/p50/p95/min/max ms per call over ``repeats`` calls."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn()
    _sync(dev)
    arr = np.asarray([_ms(fn, dev) for _ in range(repeats)])
    return {"mean": float(arr.mean()), "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)), "min": float(arr.min()),
            "max": float(arr.max())}


def measure_ms(fn: Callable[[], object], warmup: int = 3, repeats: int = 10,
               device=None) -> float:
    """Mean ms per call of ``fn()`` on ``device``."""
    return measure_ms_stats(fn, warmup, repeats, device)["mean"]


def measure_codec_latency_stats(
    encode_fn: Callable[[torch.Tensor, torch.Tensor], object],
    decode_fn: Callable[[object], object],
    sr_native: int = 24000,
    warmup: int = 3,
    repeats: int = 10,
    device=None,
) -> Tuple[dict, dict]:
    """(encode stats, decode stats) for a 1-second zero audio + tactile pair
    [1, 1, sr_native] (fp32, on ``device``); ``encode_fn(a, t)`` -> latents,
    ``decode_fn(latents)`` -> waveform."""
    dev = resolve_device(device)
    a = torch.zeros(1, 1, sr_native, device=dev)
    t = torch.zeros(1, 1, sr_native, device=dev)
    z = encode_fn(a, t)
    enc = measure_ms_stats(lambda: encode_fn(a, t), warmup, repeats, dev)
    dec = measure_ms_stats(lambda: decode_fn(z), warmup, repeats, dev)
    return enc, dec


def measure_codec_latency(encode_fn, decode_fn, sr_native: int = 24000, warmup: int = 3,
                          repeats: int = 10, device=None) -> Tuple[float, float]:
    """(encode_ms, decode_ms) means for the 1-second protocol."""
    enc, dec = measure_codec_latency_stats(encode_fn, decode_fn, sr_native, warmup,
                                           repeats, device)
    return enc["mean"], dec["mean"]


def latency_row(enc: dict, dec: dict) -> dict:
    """One entry of a latency map (``scripts/measure_latencies.py``): the
    means as ``enc_ms``/``dec_ms`` and the p50/p95 columns the evaluators
    read."""
    return {"enc_ms": enc["mean"], "dec_ms": dec["mean"],
            "enc_p50_ms": enc["p50"], "enc_p95_ms": enc["p95"],
            "dec_p50_ms": dec["p50"], "dec_p95_ms": dec["p95"]}


def row_delays(lat: dict) -> dict:
    """A latency-map entry -> the evaluator rows' four delay columns: the
    p50 columns, or the plain means of an older map; p95 NaN when absent."""
    return {"encoding_delay_ms": lat.get("enc_p50_ms", lat.get("enc_ms")),
            "decoding_delay_ms": lat.get("dec_p50_ms", lat.get("dec_ms")),
            "encoding_delay_p95_ms": lat.get("enc_p95_ms", float("nan")),
            "decoding_delay_p95_ms": lat.get("dec_p95_ms", float("nan"))}


def buffer_delay_ms(tokens_per_sec: float) -> float:
    return 1000.0 / tokens_per_sec if tokens_per_sec > 0 else float("nan")


def implausible_reason(r: dict, flops: float = 0.0,
                       peak_tflops: float = 0.0) -> Optional[str]:
    """Why a chained measurement is physically implausible, else None: a
    non-positive slope, a rep-to-rep spread above twice the slope, or (given
    the call's FLOPs) a rate above 105% of the card's peak."""
    ms = r.get("ms_per_call", 0.0)
    if ms <= 0:
        return f"non-positive slope {ms:.4f} ms"
    spread = r.get("slope_spread_ms") or 0.0
    if spread > 2.0 * ms:
        return f"spread {spread:.4f} ms > 2x slope {ms:.4f} ms"
    if flops > 0 and peak_tflops > 0:
        tf = flops / (ms * 1e-3) / 1e12
        if tf > 1.05 * peak_tflops:
            return (f"implied {tf:.1f} TF/s > 105% of {peak_tflops:.0f} "
                    "TF/s chip peak")
    return None


class _LastOp:
    """Records the last aten operation dispatched, so that a failed capture
    can name the operation that broke it."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                rec.last = func
                return func(*args, **(kwargs or {}))

        self.last = None
        self.mode = Mode()


def _capture_step(step_fn: Callable, carry: torch.Tensor, const_args: tuple,
                  device: torch.device) -> "torch.cuda.CUDAGraph":
    """One chained step, ``carry.copy_(step_fn(carry, *const_args))``, as a
    CUDA graph over the static ``carry``, after three warm-up steps on a
    side stream (libraries load, workspaces allocate). Raises RuntimeError
    naming the last operation when the step cannot be captured."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            carry.copy_(step_fn(carry, *const_args))
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph, rec = torch.cuda.CUDAGraph(), _LastOp()
    try:
        with torch.cuda.graph(graph), rec.mode:
            carry.copy_(step_fn(carry, *const_args))
    except Exception as e:
        raise RuntimeError(
            f"measure_device_ms: the step cannot be captured as a CUDA graph; the last "
            f"operation dispatched was {rec.last}: {type(e).__name__}: {e}"
            + (f" (after {e.__context__!r})" if e.__context__ is not None else "")) from e
    return graph


def measure_device_ms(step_fn: Callable, init, n_lo: int = 8, n_hi: int = 40,
                      reps: int = 3, const_args: tuple = (), device=None) -> dict:
    """Device time of one ``step_fn`` call in a chain, as the slope between
    chains of ``n_lo`` and ``n_hi`` calls (see the module docstring).

    ``step_fn(carry, *const_args) -> carry`` keeps the carry's shape and
    keeps it bounded. Each chain starts from ``init`` and ends with one
    scalar reduced from the final carry; it is timed from an idle device to
    its end. On the card a chain is ``n`` replays of one captured step,
    timed by CUDA events; on the CPU ``n`` eager calls, timed by the host
    clock. Returns {"ms_per_call", "slope_ms", "slope_reps_ms",
    "slope_spread_ms", "intercept_ms", "n_lo", "n_hi"}."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        carry = init.clone()
        graph = _capture_step(step_fn, carry, const_args, dev)

        def chain(n):
            carry.copy_(init)
            for _ in range(n):
                graph.replay()
            return carry.float().abs().sum()
    else:
        def chain(n):
            c = init
            for _ in range(n):
                c = step_fn(c, *const_args)
            return c.float().abs().sum()

    def timed(n):
        chain(n)                                   # warm
        _sync(dev)
        return [_ms(lambda: chain(n), dev) for _ in range(reps)]

    ts_lo, ts_hi = timed(n_lo), timed(n_hi)
    slope = (min(ts_hi) - min(ts_lo)) / (n_hi - n_lo)
    rep_slopes = [(h - lo) / (n_hi - n_lo) for lo, h in zip(ts_lo, ts_hi)]
    return {
        "ms_per_call": slope,
        "slope_ms": slope,
        "slope_reps_ms": [round(s, 4) for s in rep_slopes],
        "slope_spread_ms": (round(max(rep_slopes) - min(rep_slopes), 4)
                            if rep_slopes else 0.0),
        "intercept_ms": min(ts_lo) - slope * n_lo,
        "n_lo": n_lo,
        "n_hi": n_hi,
    }
