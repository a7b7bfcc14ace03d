"""Tracing and timing helpers.

The port of the JAX package's ``utils/profiling.py``: ``trace`` captures a
region with ``torch.profiler`` (CUDA activity on the card) and writes a
Chrome trace, ``timed`` is a fenced wall-clock timer, and ``annotate``
names a region in the profiler's timeline (and in an NVTX range on the
card). Each takes ``device`` as the entry points do: ``None`` means the
card; the CPU must be asked for.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def _device(device) -> torch.device:
    from ..eval.serving import resolve_device

    return resolve_device(device)


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (CPU activity, and CUDA activity on the
    card) and write it to ``log_dir/trace.json`` (Chrome trace format);
    yields the profiler, whose ``key_averages()`` summarise the region."""
    dev = _device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, results: Optional[dict] = None, log=print,
          device=None) -> Iterator[None]:
    """Wall-clock ms of the enclosed region, fenced on the card by
    ``torch.cuda.synchronize`` at the exit; appended to
    ``results[label]`` and logged."""
    dev = _device(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) * 1000.0
        if results is not None:
            results.setdefault(label, []).append(dt)
        log(f"[timed] {label}: {dt:.3f} ms")


@contextlib.contextmanager
def annotate(name: str, device=None) -> Iterator[None]:
    """A named region: a ``torch.profiler.record_function`` span, and on the
    card an NVTX range."""
    dev = _device(device)
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if dev.type == "cuda":
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
