"""FLOPs, bytes, MFU and roofline accounting.

The port of the JAX package's ``utils/roofline.py``. There the FLOPs and
bytes come from XLA's cost model of the compiled program; here
``compiled_cost`` runs the function once and counts what it executes:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
  convolutions, 2 FLOPs a multiply-accumulate);
- bytes: the summed bytes of every operand and result of every aten
  operation, counted under a ``TorchDispatchMode`` (views left out, as they
  move nothing). This is the unfused count: what the program would move if
  every operation read its inputs from memory and wrote its outputs there.

The function runs on the plain path (``ops/resunit.py::plain_stacks``): the
kernels K1 and K3 are ``ctypes`` calls, which no operator counter sees, so
the count is of the work, whatever implements it.

MFU = achieved FLOP/s over the card's dense bf16 tensor-core peak, for the
reason the JAX package gives: the fp32 paths' work could ride the same
units, so the bf16 peak is the honest denominator for "how far from the
roofline" on either path. Arithmetic intensity (FLOPs / bytes) against the
machine balance (peak FLOP/s / memory bandwidth) classifies a program as
compute- or bandwidth-bound.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# Dense peaks of one card, by a substring of ``torch.cuda.get_device_name``
# (lower case), in order: the bf16 tensor-core rate without sparsity and the
# memory bandwidth. H100 SXM (HBM3, 700 W): 989 TFLOP/s, 3.35 TB/s; H100
# PCIe (HBM2e, 350 W): 756 TFLOP/s, 2.0 TB/s.
GPU_PEAKS = (
    (("h100", "pcie"), {"tflops": 756.0, "hbm_gbps": 2000.0}),
    (("h100", "hbm3"), {"tflops": 989.0, "hbm_gbps": 3350.0}),
    (("h100", "sxm"), {"tflops": 989.0, "hbm_gbps": 3350.0}),
)
# The JAX package's nominal CPU figures, so that a CPU run still fills every
# field; labelled nominal, not a measured host peak.
_CPU_PEAK = {"tflops": 0.1, "hbm_gbps": 50.0}


def device_peaks(device=None) -> dict:
    """{"tflops", "hbm_gbps", "kind"} of ``device`` (None means the card).
    A card not in ``GPU_PEAKS`` raises; the CPU gets the nominal figures."""
    from ..eval.serving import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return {**_CPU_PEAK, "kind": "cpu (nominal peaks)"}
    name = torch.cuda.get_device_name(dev)
    low = name.lower()
    for keys, peaks in GPU_PEAKS:
        if all(k in low for k in keys):
            return {**peaks, "kind": name}
    raise ValueError(f"device_peaks: no peaks known for {name!r}; add it to GPU_PEAKS")


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of each aten
    operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            for t in tree_flatten((args, kwargs or {}, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def compiled_cost(fn: Callable, *args, **kwargs) -> dict:
    """{"flops": float|nan, "bytes": float|nan} of one call ``fn(*args,
    **kwargs)``, run on the plain path under both counters (the module's
    docstring). Never raises: a field is NaN when it cannot be counted."""
    from ..ops.resunit import plain_stacks

    nan = float("nan")
    try:
        flops = FlopCounterMode(display=False)
        byts = _ByteCounter()
        with torch.no_grad(), plain_stacks(), flops, byts:
            fn(*args, **kwargs)
        return {"flops": float(flops.get_total_flops()), "bytes": float(byts.bytes)}
    except Exception:
        return {"flops": nan, "bytes": nan}


def summarize(flops: float, byts: float, ms: float,
              peaks: Optional[dict] = None, calls: int = 1) -> dict:
    """Roofline summary for ``calls`` executions of a program in ``ms`` total.

    Returns gflops_per_call, achieved_tflops, mfu (fraction of the peak),
    achieved_hbm_gbps, hbm_frac, the arithmetic intensity (FLOP/byte), the
    machine balance point, and bound = "compute" | "bandwidth" | "dispatch".
    """
    if peaks is None:
        peaks = device_peaks()
    nan = float("nan")
    sec = ms / 1000.0
    out: dict[str, Any] = {"chip": peaks.get("kind", "?")}
    out["gflops_per_call"] = flops / 1e9 if flops == flops else nan
    if sec > 0 and flops == flops:
        ach_tf = flops * calls / sec / 1e12
        out["achieved_tflops"] = ach_tf
        out["mfu"] = ach_tf / peaks["tflops"]
    else:
        out["achieved_tflops"] = out["mfu"] = nan
    if sec > 0 and byts == byts:
        ach_gb = byts * calls / sec / 1e9
        out["achieved_hbm_gbps"] = ach_gb
        out["hbm_frac"] = ach_gb / peaks["hbm_gbps"]
    else:
        out["achieved_hbm_gbps"] = out["hbm_frac"] = nan
    balance = peaks["tflops"] * 1e12 / (peaks["hbm_gbps"] * 1e9)
    out["machine_balance_flop_per_byte"] = balance
    if flops == flops and byts == byts and byts > 0:
        inten = flops / byts
        out["intensity_flop_per_byte"] = inten
        # a program at under 2% of BOTH peaks is limited by neither: it is
        # bound by dispatch and latency
        if out["mfu"] == out["mfu"] and max(
                out["mfu"], out.get("hbm_frac", 0.0)) < 0.02:
            out["bound"] = "dispatch"
        else:
            out["bound"] = "compute" if inten >= balance else "bandwidth"
    else:
        out["intensity_flop_per_byte"] = nan
        out["bound"] = "unknown"
    return out


def roofline_report(fn: Callable, args: tuple, ms_per_call: float,
                    calls: int = 1, peaks: Optional[dict] = None) -> dict:
    """``compiled_cost`` and ``summarize`` in one step, for ``fn`` at
    ``args`` taking ``ms_per_call``."""
    cost = compiled_cost(fn, *args)
    rep = summarize(cost["flops"], cost["bytes"], ms_per_call * calls,
                    peaks=peaks, calls=calls)
    rep["flops_per_call"] = cost["flops"]
    rep["bytes_per_call"] = cost["bytes"]
    return rep
