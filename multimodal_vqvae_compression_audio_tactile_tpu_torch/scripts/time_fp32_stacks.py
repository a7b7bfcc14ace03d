"""Time the fp32 residual-unit stacks (K1, K3) beside cuDNN on one CUDA card.

    python3 multimodal_vqvae_compression_audio_tactile_tpu_torch/scripts/time_fp32_stacks.py \\
        [--batch 1 8] [--tag NAME] [--reps 20]

One JSON line a stack: the eight 3-unit stacks of a default 1 s encode and
receiver decode through ``resunit_stack`` (K1, [B, C, T]) and the four
narrow ones through ``resunit_stack_tm`` (K3, [B, T, C]), fp32 with TF32
off, weights and inputs made from a fixed seed; each timed by CUDA events
over ``--reps`` calls after two warm-ups, beside cuDNN's six convolutions of
the same stack ([B, C, T]), with the kernel's bit-equality to (K1) or
largest relative gap from (K3) the plain version. Run by path, it times the
copy of the package that comes first on the path, so setting PYTHONPATH to
another checkout times that one: two checkouts compared in one run on one
card. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

# the checkout this file is in, after anything PYTHONPATH put first
sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm  # noqa: E402

# (C, T, trailing snake) of the default path's stacks at 1 s; C < 256 also
# runs through K3 on the time-major path
STACKS = [(64, 24000, True), (128, 12000, True), (256, 3000, True), (512, 600, True),
          (768, 600, False), (384, 3000, False), (192, 12000, False), (96, 24000, True)]


def units_of(c: int, gen: torch.Generator) -> list:
    units = [resunit.ResUnit(c) for _ in resunit.DILATIONS]
    with torch.no_grad():
        for u in units:
            bound = 1.0 / (7 * c) ** 0.5
            for p in (u.conv1.weight, u.conv1.bias, u.conv2.weight, u.conv2.bias):
                p.uniform_(-bound, bound, generator=gen)
            for s in (u.snake1, u.snake2):
                s.alpha.uniform_(0.5, 1.5, generator=gen)
    return [u.cuda() for u in units]


def events_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cudnn_convs(units: list, x: torch.Tensor) -> torch.Tensor:
    for u, d in zip(units, resunit.DILATIONS):
        h = torch.nn.functional.conv1d(x, u.conv1.weight, None, dilation=d, padding=3 * d)
        x = torch.nn.functional.conv1d(h, u.conv2.weight)
    return x


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_fp32_stacks: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    where = os.path.dirname(os.path.dirname(resunit.__file__))
    for b in args.batch:
        gen = torch.Generator().manual_seed(b)
        for c, t, post in STACKS:
            units = units_of(c, gen)
            x = torch.randn(b, c, t, generator=gen).cuda()
            pa = torch.empty(c).uniform_(0.5, 1.5, generator=gen).cuda() if post else None
            rows = [("resunit_stack", x, resunit.resunit_stack, resunit.resunit_stack_ref)]
            if c < 256:
                rows.append(("resunit_stack_tm", x.transpose(1, 2).contiguous(),
                             resunit_tm.resunit_stack_tm, resunit_tm.resunit_stack_tm_ref))
            for name, xin, kernel, plain in rows:
                got, ref = kernel(units, xin, resunit.DILATIONS, pa), plain(units, xin,
                                                                            resunit.DILATIONS, pa)
                torch.cuda.synchronize()
                print(json.dumps({
                    "tag": args.tag, "package": where, "card": card, "kernel": name, "batch": b,
                    "C": c, "T": t, "bit_equal": bool(torch.equal(got, ref)),
                    "rel_err": float((got - ref).abs().max() / ref.abs().max()),
                    "ms": events_ms(lambda: kernel(units, xin, resunit.DILATIONS, pa), args.reps),
                    "cudnn_ms": events_ms(lambda: cudnn_convs(units, x), args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
