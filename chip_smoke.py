"""Smoke run of the PyTorch port on one CUDA card: build, check, serve.

    python3 chip_smoke.py [--seed N]

Drives the port's serving round trip (``StreamingCodec.encode_to_bytes`` ->
``decode_from_bytes``) at the full ``CodecConfig().with_rvq(8, 128)`` width,
in its default channels-first configuration (every stack through K1) and in
its time-major one (``time_major``, ``time_major_enc``, ``tail_kernel``,
``poly_upsample``: every narrow stack through K3), and holds every kernel of
the port against its plain PyTorch version. The weights are the round-5
trained checkpoints (``artifacts/r5``) where the checkout has them, else
random ones made from ``--seed``. Phases, one line of numbers each:

0. guard: a hang becomes a traceback and a non-zero exit after 900 s; the
   card's name and power limit;
1. build: the three CUDA libraries compiled from the repository's sources,
   one ``nvcc`` each, all started together, with each kernel's registers,
   spills and shared memory from ptxas (and the dynamic shared memory of
   each tensor-core tile); then ``sass``: the HMMA (tensor-core)
   instructions that ``cuobjdump -sass`` finds in the two stack libraries,
   which must be more than 0 in both;
2. kernel check, each kernel against its plain version on the same inputs:
   K1 (``resunit_stack``) at the eight stack shapes of the default path and
   K3 (``resunit_stack_tm``) at the four narrow ones of the time-major path,
   fp32 (FFMA; max relative error 1e-4, TF32 off; both also against an fp64
   run of the stack) and bf16 (tensor cores; 2e-2), each with its launch
   grid, timed with CUDA events beside the plain version and cuDNN's
   convolutions of the same stack; K2 (``rvq_lookup``)
   at the head RVQ's shapes, ties and ``n_books_use`` included (indices
   equal to the plain version's and to ``ops/rvq.py::rvq_quantize``'s,
   q_sum bit-equal), timed beside the plain version and the score products
   alone as one fp32 ``torch.matmul``;
3. load: the codec's modules, read by the port's own checkpoint reader or
   made from the seed, moved to the card;
4. round trip, default configuration: fp32 and bf16 serving on a 1 s signal
   made from the seed, with the launch counters read around each call (8
   K1 stacks per encode and per receiver decode: 48 launches in fp32, 56 in
   bf16, whose stacks add a prologue each); the receiver's waveform
   against the transmitter's own decode; finite outputs; the fp32 path
   against the same path with every stack through the plain version
   (identical codes); bf16 against fp32 with the continuous-latent
   (< 2.5e-2) and wire-fidelity (within 1%) gates of docs/PARITY.md, taken
   over a batch of 64 one-second streams made from the seed, the single
   streams' ratios and the code agreement reported;
5. head RVQ path: the head RVQ inputs of one fp32 AR roll through
   ``rvq_quantize_fused`` (K2), with its counter read around it, and K2
   checked on them as in phase 2;
6. round trip, time-major configuration, fp32 and bf16: K3's launches per
   encode and per receiver decode (4 stacks: 24 in fp32, 28 in bf16; no
   K1); the fp32 continuous
   latent within 1e-5 of the same configuration with every stack through
   the plain versions and of the default configuration, and the decoder's
   output on one ``z_run`` within 1e-4 of the plain stacks' (codes
   reported); bf16 against fp32 with the PARITY gates over the 64 streams;
   bytes per stream at or below the nominal rate;
7. round trip, ``tail_kernel`` alone (channels-first, K3 between transposes
   and K1 on the wide stacks), bf16, with the same gates, which the same
   configuration with every stack through the plain versions meets too;
8. profile: device time of one bf16 encode and one receiver decode by
   kernel kind (torch.profiler), and the card's busy share, for the default
   and the time-major configuration;
9. small reference: the trained tiny codec of artifacts/evidence_tiny on the
   card against the same codec on the CPU (the plain path).

Then a JSON line of per-kernel numbers and, last, the device line. An error
raises at once; a numeric gate that fails is reported when it fails, and the
script exits non-zero without a result once every phase has run. Needs one
card; refuses to run without one.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import faulthandler
import json
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from multimodal_vqvae_compression_audio_tactile_tpu_torch import _build
from multimodal_vqvae_compression_audio_tactile_tpu_torch.convert import load_codec
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingCodec
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar, dac
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm, rvq, vq

# Published dense peaks of one H100 SXM at 700 W: fp32 outside the tensor
# cores, bf16 in them, and HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (C, T, trailing snake) of every stack on the default path at 1 s: the
# encoder's four blocks (each with its block snake) and the decoder's four
# (the last one carrying the decoder's out_snake).
STACKS = [(64, 24000, True), (128, 12000, True), (256, 3000, True),
          (512, 600, True), (768, 600, False), (384, 3000, False),
          (192, 12000, False), (96, 24000, True)]
# the narrow ones (C < 256), which the time-major path sends to K3
TM_STACKS = [s for s in STACKS if s[0] < dac.NARROW]
# (n_books, K, N, n_books_use, duplicated rows) of the head RVQ (D = 96):
# one AR chunk at batch 1; batch 32 x 75 tokens at K = 512; fewer books used
# than held; exact ties
RVQ_CASES = [(8, 128, 16, None, False), (10, 512, 2400, None, False),
             (3, 128, 75, 2, False), (4, 128, 300, None, True)]
PKG = "multimodal_vqvae_compression_audio_tactile_tpu"
KERNELS = {   # name -> (module with the wrapper and its counter, source, TPU kernel)
    "resunit_stack": (resunit, f"{PKG}_torch/csrc/resunit_stack.cu",
                      f"{PKG}/ops/resunit_pallas.py:159"),
    "resunit_stack_tm": (resunit_tm, f"{PKG}_torch/csrc/resunit_stack_tm.cu",
                         f"{PKG}/ops/resunit_tm_pallas.py:198"),
    "rvq_lookup": (vq, f"{PKG}_torch/csrc/rvq_lookup.cu", f"{PKG}/ops/vq_pallas.py:85"),
}
# One-second streams over which the bf16-against-fp32 gates are taken. With
# trained weights one stream's wire-fidelity ratio moves by a few percent
# from signal to signal in every configuration, plain stacks or kernels:
# each bf16 code flip re-routes the AR roll. A 1% gate needs the pooled
# error of many streams (docs/PARITY.md's own check pools 4).
PARITY_STREAMS = 64
TIME_MAJOR = dict(time_major=True, time_major_enc=True, tail_kernel=True,
                  poly_upsample=True)
ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")
R5 = (os.path.join(ARTIFACTS, "r5", "backbone_best.msgpack"),
      os.path.join(ARTIFACTS, "r5", "rvqB8_K128", "best.msgpack"))
T0 = time.perf_counter()
FAILED: list = []      # numeric gates that failed; checked once all phases ran


def gate(ok: bool, what: str) -> None:
    if not ok:
        FAILED.append(what)
        print(f"GATE FAILED: {what}", file=sys.stderr, flush=True)


def say(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3),
                      **numbers}), flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps`` calls."""
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).split(".")[-1]


class Record:
    """One kernel's sums over the shapes it was checked at, per dtype: its
    time, its plain version's, the library call's, its bound and the worst
    absolute error against the plain version."""

    KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms")

    def __init__(self):
        self.sums: dict = {}
        self.max_abs_err: dict = {}

    def add(self, dt: torch.dtype, abs_err: float, **ms) -> None:
        tot = self.sums.setdefault(dt, dict.fromkeys(self.KEYS, 0.0))
        for k in self.KEYS:
            tot[k] += ms[k]
        self.max_abs_err[dt] = max(self.max_abs_err.get(dt, 0.0), abs_err)

    def report(self, name: str) -> None:
        for dt, tot in self.sums.items():
            say("kernel_totals", kernel=name, dtype=dtype_name(dt),
                max_abs_err=self.max_abs_err[dt], **tot)

    def line(self, name: str, dt: torch.dtype, launches: int) -> dict:
        """The kernel's entry in the ``kernels`` line, at ``dt``."""
        _, source, replaces = KERNELS[name]
        tot = self.sums[dt]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": self.max_abs_err[dt],
                "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
                "library_ms": tot["library_ms"]}


def bound(flops: float, nbytes: float, dt: torch.dtype) -> dict:
    ops_ms, bytes_ms = flops / PEAK_FLOPS[dt] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def stack_bound(c: int, t: int, dt: torch.dtype) -> dict:
    """Least time for one 3-unit stack at [1, C, T] or [1, T, C]: 16 C^2 T
    flops per unit against x read once, the output written once and each
    weight read once."""
    size = torch.finfo(dt).bits // 8
    return bound(3 * 16 * c * c * t, 2 * c * t * size + 3 * (8 * c * c * size + 4 * c * 4), dt)


def make_units(c: int, gen: torch.Generator, dev) -> list:
    units = [resunit.ResUnit(c) for _ in resunit.DILATIONS]
    with torch.no_grad():
        for u in units:
            bound_w = 1.0 / (7 * c) ** 0.5
            for p in (u.conv1.weight, u.conv1.bias, u.conv2.weight, u.conv2.bias):
                p.uniform_(-bound_w, bound_w, generator=gen)
            for s in (u.snake1, u.snake2):
                s.alpha.uniform_(0.5, 1.5, generator=gen)
    return [u.to(dev) for u in units]


def stack_fp64(units, x, post_alpha):
    """The stack on [B, C, T] in fp64 throughout, written out here
    independently of the port: the yardstick for both fp32 versions'
    rounding."""
    def sn(v, a):
        a = a.double()[None, :, None]
        return v + torch.sin(a * v) ** 2 / (a + 1e-9)

    x = x.double()
    for u, d in zip(units, resunit.DILATIONS):
        acc = torch.nn.functional.conv1d(sn(x, u.snake1.alpha), u.conv1.weight.double(),
                                         u.conv1.bias.double(), dilation=d, padding=3 * d)
        x = x + torch.nn.functional.conv1d(sn(acc, u.snake2.alpha), u.conv2.weight.double(),
                                           u.conv2.bias.double())
    return x if post_alpha is None else sn(x, post_alpha)


def cudnn_convs(units, x):
    """The stack's convolutions alone on [B, C, T], through cuDNN (the
    library yardstick)."""
    for u, d in zip(units, resunit.DILATIONS):
        h = torch.nn.functional.conv1d(x, u.conv1.weight.to(x.dtype), None,
                                       dilation=d, padding=3 * d)
        x = torch.nn.functional.conv1d(h, u.conv2.weight.to(x.dtype))
    return x


@torch.no_grad()
def check_stacks(name: str, stacks: list, time_major: bool, gen: torch.Generator) -> Record:
    """K1 (channels-first) or K3 (time-major) against its plain version at
    ``stacks``; the fp64 stack and cuDNN run on [1, C, T], the transposes
    made outside the timed region."""
    mod = resunit_tm if time_major else resunit
    kernel = resunit_tm.resunit_stack_tm if time_major else resunit.resunit_stack
    plain = resunit_tm.resunit_stack_tm_ref if time_major else resunit.resunit_stack_ref
    rec, dev, dils = Record(), torch.device("cuda"), resunit.DILATIONS
    for c, t, post in stacks:
        units = make_units(c, gen, dev)
        x32 = torch.randn(1, c, t, generator=gen).to(dev)
        pa = torch.empty(c).uniform_(0.5, 1.5, generator=gen).to(dev) if post else None
        exact = stack_fp64(units, x32, pa)
        for dt in TOL:
            x_nch = x32.to(dt)
            x = x_nch.transpose(1, 2).contiguous() if time_major else x_nch
            before = mod.launches
            got = kernel(units, x, dils, pa)
            ref = plain(units, x, dils, pa)
            torch.cuda.synchronize()
            gate(mod.launches == before + resunit.stack_launches(len(units), dt),
                 f"{name} did not launch")
            err = rel_err(got, ref)
            abs_err = float((got.float() - ref.float()).abs().max())
            gate(bool(torch.isfinite(got).all()) and err <= TOL[dt],
                 f"{name} vs plain at C={c} T={t} {dt}: rel {err:.3e} > {TOL[dt]:.0e}")
            vs64 = {}
            if dt == torch.float32:
                # both fp32 versions against fp64: each must err by sum order only
                to_nch = (lambda y: y.transpose(1, 2)) if time_major else (lambda y: y)
                vs64 = {"kernel_vs_fp64": rel_err(to_nch(got), exact),
                        "plain_vs_fp64": rel_err(to_nch(ref), exact)}
                gate(max(vs64.values()) <= TOL[dt],
                     f"{name} fp32 vs fp64 at C={c} T={t}: {vs64}")
            ms = {"ms": cuda_ms(lambda: kernel(units, x, dils, pa)),
                  "plain_ms": cuda_ms(lambda: plain(units, x, dils, pa)),
                  "library_ms": cuda_ms(lambda: cudnn_convs(units, x_nch)),
                  **stack_bound(c, t, dt)}
            rec.add(dt, abs_err, **ms)
            grid = resunit.launch_grid(c, t, 1, dt)
            say("kernel_check", kernel=name, C=c, T=t, dtype=dtype_name(dt),
                grid=grid, blocks=grid[0] * grid[1] * grid[2],
                tile=resunit.pick_tile(c, t) if dt == torch.bfloat16 else resunit.FFMA_TILE,
                rel_err=err, max_abs_err=abs_err, **vs64, **ms)
    rec.report(name)
    return rec


def rvq_bound(n: int, k: int, d: int, use: int) -> dict:
    """The score products (2 N K D per book) on the fp32 units against x and
    the books read once and q_sum and the indices written once."""
    return bound(2 * n * k * d * use, 4 * (2 * n * d + use * k * d + n * use),
                 torch.float32)


@torch.no_grad()
def check_rvq(rec: Record, case: str, books: torch.Tensor, x: torch.Tensor,
              use=None) -> None:
    """K2 against its plain version and against ``ops/rvq.py::rvq_quantize``
    on x [N, D]: indices equal, q_sum bit-equal to the plain version's."""
    before = vq.launches
    q, idx = vq.rvq_lookup_fused(books, x, use)
    q_ref, idx_ref = vq.rvq_lookup_ref(books, x, use)
    _, idx_rvq = rvq.rvq_quantize(books, x.T[None], use)
    torch.cuda.synchronize()
    gate(vq.launches == before + 1, "rvq_lookup did not launch")
    same_ref = bool(torch.equal(idx, idx_ref))
    same_rvq = bool(torch.equal(idx, idx_rvq[0]))
    q_bits = bool(torch.equal(q, q_ref))
    abs_err = float((q - q_ref).abs().max())
    gate(same_ref and q_bits and same_rvq,
         f"rvq_lookup {case}: indices equal to plain {same_ref}, to rvq_quantize "
         f"{same_rvq}; q_sum bit-equal {q_bits}")
    n_use = idx.shape[1]
    sel = books[:n_use].float()
    ms = {"ms": cuda_ms(lambda: vq.rvq_lookup_fused(books, x, use)),
          "plain_ms": cuda_ms(lambda: vq.rvq_lookup_ref(books, x, use), reps=3),
          "library_ms": cuda_ms(lambda: torch.matmul(x[None], sel.transpose(1, 2))),
          **rvq_bound(x.shape[0], books.shape[1], x.shape[1], n_use)}
    rec.add(torch.float32, abs_err, **ms)
    say("kernel_check", kernel="rvq_lookup", case=case, N=x.shape[0], books=n_use,
        K=books.shape[1], indices_equal_plain=same_ref, indices_equal_rvq_quantize=same_rvq,
        q_sum_bit_equal=q_bits, max_abs_err=abs_err, **ms)


def check_rvq_cases(gen: torch.Generator) -> None:
    rec, dev, D = Record(), torch.device("cuda"), 96
    for n_books, K, N, use, dup in RVQ_CASES:
        books = torch.randn(n_books, K, D, generator=gen) / D ** 0.5
        if dup:
            books[:, K // 2:] = books[:, :K // 2]      # every score tied with an earlier one
        x = torch.randn(N, D, generator=gen)
        check_rvq(rec, f"N{N}_books{n_books}_K{K}_use{use}{'_ties' if dup else ''}",
                  books.to(dev), x.to(dev), use)
    rec.report("rvq_lookup")


def signal(seed: int, frame: int) -> tuple:
    """1 s of audio and tactile-like signal: a few partials plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(frame) / 24000.0
    out = []
    for _ in range(2):
        f = rng.uniform(80.0, 2000.0, size=4)
        x = sum(0.1 * np.sin(2 * np.pi * fi * t + rng.uniform(0, 6.3)) for fi in f)
        out.append((x + 0.02 * rng.standard_normal(frame)).astype(np.float32)[None, None])
    return out[0], out[1]


def signals(seed: int, n: int, frame: int) -> tuple:
    """``n`` streams, the first the main path's signal: [n, 1, frame] each."""
    pairs = [signal(seed + i, frame) for i in range(n)]
    return tuple(np.concatenate(x) for x in zip(*pairs))


def counted(fn):
    """Run ``fn`` with every kernel's launch counter set to 0 just before;
    -> (result, {kernel: launches}, host ms to the synchronised end)."""
    torch.cuda.synchronize()
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, {name: mod.launches for name, (mod, _, _) in KERNELS.items()},
            (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def plain_stacks():
    """Run the model's residual-unit stacks through the plain PyTorch versions
    (for an end-to-end comparison; the kernels' counters do not move)."""
    dac.resunit_stack = resunit.resunit_stack_ref
    dac.resunit_stack_tm = resunit_tm.resunit_stack_tm_ref
    try:
        yield
    finally:
        dac.resunit_stack = resunit.resunit_stack
        dac.resunit_stack_tm = resunit_tm.resunit_stack_tm


def serve(m, name: str, fast: bool, a, tc, expect: dict, flags: dict) -> dict:
    """One configuration's bytes round trip with its launch counts gated,
    its latencies, its wire rate and the tactile encoder's continuous latent.
    ``fast`` serves in bf16, else in fp32."""
    sc = StreamingCodec(m, batch=1, frame_sec=1.0, fast=fast, compute_dtype=dtype_of(fast),
                        **flags)
    streams, n_enc, enc_host_ms = counted(lambda: sc.encode_to_bytes(a, tc))
    y, n_dec, dec_host_ms = counted(lambda: sc.decode_from_bytes(a, streams))
    gate(n_enc == expect and n_dec == expect,
         f"{name}: launches encode {n_enc} / decode {n_dec}, expected {expect} each")
    gate(y.shape == (1, 1, 24000) and bool(torch.isfinite(y).all()),
         f"{name}: decoded waveform not finite or mis-shaped")
    z_run, codes = sc.encode(a, tc)
    y_tx = sc.decode(z_run)
    rx_vs_tx = rel_err(y, y_tx)
    enc_ms = cuda_ms(lambda: sc.encode(a, tc), reps=5)
    dec_ms = cuda_ms(lambda: sc.decode_from_codes(a, codes), reps=5)
    with torch.no_grad(), fp32_exact(not fast):
        zc = m.tactile_dac.encoder(torch.from_numpy(tc).cuda().to(sc.dtype),
                                   sc.cfg.dac).float()
    nbytes = len(streams[0])
    say("round_trip", mode=name, launches_encode=n_enc, launches_decode=n_dec,
        encode_ms=enc_ms, decode_ms=dec_ms, encode_to_bytes_host_ms=enc_host_ms,
        decode_from_bytes_host_ms=dec_host_ms, bytes_per_stream=nbytes,
        kbps=nbytes * 8 / 1000.0, nominal_kbps=sc.cfg.kbps(),
        receiver_vs_transmitter_rel_err=rx_vs_tx)
    gate(rx_vs_tx <= (5e-2 if fast else 1e-3),
         f"{name}: receiver decode differs from the transmitter's by {rx_vs_tx:.3e}")
    gate(nbytes * 8 / 1000.0 <= sc.cfg.kbps(),
         f"{name}: {nbytes * 8 / 1000.0} kbps above the nominal {sc.cfg.kbps()}")
    return {"codec": sc, "codes": codes.cpu().numpy(), "z_run": z_run.float(), "zc": zc,
            "y": y, "launches": {k: n_enc[k] + n_dec[k] for k in n_enc}}


@torch.no_grad()
def latents(m, fast: bool, flags: dict, streams: tuple) -> dict:
    """One configuration's encode of a batch of streams: the wire's latent,
    the codes and the tactile encoder's continuous latent."""
    a, tc = streams
    sc = StreamingCodec(m, batch=a.shape[0], frame_sec=1.0, fast=fast,
                        compute_dtype=dtype_of(fast), **flags)
    z_run, codes = sc.encode(a, tc)
    with fp32_exact(not fast):
        zc = m.tactile_dac.encoder(torch.from_numpy(tc).cuda().to(sc.dtype), sc.cfg.dac)
    return {"z_run": z_run.float(), "zc": zc.float(), "codes": codes.cpu().numpy()}


def parity(name: str, f32: dict, b16: dict) -> None:
    """bf16 against fp32 over a batch of streams: docs/PARITY.md's
    continuous-latent and wire-fidelity gates, the latter on the squared
    wire error pooled over the streams. Code agreement and the single
    streams' ratios are reported, not gated. PARITY.md's 0.97 holds two
    bf16 implementations against each other; bf16 against fp32 moves the
    latent by ~0.3-1%, as large as the residual that the deeper books
    quantize, and the AR roll carries each flip into the next chunk. The JAX
    package's own bf16 serving agrees with its fp32 on 0.81-0.92 of book 0
    and 0.08-0.16 of book 7 with the trained round-5 weights
    (tests/test_torch_allpred_ar.py::test_r5_bf16_agrees_with_fp32_as_jax_does)."""
    z_err = rel_err(b16["zc"], f32["zc"])
    agree = (b16["codes"] == f32["codes"]).mean(axis=(0, 1))
    ref = f32["zc"]
    sq = {k: ((r["z_run"] - ref) ** 2).mean(dim=(1, 2))      # per stream
          for k, r in (("fp32", f32), ("bf16", b16))}
    power = float((ref ** 2).mean())
    fid = {k: float(v.mean()) / power for k, v in sq.items()}
    ratio = fid["bf16"] / max(fid["fp32"], 1e-12)
    single = (sq["bf16"] / sq["fp32"].clamp_min(1e-30)).double().cpu().numpy()
    say("parity_bf16_vs_fp32", mode=name, streams=len(single), z_continuous_rel_err=z_err,
        per_book_code_agreement=[float(x) for x in agree],
        code_agreement=float(agree.mean()), wire_fidelity_relmse=fid,
        fidelity_ratio=ratio, single_stream_ratio_first=float(single[0]),
        single_stream_ratio_min=float(single.min()),
        single_stream_ratio_max=float(single.max()),
        single_stream_ratio_std=float(single.std()),
        single_streams_outside_1pct=int((abs(single - 1.0) >= 1e-2).sum()))
    gate(z_err < 2.5e-2, f"{name}: bf16 continuous-latent rel err {z_err:.3e} >= 2.5e-2")
    gate(abs(ratio - 1.0) < 1e-2, f"{name}: bf16 wire-fidelity ratio {ratio:.4f} not within 1%")


def dtype_of(fast: bool) -> torch.dtype:
    return torch.bfloat16 if fast else torch.float32


def expect(fast: bool, k1: int = 0, k3: int = 0) -> dict:
    """Launches of k1 K1 stacks and k3 K3 stacks of 3 units each."""
    per_stack = resunit.stack_launches(len(resunit.DILATIONS), dtype_of(fast))
    return {"resunit_stack": k1 * per_stack, "resunit_stack_tm": k3 * per_stack,
            "rvq_lookup": 0}


def round_trip(m: allpred_ar.CodecModules, a, tc, many: tuple) -> dict:
    """The default configuration: every stack through K1, 2 encoders x 4
    stacks on encode, encoder + decoder likewise on the receiver's decode.
    Its fp32 encode of the ``many`` streams is every bf16 parity's reference."""
    res = {name: serve(m, name, fast, a, tc, expect(fast, k1=8), {})
           for name, fast in (("fp32", False), ("bf16", True))}
    # the fp32 main path with every stack through the plain version instead
    sc = res["fp32"]["codec"]
    with plain_stacks():
        (_, codes_p), n_enc, _ = counted(lambda: sc.encode(a, tc))
        y_p, n_dec, _ = counted(lambda: sc.decode_from_codes(a, codes_p))
    gate(not any(n_enc.values()) and not any(n_dec.values()), "plain run launched a kernel")
    same = bool((codes_p.cpu().numpy() == res["fp32"]["codes"]).all())
    y_err = rel_err(res["fp32"]["y"], y_p)
    say("kernel_vs_plain_fp32_end_to_end", mode="default", codes_identical=same,
        waveform_rel_err=y_err)
    gate(same, "fp32 codes through K1 differ from the plain path's")
    gate(y_err <= 1e-4, f"fp32 waveform through K1 differs from the plain path's by {y_err:.3e}")
    res["fp32_many"] = latents(m, False, {}, many)
    parity("default", res["fp32_many"], latents(m, True, {}, many))
    return res


def time_major_round_trip(m: allpred_ar.CodecModules, a, tc, many: tuple,
                          default: dict) -> dict:
    """The time-major configuration: the narrow stacks through K3 (2 encoders
    x 2 stacks on encode; the audio encoder's 2 and the decoder's 2 on the
    receiver's decode), the wide ones through the time-major chain, no K1."""
    res = {name: serve(m, f"time_major_{name}", fast, a, tc, expect(fast, k3=4), TIME_MAJOR)
           for name, fast in (("fp32", False), ("bf16", True))}
    f32 = res["fp32"]
    sc = f32["codec"]
    x_tc = torch.from_numpy(tc).cuda()
    with torch.no_grad(), plain_stacks(), fp32_exact():
        (zc_p, (_, codes_p), y_p), counts, _ = counted(lambda: (
            m.tactile_dac.encoder(x_tc, sc.cfg.dac).float(), sc.encode(a, tc),
            sc.decode(f32["z_run"])))
    gate(not any(counts.values()), f"plain time-major run launched a kernel: {counts}")
    y_k = sc.decode(f32["z_run"])
    zc_err = rel_err(f32["zc"], zc_p)
    dec_err = rel_err(y_k, y_p)
    zc_vs_default = rel_err(f32["zc"], default["fp32"]["zc"])
    agree = float((codes_p.cpu().numpy() == f32["codes"]).mean())
    say("kernel_vs_plain_fp32_end_to_end", mode="time_major", zc_rel_err=zc_err,
        decoder_rel_err_same_z_run=dec_err, code_agreement_vs_plain=agree,
        zc_rel_err_vs_default_config=zc_vs_default,
        code_agreement_vs_default_config=float((f32["codes"] == default["fp32"]["codes"]).mean()))
    gate(zc_err <= 1e-5, f"time-major fp32 latent through K3 differs from plain by {zc_err:.3e}")
    gate(dec_err <= 1e-4, f"time-major fp32 decode through K3 differs from plain by {dec_err:.3e}")
    gate(zc_vs_default <= 1e-5,
         f"time-major fp32 latent differs from the default configuration's by {zc_vs_default:.3e}")
    parity("time_major", default["fp32_many"], latents(m, True, TIME_MAJOR, many))
    return res


def tail_kernel_round_trip(m, a, tc, many: tuple, default: dict) -> dict:
    """``tail_kernel`` alone, channels-first, bf16: the narrow stacks through
    K3 between transposes, the wide ones through K1 (2 a side of each 4-stack
    backbone); held to the default configuration's fp32, as is the same
    configuration through the plain stacks."""
    flags = {"tail_kernel": True}
    b16 = serve(m, "tail_kernel_bf16", True, a, tc, expect(True, k1=4, k3=4), flags)
    parity("tail_kernel", default["fp32_many"], latents(m, True, flags, many))
    with plain_stacks():
        plain = latents(m, True, flags, many)
    parity("tail_kernel_plain_stacks", default["fp32_many"], plain)
    return b16


@torch.no_grad()
def head_rvq_path(m: allpred_ar.CodecModules, a, tc) -> tuple:
    """The head RVQ inputs of one fp32 AR roll (one [1, 96, 16] chunk at a
    time) through ``rvq_quantize_fused`` with the counters at 0 just before;
    then K2 checked on each chunk as in the kernel check. -> (K2's launches,
    its record over the chunks)."""
    sc = StreamingCodec(m, batch=1, frame_sec=1.0, fast=False, compute_dtype=torch.float32)
    inputs = []

    def capture(books, z, n_books_use=None):
        inputs.append(z.detach().clone())
        return rvq.rvq_quantize(books, z, n_books_use)

    allpred_ar.rvq_quantize = capture
    try:
        _, codes = sc.encode(a, tc)
    finally:
        allpred_ar.rvq_quantize = rvq.rvq_quantize
    books = m.head.vq_books.detach()
    out, counts, host_ms = counted(lambda: [vq.rvq_quantize_fused(books, z) for z in inputs])
    fused = torch.cat([idx for _, idx in out], dim=1)[:, :codes.shape[1]]
    same = bool(torch.equal(fused, codes))
    say("head_rvq_path", chunks=len(inputs), launches=counts, host_ms=host_ms,
        codes_equal_ar_roll=same)
    gate(counts["rvq_lookup"] == len(inputs) > 0, f"K2 launches {counts}")
    gate(same, "K2 codes differ from the AR roll's")
    rec = Record()
    for i, z in enumerate(inputs):
        check_rvq(rec, f"ar_roll_chunk{i}", books, z[0].T.contiguous())
    rec.report("rvq_lookup")
    return counts["rvq_lookup"], rec


def kind_of(kernel: str) -> str:
    k = kernel.lower()
    if "mma_unit_kernel" in k or "prologue_kernel" in k:
        # the tensor-core stacks: the template's CF flag is true for K1
        head = k.replace("(anonymous namespace)", "").split("(")[0]
        return "K1 resunit_stack" if "true" in head else "K3 resunit_stack_tm"
    if "unit_tm_kernel" in k:
        return "K3 resunit_stack_tm"
    if "unit_conv_kernel" in k:
        return "K1 resunit_stack"
    if "rvq_kernel" in k:
        return "K2 rvq_lookup"
    if any(s in k for s in ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad")):
        return "cuDNN convolution"
    if any(s in k for s in ("gemm", "cutlass", "sm90_", "gemv", "cublas")):
        return "matmul"
    return "elementwise and other"


def profile_phase(name: str, sc: StreamingCodec, a, tc, codes) -> None:
    """Device time of one bf16 encode and one receiver decode, by kernel kind,
    from torch.profiler's CUDA kernel events; busy share = kernel time over
    the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = {"encode": lambda: sc.encode(a, tc),
             "decode_from_codes": lambda: sc.decode_from_codes(a, codes)}
    for call, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_kind: dict = {}
        for e in kernels:
            kind = kind_of(e.name)
            ms, n = by_kind.get(kind, (0.0, 0))
            by_kind[kind] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy = sum(ms for ms, _ in by_kind.values())
        say("profile", mode=name, call=call, wall_ms_profiled=wall_ms, device_ms=busy,
            busy_share=busy / wall_ms if wall_ms else None, kernels=len(kernels),
            by_kind={k: {"ms": ms, "launches": n} for k, (ms, n) in
                     sorted(by_kind.items(), key=lambda kv: -kv[1][0])})


def small_reference(seed: int) -> None:
    """The trained tiny codec of artifacts/evidence_tiny, read by the port's
    checkpoint reader, on the card (through K1) against the CPU (plain path)."""
    root = os.path.join(ARTIFACTS, "evidence_tiny")
    m_cpu = load_codec(os.path.join(root, "backbone", "best.msgpack"),
                       os.path.join(root, "sweep", "rvqB4_K32", "best.msgpack"),
                       CodecConfig().tiny().with_rvq(4, 32))
    m_gpu = copy.deepcopy(m_cpu).cuda()
    a, tc = (torch.from_numpy(x) for x in signal(seed + 1, 24000))
    _, codes_c = allpred_ar.encode_latents(m_cpu, a, tc)
    _, codes_g = allpred_ar.encode_latents(m_gpu, a.cuda(), tc.cuda())
    agree = float((codes_c == codes_g.cpu()).float().mean())
    y_c = allpred_ar.decode_from_codes(m_cpu, a, codes_c)
    y_g, counts, _ = counted(lambda: allpred_ar.decode_from_codes(m_gpu, a.cuda(),
                                                                   codes_c.cuda()))
    err = rel_err(y_g.cpu(), y_c)
    say("small_reference", code_agreement=agree, waveform_rel_err=err,
        k1_launches=counts["resunit_stack"])
    gate(agree == 1.0 and err <= 1e-4 and counts["resunit_stack"] == 48,
         "the trained tiny codec on the card disagrees with the CPU")


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers, stack, spill bytes and static shared memory,
    as ``nvcc -Xptxas -v`` printed them, by demangled-ish name."""
    out = {}
    for m in re.finditer(r"entry function '(\S+)'.*?\n(?:.*Function properties.*\n)?\s*"
                         r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                         r"spill loads\n.*?Used (\d+) registers(.*)", log):
        name, stack, st, ld, regs, rest = m.groups()
        smem = re.search(r"(\d+) bytes smem", rest)
        short = re.sub(r"^_ZN.*?(\d+)(mma_unit_kernel|prologue_kernel|unit_conv_kernel|"
                       r"unit_tm_kernel|\w*rvq\w*)", r"\2", name)
        out[short[:90]] = {"registers": int(regs), "stack": int(stack),
                           "spill_stores": int(st), "spill_loads": int(ld),
                           "static_smem": int(smem.group(1)) if smem else 0}
    return out


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy in Triton's package."""
    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        cands += [os.path.join(p, "backends", "nvidia", "bin", "cuobjdump")
                  for p in spec.submodule_search_locations]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found: the sass check needs it")


def sass_check() -> None:
    """HMMA (tensor-core MMA) instructions in the two stack libraries' SASS."""
    tool, counts = cuobjdump(), {}
    for mod in (resunit, resunit_tm):
        name = mod.LIBRARY[0]
        sass = subprocess.run([tool, "-sass", os.path.join(_build.BUILD_DIR, f"lib{name}.so")],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[f"lib{name}.so"] = len(re.findall(r"\bHMMA\.", sass))
    say("sass", tool=tool, hmma_instructions=counts)
    gate(all(n > 0 for n in counts.values()), f"no HMMA instruction in {counts}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    faulthandler.dump_traceback_later(900, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    say("guard", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    libraries = [mod.LIBRARY for mod, _, _ in KERNELS.values()]
    _build.build_all(libraries)
    lib = resunit._lib()
    say("build", seconds=time.perf_counter() - t0,
        libraries={name: _build.build_log.get(name, {}).get("seconds", "cached")
                   for name, _ in libraries},
        ptxas={name: ptxas_summary(log["ptxas"]) for name, log in _build.build_log.items()},
        tensor_core_dynamic_smem_bytes={
            f"{tm}x{tn}": {"k7_d9": lib.resunit_smem_bytes(7, tm, tn, 9),
                           "k1": lib.resunit_smem_bytes(1, tm, tn, 1)}
            for tm, tn in resunit.TILES})
    sass_check()

    gen = torch.Generator().manual_seed(args.seed)
    with fp32_exact():      # the plain versions' and cuDNN's fp32 convolutions
        records = {"resunit_stack": check_stacks("resunit_stack", STACKS, False, gen),
                   "resunit_stack_tm": check_stacks("resunit_stack_tm", TM_STACKS, True, gen)}
        check_rvq_cases(gen)

    t0 = time.perf_counter()
    cfg = CodecConfig().with_rvq(8, 128)
    # copies of the tree made for a card run leave the r5 checkpoints out
    if all(map(os.path.exists, R5)):
        m, weights = load_codec(*R5, cfg), "artifacts/r5 (trained)"
    else:
        m = allpred_ar.codec_init(cfg, torch.Generator().manual_seed(args.seed))
        weights = f"random, seed {args.seed}"
    m = m.cuda()
    torch.cuda.synchronize()
    say("load", seconds=time.perf_counter() - t0, weights=weights,
        params=sum(p.numel() for p in m.parameters()))

    a, tc = signal(args.seed, 24000)
    many = signals(args.seed, PARITY_STREAMS, 24000)
    default = round_trip(m, a, tc, many)
    # K2's line is taken on its path: the AR roll's head RVQ chunks
    k2_launches, records["rvq_lookup"] = head_rvq_path(m, a, tc)
    tm = time_major_round_trip(m, a, tc, many, default)
    tail_kernel_round_trip(m, a, tc, many, default)
    for name, res in (("default", default), ("time_major", tm)):
        profile_phase(name, res["bf16"]["codec"], a, tc, res["bf16"]["codes"])
    small_reference(args.seed)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} gate(s) failed", file=sys.stderr)
        return 1

    # launches: K1 on the default bf16 round trip, K3 on the time-major one,
    # K2 on the head RVQ path
    launches = {"resunit_stack": default["bf16"]["launches"]["resunit_stack"],
                "resunit_stack_tm": tm["bf16"]["launches"]["resunit_stack_tm"],
                "rvq_lookup": k2_launches}
    print(json.dumps({"kernels": [
        rec.line(name, torch.float32 if name == "rvq_lookup" else torch.bfloat16,
                 launches[name]) for name, rec in records.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
