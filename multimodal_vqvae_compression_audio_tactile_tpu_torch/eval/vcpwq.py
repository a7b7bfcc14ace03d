"""VC-PWQ baseline: build the C++ codec from source, code a corpus, and
evaluate the codec's output files.

``eval_vc_pwq`` is a port of the JAX package's ``eval/vcpwq.py``: for each
bit budget b, the decoded ``*{stem}*_{b}.wav`` and compressed
``*{stem}*_{b}.binary`` of every tactile file, scored by the same raw PSNR
and ST-SIM as the other evaluators; kbps = compressed bits over the signal's
duration, the compression ratio = original bytes over compressed bytes, the
buffer delay of the codec's block (512 / 2.8 kHz = 182.9 ms) and no
encode/decode latency (NaN). The stream's magic tells its version: 'VPWQ'
(v1, raw bitplanes, the reference codec's rates) or 'VPW2' (v2, range-coded).
Host code throughout.

``build_codec`` compiles the repository's C++ codec (``native/vcpwq``:
``main.cpp``, ``vcpwq.cpp``, ``rvqpack.cpp``) with ``g++ -O3 -std=c++17``
into ``build/vcpwq/vcpwq_codec`` at first use, leaving ``native/``
untouched; ``code_corpus`` runs it over a directory of tactile files.
``build_library`` compiles ``vcpwq.cpp`` and ``rvqpack.cpp`` the same way
into the shared library ``build/vcpwq/libvcpwq.so`` (``-shared -fPIC``),
whose range coder ``eval/bitstream.py`` calls.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from .. import _build
from ..core.config import EvalConfig
from ..dsp.resample import resample
from ..utils.wav_io import load_wav_mono, read_wav
from . import metrics as M

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(_build.BUILD_DIR)), "native",
                          "vcpwq")
SOURCES = ("main.cpp", "vcpwq.cpp", "rvqpack.cpp")
HEADERS = ("rangecoder.h",)
BUILD_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "vcpwq")
CXX_FLAGS = ["-O3", "-std=c++17"]


def _compile(target: str, sources, flags) -> str:
    """``build/vcpwq/<target>`` from ``native/vcpwq/<sources>``, compiled
    first if it is missing or older than a source or header. The compiler
    writes to a temporary name that is renamed into place; a failed build
    raises with the compiler's message."""
    out = os.path.join(BUILD_DIR, target)
    srcs = [os.path.join(NATIVE_DIR, f) for f in sources]
    deps = srcs + [os.path.join(NATIVE_DIR, f) for f in HEADERS]
    if os.path.exists(out) and all(os.path.getmtime(out) >= os.path.getmtime(f) for f in deps):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {target} is built from native/vcpwq")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, *flags, "-o", tmp, *srcs],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on native/vcpwq:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_codec() -> str:
    """The path of ``build/vcpwq/vcpwq_codec`` (``_compile``)."""
    return _compile("vcpwq_codec", SOURCES, [])


def build_library() -> str:
    """The path of ``build/vcpwq/libvcpwq.so``, the codec's library with
    the range coder's C interface (``_compile``)."""
    return _compile("libvcpwq.so", SOURCES[1:], ["-shared", "-fPIC"])


def code_corpus(tact_dir: str, dec_dir: str, comp_dir: str, b_list: Sequence[int],
                codec: Optional[str] = None) -> None:
    """Every ``*.wav`` of ``tact_dir`` through the codec at each bit budget:
    ``{stem}_{b}.binary`` into ``comp_dir``, ``{stem}_{b}.wav`` into
    ``dec_dir``. Raises if the codec fails."""
    codec = codec or build_codec()
    for d in (dec_dir, comp_dir):
        os.makedirs(d, exist_ok=True)
    for b in b_list:
        proc = subprocess.run([codec, "batch", tact_dir, dec_dir, comp_dir, str(b)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"vcpwq_codec batch b={b} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")


def eval_vc_pwq(
    vc_dec_dir: str,
    vc_comp_dir: str,
    tact_dir: str,
    peak_global: float,
    ecfg: EvalConfig = EvalConfig(),
    b_list: Optional[Sequence[int]] = None,
    log: Callable = print,
) -> list:
    """One row per bit budget that has decoded files (see the module
    docstring)."""
    results = []
    for b_val in (b_list or ecfg.vc_b_list):
        log(f"[VC-PWQ] b={b_val}")
        st_vals, ps_vals = [], []
        total_comp = total_orig = 0
        total_sec = 0.0
        used = 0
        stream_versions: set = set()

        for t_path in sorted(glob.glob(os.path.join(tact_dir, "*.wav"))):
            stem = Path(t_path).stem
            dec = sorted(glob.glob(os.path.join(vc_dec_dir, f"*{stem}*_{b_val}.wav")))
            if not dec:
                continue
            ref, sr_ref = load_wav_mono(t_path)
            est, sr_dec = load_wav_mono(dec[0])
            if sr_dec != sr_ref:
                est = np.asarray(resample(est, sr_dec, sr_ref))

            psnr, r_a, e_a = M.align_and_psnr_raw(ref, est, peak_global, ecfg.max_align_shift)
            ps_vals.append(psnr)
            r24 = np.asarray(resample(r_a, sr_ref, ecfg.eval_sr))
            e24 = np.asarray(resample(e_a, sr_ref, ecfg.eval_sr))
            st_vals.append(M.stsim_batch(r24[None], e24[None])[0])

            comp = sorted(glob.glob(os.path.join(vc_comp_dir, f"*{stem}*_{b_val}.binary")))
            if comp:
                total_comp += os.path.getsize(comp[0])
                total_orig += os.path.getsize(t_path)
                data, sr_t2 = read_wav(t_path)
                total_sec += data.shape[0] / float(sr_t2)
                with open(comp[0], "rb") as f:
                    magic = f.read(4)
                stream_versions.add({b"VPWQ": "v1", b"VPW2": "v2"}.get(magic, "unknown"))
            used += 1

        if used == 0:
            log(f"  [VC-PWQ] WARNING: no matches for b={b_val}")
            continue

        st_m, st_ci = M.mean_ci95(st_vals)
        ps_m, ps_ci = M.mean_ci95(ps_vals)
        if total_comp > 0 and total_sec > 0:
            kbps = total_comp * 8.0 / total_sec / 1000.0
            cr = total_orig / total_comp
        else:
            kbps = cr = float("nan")

        results.append({
            "label": f"VC bl{ecfg.vc_block_len} b{b_val}",
            "b": int(b_val),
            "kbps": kbps, "compression_ratio": cr,
            "stsim_mean": st_m, "stsim_ci95": st_ci,
            "psnr_mean": ps_m, "psnr_ci95": ps_ci,
            "n": len(st_vals), "pairs": used,
            "stream_version": "+".join(sorted(stream_versions)) or "none",
            "encoding_delay_ms": float("nan"),
            "decoding_delay_ms": float("nan"),
            "buffer_delay_ms": ecfg.vc_buffer_ms,
        })
    return results
