"""Build and load the port's CUDA kernels: plain ``nvcc`` into a shared library
with an ``extern "C"`` interface, loaded with ``ctypes``.

A library is compiled at first use when it is missing or older than its
source, into ``build/torch_kernels/`` at the repository root. The compiler
writes to a temporary name that is renamed into place, so a build that is
killed leaves nothing half-written and no lock behind. Nothing here runs at
import time: this module is imported on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 600

_loaded: dict = {}
build_log: dict = {}       # library name -> {"seconds": ..., "ptxas": ...}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def build(name: str, source: str) -> str:
    """Compile ``csrc/<source>`` into ``lib<name>.so`` if it is missing or
    stale; return the library's path."""
    src = os.path.join(_PKG, "csrc", source)
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr.strip()}
    return so


def build_all(libraries) -> None:
    """Build several ``(name, source)`` libraries at once: one ``nvcc`` each,
    all started together."""
    libraries = list(libraries)
    with ThreadPoolExecutor(max(len(libraries), 1)) as pool:
        list(pool.map(lambda lib: build(*lib), libraries))


def load(name: str, source: str, signatures: dict) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>.so`` once per process with the
    given ``{function: argtypes}``; every function returns a C int."""
    if name not in _loaded:
        lib = ctypes.CDLL(build(name, source))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
