"""RVQ code bitstream: transmitted indices <-> bytes (adaptive range coder).

The port of the JAX package's ``eval/bitstream.py``: an LZMA-style adaptive
binary range coder with per-book bit-tree contexts, 'RVQ1' stream format.
Two implementations with byte-identical streams, as there:

- native: ``native/vcpwq/rvqpack.cpp`` through ``ctypes``, from the shared
  library that ``eval/vcpwq.py::build_library`` compiles into
  ``build/vcpwq/libvcpwq.so`` at first use (``native/`` stays untouched). A
  build that fails raises with the compiler's message;
- pure Python (this file): ``force_python=True``, and the oracle the
  native streams are checked against. ``peek`` is pure Python always.

At 75 tokens/s x 8 books a second of codes is 600 symbols: host time only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_PROB_BITS = 11
_PROB_MAX = 1 << _PROB_BITS
_PROB_INIT = _PROB_MAX >> 1
_MOVE_BITS = 5
_TOP = 1 << 24
_MASK32 = 0xFFFFFFFF

_lib: Optional[ctypes.CDLL] = None


def _native_lib() -> ctypes.CDLL:
    """The range coder's shared library, built at first use and bound once;
    raises where it cannot be built."""
    global _lib
    if _lib is None:
        from .vcpwq import build_library

        lib = ctypes.CDLL(build_library())
        u8, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        lib.rvq_pack.restype = ctypes.c_int64
        lib.rvq_pack.argtypes = [i32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, u8,
                                 ctypes.c_int64]
        lib.rvq_unpack.restype = ctypes.c_int64
        lib.rvq_unpack.argtypes = [u8, ctypes.c_int64, i32, ctypes.c_int64]
        _lib = lib
    return _lib


class _Encoder:
    """Integer-exact port of native/vcpwq/rangecoder.h (LZMA-style)."""

    def __init__(self):
        self.low = 0
        self.range = _MASK32
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if (self.low & _MASK32) < 0xFF000000 or (self.low >> 32) != 0:
            carry = self.low >> 32
            b = self.cache
            while True:
                self.out.append((b + carry) & 0xFF)
                b = 0xFF
                self.cache_size -= 1
                if self.cache_size == 0:
                    break
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & _MASK32

    def encode(self, probs, i, bit):
        p = probs[i]
        bound = (self.range >> _PROB_BITS) * p
        if not bit:
            self.range = bound
            probs[i] = p + ((_PROB_MAX - p) >> _MOVE_BITS)
        else:
            self.low += bound
            self.range -= bound
            probs[i] = p - (p >> _MOVE_BITS)
        while self.range < _TOP:
            self._shift_low()
            self.range = (self.range << 8) & _MASK32

    def flush(self):
        for _ in range(5):
            self._shift_low()


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.code = 0
        self.range = _MASK32
        for _ in range(5):
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFFFF
        self.code &= _MASK32

    def _next(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def decode(self, probs, i) -> int:
        p = probs[i]
        bound = (self.range >> _PROB_BITS) * p
        if self.code < bound:
            bit = 0
            self.range = bound
            probs[i] = p + ((_PROB_MAX - p) >> _MOVE_BITS)
        else:
            bit = 1
            self.code -= bound
            self.range -= bound
            probs[i] = p - (p >> _MOVE_BITS)
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._next()) & _MASK32
            self.range = (self.range << 8) & _MASK32
        return bit


def _log2i(k: int) -> int:
    n = 0
    while (1 << n) < k:
        n += 1
    return n


def pack_codes(codes: np.ndarray, K: int, force_python: bool = False) -> bytes:
    """codes [T, n_books] (or [B, T, n_books], batch concatenated token-major)
    int in [0, K) -> entropy-coded bytes ('RVQ1' stream), by the native coder
    unless ``force_python``."""
    codes = np.asarray(codes, np.int32)
    if codes.ndim == 3:
        codes = codes.reshape(-1, codes.shape[-1])
    if codes.ndim != 2:
        raise ValueError(f"codes must be [T, n_books], got {codes.shape}")
    if K & (K - 1) or K <= 0:
        raise ValueError(f"K must be a power of two, got {K}")
    if codes.size and (codes.min() < 0 or codes.max() >= K):
        raise ValueError("code index out of range")
    if force_python:
        return _pack_py(codes, K)
    lib = _native_lib()
    T, n_books = codes.shape
    cap = 12 + T * n_books * 4 + 1024
    out = np.zeros(cap, np.uint8)
    codes_c = np.ascontiguousarray(codes)
    n = lib.rvq_pack(codes_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), T, n_books, K,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"rvq_pack failed: {n}")
    return out[:n].tobytes()


def _pack_py(codes: np.ndarray, K: int) -> bytes:
    T, n_books = codes.shape
    n_bits = _log2i(K)
    enc = _Encoder()
    probs = [[_PROB_INIT] * (1 << n_bits) for _ in range(n_books)]
    for t in range(T):
        for b in range(n_books):
            sym = int(codes[t, b])
            ctx = 1
            for bit_i in range(n_bits - 1, -1, -1):
                bit = (sym >> bit_i) & 1
                enc.encode(probs[b], ctx, bit)
                ctx = (ctx << 1) | bit
    enc.flush()
    head = (b"RVQ1" + np.uint32(T).tobytes() + np.uint16(n_books).tobytes()
            + np.uint16(n_bits).tobytes())
    return bytes(head) + bytes(enc.out)


def unpack_codes(data: bytes, force_python: bool = False) -> np.ndarray:
    """'RVQ1' bytes -> codes [T, n_books] int32, by the native coder unless
    ``force_python``."""
    T, n_books, _ = peek(data)
    if force_python:
        return _unpack_py(data)
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(T * n_books, np.int32)
    m = _native_lib().rvq_unpack(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                 out.size)
    if m != T * n_books:
        raise RuntimeError(f"rvq_unpack failed: {m}")
    return out.reshape(T, n_books)


def _unpack_py(data: bytes) -> np.ndarray:
    T, n_books, K = peek(data)
    n_bits = _log2i(K)
    dec = _Decoder(data[12:])
    probs = [[_PROB_INIT] * (1 << n_bits) for _ in range(n_books)]
    out = np.zeros((T, n_books), np.int32)
    for t in range(T):
        for b in range(n_books):
            ctx = 1
            for _ in range(n_bits):
                ctx = (ctx << 1) | dec.decode(probs[b], ctx)
            out[t, b] = ctx - (1 << n_bits)
    return out


def peek(data: bytes) -> tuple[int, int, int]:
    """-> (n_tokens, n_books, K) from the stream header."""
    if len(data) < 12 or data[:4] != b"RVQ1":
        raise ValueError("not an RVQ1 stream")
    T = int(np.frombuffer(data[4:8], np.uint32)[0])
    n_books = int(np.frombuffer(data[8:10], np.uint16)[0])
    n_bits = int(np.frombuffer(data[10:12], np.uint16)[0])
    return T, n_books, 1 << n_bits


def nominal_bits(n_tokens: int, n_books: int, K: int) -> int:
    """The reference's rate model: tokens * books * ceil(log2 K) bits, as the
    JAX package's ``nominal_bits``."""
    return n_tokens * n_books * _log2i(K)


def empirical_kbps(n_bytes: int, seconds: float) -> float:
    """The wire rate of ``n_bytes`` over ``seconds`` of signal, in kbps."""
    return n_bytes * 8.0 / seconds / 1000.0
