"""Pure-Python writer for the subset of msgpack that flax's serializer writes.

The mirror of ``utils/msgpack_read.py``: maps (str keys), lists, str, bytes,
int, float (as float64), bool, nil, numpy arrays as ext type 1 holding a
msgpack ``[shape, dtype_name, raw_bytes]``, numpy scalars as ext type 3 in
the same form with an empty shape. Every type takes msgpack's smallest form,
as the ``msgpack`` package packs it, so a payload written here is byte for
byte what ``flax.serialization.to_bytes`` writes for the same tree (lists are
written as flax writes them, as ``{"0": ..., "1": ...}`` maps). Anything
else raises.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class MsgpackWriteError(TypeError):
    pass


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0 <= v <= 0xFF:
        out.append(b"\xcc" + struct.pack(">B", v))
    elif -0x80 <= v < 0:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif 0 <= v <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif -0x8000 <= v < 0:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", v))
    elif -0x80000000 <= v < 0:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", v))
    elif -0x8000000000000000 <= v < 0:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise MsgpackWriteError(f"integer out of msgpack's range: {v}")


def _sized(out: List[bytes], n: int, fix: int, fix_max: int, forms) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``forms`` ((type byte, struct format, max)) that holds n."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for byte, fmt, top in forms:
        if n <= top:
            out.append(bytes([byte]) + struct.pack(fmt, n))
            return
    raise MsgpackWriteError(f"object too large for msgpack: {n}")


def _str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _sized(out, len(b), 0xA0, 32, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                   (0xDB, ">I", 0xFFFFFFFF)))
    out.append(b)


def _bin(out: List[bytes], b: bytes) -> None:
    _sized(out, len(b), None, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                  (0xC6, ">I", 0xFFFFFFFF)))
    out.append(b)


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n]]))
    else:
        _sized(out, n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                 (0xC9, ">I", 0xFFFFFFFF)))
    out.append(struct.pack(">b", code))
    out.append(data)


def _array_payload(a: np.ndarray) -> bytes:
    """msgpack of ``[shape, dtype_name, raw C-order bytes]``."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise MsgpackWriteError(f"unsupported array dtype {a.dtype}")
    out: List[bytes] = []
    _sized(out, 3, 0x90, 16, ())
    _sized(out, a.ndim, 0x90, 16, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
    for d in a.shape:
        _int(out, int(d))
    _str(out, a.dtype.name)
    _bin(out, a.tobytes("C"))
    return b"".join(out)


def _obj(out: List[bytes], v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True:
        out.append(b"\xc3")
    elif v is False:
        out.append(b"\xc2")
    elif type(v) is int:
        _int(out, v)
    elif type(v) is float:
        out.append(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        _str(out, v)
    elif type(v) is bytes:
        _bin(out, v)
    elif type(v) is dict:
        _sized(out, len(v), 0x80, 16, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))
        for k, x in v.items():
            if type(k) is not str:
                raise MsgpackWriteError(f"map key {k!r} is not a str")
            _str(out, k)
            _obj(out, x)
    elif type(v) is list:
        _obj(out, {str(i): x for i, x in enumerate(v)})
    elif isinstance(v, np.ndarray):
        _ext(out, _EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(v)))
    else:
        raise MsgpackWriteError(f"unsupported type {type(v).__name__}")


def packb(obj: Any) -> bytes:
    """Encode one object (a checkpoint payload) as flax would."""
    out: List[bytes] = []
    _obj(out, obj)
    return b"".join(out)


def write_file(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        f.write(packb(obj))
