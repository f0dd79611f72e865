"""Minimal msgpack encoder/decoder for the checkpoint format.

Covers what flax.serialization writes for a parameter tree: maps, str,
int, float, bool, nil, bin, arrays, and numpy arrays as ext type 1 whose
payload is itself msgpack of (shape, dtype name, C-order bytes). Ext type 3
(a numpy scalar, same payload) is decoded too, as are flax's chunked
leaves ({"__msgpack_chunked_array__": True, ...}). Encoding follows the
msgpack library's choices (smallest int form, float64 for floats, str8
allowed), so a tree of dicts, numbers and float arrays encodes to the bytes
flax writes.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_len(n: int, fix_code: int, fix_max: int, codes: tuple, out: bytearray) -> None:
    """Header of a sized type: fix form, then 8/16/32-bit lengths (code None = no 8-bit form)."""
    if fix_code is not None and n <= fix_max:
        out.append(fix_code | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(n)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code)
    out += data


def ndarray_payload(arr: np.ndarray) -> bytes:
    # Not np.ascontiguousarray: it turns a 0-d array into shape (1,).
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):  # before float: np.float64 subclasses float
        _pack_ext(EXT_NPSCALAR, ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj)}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise ValueError(f"checkpoint array dtype {dtype_name!r} is not supported") from e
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


_SIZED = {  # code -> (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_SCALARS = {
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _SCALARS:
        v = r.unpack(_SCALARS[b])
        return float(v) if b in (0xCA, 0xCB) else int(v)
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return r.take(n).decode("utf-8")
        if kind == "array":
            return [_read(r) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n)
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def _unchunk(tree: Any) -> Any:
    """flax splits leaves above 1 GiB into {"__msgpack_chunked_array__": True, ...}."""
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


def restore(data: bytes) -> Any:
    """Checkpoint bytes -> tree of dicts, numbers and numpy arrays."""
    return _unchunk(unpackb(data))
