"""A reader of the msgpack subset that ``flax.serialization.to_bytes``
writes, so the port reads a JAX run's ``.trainstate`` without ``msgpack``
or ``flax``.

What it decodes: maps, arrays, str, bin, ints, floats, bool, nil, and
flax's ext types: 1 (an ndarray: a msgpack ``(shape, dtype name, bytes)``
triple in C order, bfloat16 and int8 included), 2 (a complex) and 3 (a
numpy scalar, packed as a 0-dim ndarray). Arrays come back as CPU torch
tensors (bfloat16 reinterpreted bit for bit), numpy scalars as 0-dim
tensors, and flax's chunked arrays (leaves over 1 GiB, split into
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``) are
joined back. flax writes tuples as maps keyed "0", "1", ..., and named
tuples (optax states) as maps keyed by field name; both stay maps here.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_NUMPY_DTYPES = ("float32", "float64", "float16", "int8", "uint8", "int16", "uint16", "int32",
                 "uint32", "int64", "uint64", "bool")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {self.pos - 1}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code in (_NDARRAY, _NPSCALAR):
            t = _ndarray(payload)
            return t.reshape(()) if code == _NPSCALAR else t
        if code == _COMPLEX:
            re, im = unpackb(payload)
            return complex(re, im)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(payload: bytes) -> torch.Tensor:
    shape, dtype, buf = unpackb(payload)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    shape = tuple(int(s) for s in shape)
    if dtype == "bfloat16":
        a = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    if dtype not in _NUMPY_DTYPES:
        raise ValueError(f"msgpack: ndarray of dtype {dtype!r} is not supported")
    a = np.frombuffer(buf, dtype=np.dtype(dtype)).copy()
    return torch.from_numpy(a).reshape(shape)


def _unchunk(node: Any) -> Any:
    """flax's chunked arrays joined back, anywhere in the tree."""
    if not isinstance(node, dict):
        return node
    if node.get(_CHUNKED):
        shape = tuple(int(node["shape"][str(i)]) for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data`` (all of it)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return out


def read_flax_state(data: bytes) -> Any:
    """The state dict ``flax.serialization.to_bytes`` wrote."""
    return _unchunk(unpackb(data))
