"""Reader of the flax msgpack files the JAX package writes, in plain Python.

The JAX package saves a checkpoint with ``flax.serialization.to_bytes``:
msgpack of the payload's state dict, with arrays as msgpack extension
types. The card's machine has no ``msgpack`` package and the port may not
need one, so this module decodes the part of msgpack that flax writes:

* nil, booleans, integers of every width, float32 and float64, str, bin,
  arrays and maps (msgpack arrays come back as lists);
* extension type 1, an ndarray: itself msgpack of ``(shape, dtype name,
  C-order bytes)``, returned as a NumPy array, or as a ``torch.bfloat16``
  tensor for dtype ``bfloat16`` (NumPy has no such dtype);
* extension type 2, a Python complex, as msgpack ``(real, imag)``;
* extension type 3, a NumPy scalar, as an ndarray of shape ``()``.

Flax splits an array larger than 2^30 bytes into chunks
(``{"__msgpack_chunked_array__": True, ...}``); no model of this repository
comes near that, and :func:`msgpack_restore` refuses such a file rather
than misread it. The port writes no msgpack: its checkpoints are ``.pt``.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["msgpack_restore", "unpackb"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

#: fixed-width values after their type byte: (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
#: type byte -> width of the length that follows it (big-endian unsigned)
_LEN = {
    0xC4: 1, 0xC5: 2, 0xC6: 4,  # bin
    0xC7: 1, 0xC8: 2, 0xC9: 4,  # ext
    0xD9: 1, 0xDA: 2, 0xDB: 4,  # str
    0xDC: 2, 0xDD: 4,  # array
    0xDE: 2, 0xDF: 4,  # map
}
#: fixext type byte -> size of its data
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    __slots__ = ("buf", "pos", "ext_hook")

    def __init__(self, data: bytes, ext_hook: Callable[[int, bytes], Any] | None):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        out = self.buf[self.pos : end]
        self.pos = end
        return out

    def uint(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _LEN:
            raise ValueError(f"byte 0x{b:02x} starts no msgpack value")
        n = self.uint(_LEN[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        if b <= 0xDD:
            return self.array(n)
        return self.map(n)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        data = bytes(self.take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack extension type {code} where none is expected")
        return self.ext_hook(code, data)


def unpackb(data: bytes, ext_hook: Callable[[int, bytes], Any] | None = None) -> Any:
    """The one msgpack value ``data`` holds; ``ext_hook(code, data)`` decodes
    an extension type (none is accepted without it). Trailing bytes raise
    ``ValueError``."""
    reader = _Reader(data, ext_hook)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack value")
    return out


def _ndarray(data: bytes) -> "np.ndarray | torch.Tensor":
    shape, name, buf = unpackb(data)
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        t = torch.empty(shape, dtype=torch.bfloat16)
        if t.numel():
            t.view(-1).view(torch.int16).copy_(
                torch.from_numpy(np.frombuffer(buf, dtype="<i2").copy())
            )
        return t
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _flax_ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _refuse_chunked(tree: Any, path: str = "") -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(
                f"{path or 'the root'} is an array that flax split into chunks "
                "(over 2^30 bytes); the port does not read chunked arrays"
            )
        for k, v in tree.items():
            _refuse_chunked(v, f"{path}/{k}")


def msgpack_restore(blob: bytes) -> Any:
    """The state dict of a ``flax.serialization.to_bytes`` file: nested
    dicts (optax's tuples and named tuples arrive keyed ``"0"``, ``"1"``, …
    or by field), lists and array leaves, as :mod:`flax.serialization`'s
    ``msgpack_restore`` gives it."""
    tree = unpackb(blob, _flax_ext)
    _refuse_chunked(tree)
    return tree
