"""A reader of the msgpack files that `flax.serialization.msgpack_serialize`
writes (the JAX package's checkpoints, `miseg_tpu/train/checkpoint.py:29`):
the counterpart of `flax.serialization.msgpack_restore`, in Python and
numpy, with neither `msgpack` nor flax installed.

It decodes the subset of msgpack that flax writes: nil, bool, integers,
floats, str, bin, array (as a list), map (as a dict), and flax's three
extension types:
  * 1, an ndarray: a packed `(shape, dtype name, C-order bytes)`;
  * 2, a Python complex: a packed `(real, imag)`;
  * 3, a numpy scalar: packed as a 0-d ndarray, returned as its scalar.
An array of dtype `bfloat16`, which numpy lacks, comes back as a
`torch.bfloat16` tensor (its bytes viewed through `uint16`); every other
array is a read-only numpy view of the file's bytes, as flax's is.
flax splits an array of more than `MAX_CHUNK_SIZE` (2**30) bytes into a
`{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}` map;
`msgpack_restore` joins those again.  Anything else raises ValueError.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A cursor over msgpack bytes; `value()` decodes the next object."""

    def __init__(self, data: bytes | memoryview):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.extension(self.unpack(">b"), self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.extension(self.unpack(">b"), self.take(fixext[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strings = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strings:
            return self.string(self.unpack(strings[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.mapping(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} is not a msgpack type "
                         "that flax writes")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def extension(self, code: int, data: memoryview):
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise ValueError(f"msgpack extension type {code} is not one that flax writes")


def _ndarray(data: memoryview):
    """flax's `_ndarray_from_bytes`: a packed (shape, dtype name, bytes)."""
    inner = _Reader(data)
    triple = inner.value()
    if (not isinstance(triple, list) or len(triple) != 3
            or not isinstance(triple[2], bytes) or inner.pos != len(data)):
        raise ValueError("a flax ndarray extension holds (shape, dtype name, bytes)")
    shape, name, raw = triple
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _join_chunks(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _join_chunks(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree that `flax.serialization.msgpack_restore(data)` gives."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes follow the msgpack object")
    return _join_chunks(tree)
