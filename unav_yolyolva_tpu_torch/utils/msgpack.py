"""A reader of the bytes that `flax.serialization.to_bytes` writes (the JAX
package's checkpoints: `params.msgpack`, `ema.msgpack`, `opt_state.msgpack`),
in the standard library and numpy.

The format is MessagePack (https://github.com/msgpack/msgpack/blob/master/
spec.md): maps with string keys, arrays, strings, ints, floats, booleans and
nil, with numpy arrays as ext type 1 and numpy scalars as ext type 3, each
the packed triple (shape, dtype name, C-order bytes); complex numbers are ext
type 2. Arrays larger than 1 GiB are written in chunks, as the map
{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}, and
joined again here. `restore(data)` gives what `flax.serialization.
msgpack_restore` gives: dicts, lists, python scalars and numpy arrays (views
of `data`, read-only, as flax's are).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wants {n} more)")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(">" + "BHI"[b - 0xD9]), raw)
        if b in (0xDC, 0xDD):
            return [self.value(raw) for _ in range(self.unpack(">" + "HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]), raw)
        raise ValueError(f"msgpack: byte {b:#x} at {self.pos - 1} starts no known type")

    def str(self, n: int, raw: bool):
        s = self.take(n)
        return bytes(s) if raw else str(s, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out

    def ext(self, code: int, n: int):
        start = self.pos
        inner = _Reader(self.take(n))
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype, payload = _ndarray_triple(inner, start)
            arr = np.frombuffer(payload, dtype=dtype).reshape(shape, order="C")
            return arr if code == EXT_NDARRAY else arr[()]
        if code == EXT_COMPLEX:
            re, im = inner.value()
            return complex(re, im)
        raise ValueError(f"msgpack: ext type {code} at byte {start} is not one flax writes")


def _ndarray_triple(inner: _Reader, start: int) -> Tuple[tuple, np.dtype, memoryview]:
    head = inner.take(1)[0]
    if head != 0x93:
        raise ValueError(f"msgpack: the ndarray at byte {start} is not a (shape, dtype, "
                         f"bytes) triple")
    shape = tuple(inner.value())
    name = inner.value(raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError(f"msgpack: the array at byte {start} is bfloat16; the port "
                         f"reads fp32 checkpoints only")
    b = inner.take(1)[0]
    if b not in (0xC4, 0xC5, 0xC6):
        raise ValueError(f"msgpack: the ndarray at byte {start} holds no byte string")
    payload = inner.take(inner.unpack(">" + "BHI"[b - 0xC4]))
    return shape, np.dtype(name), payload


def _unchunk_in_place(d):
    if not isinstance(d, dict):
        return d
    if CHUNKED in d:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    for k, v in d.items():
        if isinstance(v, dict):
            d[k] = _unchunk_in_place(v)
    return d


def restore(data) -> Any:
    """The tree of `flax.serialization.to_bytes` output `data` (bytes, a
    bytearray or a memoryview that outlives the arrays)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the value")
    return _unchunk_in_place(out)


def read_file(path: str) -> Any:
    with open(path, "rb") as f:
        return restore(f.read())
