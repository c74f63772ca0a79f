"""A reader of flax's msgpack checkpoints in pure Python.

The JAX package writes its `.ckpt` files with
`flax.serialization.msgpack_serialize` (larvanet_tpu/models/base.py:716).
The port reads them without the `msgpack` and `flax` packages, from the
formats themselves:

* msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md): nil,
  bool, int of every width (signed and unsigned), float32 and float64, str
  (utf-8), bin, array, map and ext, read as `msgpack.unpackb(raw=False)`
  reads them: arrays become lists, bin becomes bytes, and a map key must be
  a str or bytes (its `strict_map_key`).
* flax's ext codes (`flax.serialization._MsgpackExtType`, flax 0.12.3):
  1 is an ndarray, the msgpack of (shape, dtype name, C-order bytes); 3 is
  a numpy scalar, the same for a 0-d array; 2 is a Python complex, the
  msgpack of (real, imag). numpy has no bfloat16, so a "bfloat16" array
  comes back as a torch.bfloat16 tensor; every other dtype as a numpy
  array.
* flax's chunked arrays: an array over `MAX_CHUNK_SIZE` bytes (2^30) is
  written as a map {"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": flat chunk, ...}}, and put back together where flax's
  `msgpack_restore` puts it back: at the top level and in maps nested in
  maps (not inside arrays).

Anything else raises ValueError, naming the byte offset.
"""

from __future__ import annotations

import math
import struct
from typing import Any, List

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_INT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
        0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def restore(data: bytes) -> Any:
    """The tree that `flax.serialization.msgpack_restore(data)` returns:
    dicts, lists, Python scalars, bytes, numpy arrays and scalars, and
    torch.bfloat16 tensors where flax gives bfloat16 arrays."""
    reader = _Reader(data, raw=False)
    out = reader.value(chunk_context=True)
    if reader.pos != len(reader.buf):
        raise ValueError("%d bytes of extra data after the object, at byte %d"
                         % (len(reader.buf) - reader.pos, reader.pos))
    return out


class _Reader:
    def __init__(self, data: bytes, raw: bool, base: int = 0):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw       # str as bytes (flax reads an ndarray's header so)
        self.base = base     # offset of `data` in the file, for messages

    def where(self, pos=None) -> str:
        return "byte %d" % (self.base + (self.pos if pos is None else pos))

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data: %d bytes wanted at %s, %d left"
                             % (n, self.where(), len(self.buf) - self.pos))
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, chunk_context: bool = False) -> Any:
        start = self.pos
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, start, chunk_context)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f, start)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.unpack(_LEN[1 << (b - 0xc4)])))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack(_LEN[1 << (b - 0xc7)])
            return self.ext(n, start)
        if b == 0xca:
            return self.unpack(">f")
        if b == 0xcb:
            return self.unpack(">d")
        if b in _INT:
            return self.unpack(_INT[b])
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4), start)
        if b in (0xd9, 0xda, 0xdb):
            return self.str(self.unpack(_LEN[1 << (b - 0xd9)]), start)
        if b in (0xdc, 0xdd):
            return self.array(self.unpack(">H" if b == 0xdc else ">I"))
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"), start, chunk_context)
        raise ValueError("unknown msgpack type byte 0x%02x at %s" % (b, self.where(start)))

    def str(self, n: int, start: int):
        data = bytes(self.take(n))
        if self.raw:
            return data
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError as exc:
            raise ValueError("a str that is not utf-8 at %s: %s"
                             % (self.where(start), exc)) from None

    def array(self, n: int) -> List[Any]:
        return [self.value() for _ in range(n)]

    def map(self, n: int, start: int, chunk_context: bool):
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError("a map key of type %s at %s: only str and bytes keys "
                                 "are read" % (type(key).__name__, self.where(key_at)))
            out[key] = self.value(chunk_context=True)
        if chunk_context and CHUNKED in out:
            return self.unchunk(out, start)
        return out

    def ext(self, n: int, start: int):
        code = self.unpack(">b")
        payload_at = self.base + self.pos
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload, payload_at)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload, payload_at)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            sub = _Reader(payload, raw=False, base=payload_at)
            pair = sub.value()
            if (sub.pos != len(payload) or not isinstance(pair, list) or len(pair) != 2
                    or not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                               for v in pair)):
                raise ValueError("a malformed complex ext at %s" % self.where(start))
            return complex(pair[0], pair[1])
        raise ValueError("msgpack ext type %d at %s is not one of flax's (1 ndarray, "
                         "2 complex, 3 numpy scalar)" % (code, self.where(start)))

    def unchunk(self, node: dict, start: int):
        """flax's `_unchunk`: the flat chunks concatenated, then reshaped."""
        try:
            shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        except (KeyError, TypeError) as exc:
            raise ValueError("a malformed chunked array at %s: %r" % (self.where(start), exc)) \
                from None
        if not chunks or not all(isinstance(c, (np.ndarray, torch.Tensor)) and c.ndim == 1
                                 for c in chunks):
            raise ValueError("a chunked array at %s whose chunks are not flat arrays"
                             % self.where(start))
        if isinstance(chunks[0], torch.Tensor):
            flat = torch.cat(chunks)
        else:
            flat = np.concatenate(chunks)
        if not all(isinstance(d, int) and d >= 0 for d in shape) or \
                math.prod(shape) != flat.shape[0]:
            raise ValueError("a chunked array at %s of shape %s holds %d elements"
                             % (self.where(start), shape, flat.shape[0]))
        return flat.reshape(shape)


def _ndarray(payload: bytes, at: int):
    """flax's `_ndarray_from_bytes`: msgpack (shape, dtype name, bytes),
    header strings read raw."""
    sub = _Reader(payload, raw=True, base=at)
    head = sub.value()
    if (sub.pos != len(payload) or not isinstance(head, list) or len(head) != 3
            or not isinstance(head[0], list) or not isinstance(head[1], bytes)
            or not isinstance(head[2], bytes)
            or not all(isinstance(d, int) and not isinstance(d, bool) and d >= 0
                       for d in head[0])):
        raise ValueError("a malformed ndarray ext at byte %d" % at)
    shape, name, data = head
    if name == b"bfloat16":
        if len(data) != 2 * math.prod(shape):
            raise ValueError("a bfloat16 array of shape %s with %d bytes at byte %d"
                             % (shape, len(data), at))
        if not data:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name.decode("ascii"))
    except (TypeError, UnicodeDecodeError) as exc:
        raise ValueError("unknown ndarray dtype %r at byte %d" % (name, at)) from exc
    if dtype.hasobject or len(data) != dtype.itemsize * math.prod(shape):
        raise ValueError("an ndarray of dtype %s and shape %s with %d bytes at byte %d"
                         % (dtype, shape, len(data), at))
    return np.frombuffer(data, dtype=dtype).reshape(shape)
