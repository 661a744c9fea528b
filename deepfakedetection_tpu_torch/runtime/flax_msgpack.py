"""Reads the JAX package's native weights (flax msgpack) without JAX.

The JAX package writes its bare weights with ``flax.serialization.to_bytes``
(``deepfakedetection_tpu/runtime/checkpoint.py``'s ``export_weights``): its
training's ``checkpoints/<Model>.pth`` (msgpack bytes behind a torch name) and
its export's ``.weights.msgpack``. The card has neither ``msgpack`` nor
``ml_dtypes``, so this is a reader of its own for the subset flax writes for
them: maps, arrays, str and bin, ints, floats and nil, and two of flax's ext
types, 1 (an ndarray: a msgpack ``(shape, dtype name, C-order bytes)``) and 3
(a numpy scalar, the same payload of shape ``()``). Arrays come back as torch
tensors, ``bfloat16`` among them (``torch.frombuffer``). Anything else (flax
writes booleans and chunks only for trees that are not weights, or for an
array past 1 GiB), a truncated file or bytes past the end raise
``ValueError``.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Any

import torch

# numpy's dtype names (what flax writes) -> torch dtypes
DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64,
}
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# fixed-size tags: tag -> (struct format, bytes)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4),
          0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}


class _Reader:
    def __init__(self, data: bytes | bytearray | memoryview) -> None:
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.text(tag & 0x1F)
        if tag == 0xC0:
            return None
        if tag in _FIXED:
            fmt, n = _FIXED[tag]
            return struct.unpack(fmt, self.take(n))[0]
        if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.uint(1 << (tag - 0xC4))))
        if tag in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.text(self.uint(1 << (tag - 0xD9)))
        if tag in (0xDC, 0xDD):  # array 16/32
            return self.array(self.uint(2 << (tag - 0xDC)))
        if tag in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 << (tag - 0xDE)))
        if 0xD4 <= tag <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (tag - 0xD4))
        if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self.ext(self.uint(1 << (tag - 0xC7)))
        raise ValueError(f"msgpack tag 0x{tag:02x} at offset {self.pos - 1} is not one flax writes")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> torch.Tensor:
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an ndarray (1) or a numpy "
                             "scalar (3)")
        return _ndarray(payload, scalar=code == EXT_NPSCALAR)


def _ndarray(payload: memoryview, scalar: bool) -> torch.Tensor:
    """flax's ndarray payload: a msgpack [shape, dtype name, C-order bytes]."""
    inner = _Reader(payload)
    fields = inner.value()
    if inner.pos != len(payload) or not isinstance(fields, list) or len(fields) != 3:
        raise ValueError("msgpack ndarray payload is not (shape, dtype, bytes)")
    shape, name, data = fields
    name = name.decode() if isinstance(name, bytes) else name
    if name not in DTYPES:
        raise ValueError(f"msgpack ndarray of dtype {name!r}: not one of {sorted(DTYPES)}")
    dtype = DTYPES[name]
    if not isinstance(shape, list) or not all(isinstance(s, int) and s >= 0 for s in shape):
        raise ValueError(f"msgpack ndarray shape {shape!r}")
    if scalar and shape:
        raise ValueError(f"msgpack numpy scalar of shape {shape}")
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    if not isinstance(data, bytes) or len(data) != nbytes:
        raise ValueError(f"msgpack ndarray {name}{shape}: {nbytes} bytes wanted, "
                         f"{len(data) if isinstance(data, bytes) else type(data)} given")
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)


def msgpack_restore(data: bytes | bytearray | memoryview) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` gives for
    ``data``, with torch tensors for its arrays and 0-d tensors for its numpy
    scalars."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes past the end of the "
                         "top-level object")
    return tree


def read(path: str | Path) -> dict[str, Any]:
    """A flax msgpack weights file as its tree (``{"params", "batch_stats"}``
    for the JAX package's exports)."""
    tree = msgpack_restore(Path(path).read_bytes())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: the msgpack top level is a {type(tree).__name__}, not a map")
    return tree
