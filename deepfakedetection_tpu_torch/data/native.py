"""ctypes binding of the repository's native decode library.

The port's copy of the parts of ``deepfakedetection_tpu/data/native.py`` it
uses. ``native/libdfd_loader.so`` at the repository root (built with
``make -C native``; it is not part of either package) decodes a batch of
JPEG/PNG files, or in-memory buffers (``decode_buffer_batch``: the server's
request bodies), in a C++ thread pool with the geometry of ``data/decode.py``.
The port always takes the library's default, bit-faithful decode chain.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libdfd_loader.so"
_U8P, _IP = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)


@functools.cache
def _lib() -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.dfd_decode_batch_rc.restype = ctypes.c_int
    lib.dfd_decode_batch_rc.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P,
        _IP, ctypes.c_int,
    ]
    if hasattr(lib, "dfd_decode_buffer_batch_rc"):
        lib.dfd_decode_buffer_batch_rc.restype = ctypes.c_int
        lib.dfd_decode_buffer_batch_rc.argtypes = [
            ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_long), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _U8P, _IP, ctypes.c_int,
        ]
    return lib


def available() -> bool:
    """True when the shared library is present and loads."""
    return _lib() is not None


def decode_batch(
    paths: list[str | Path], target: int, *, n_threads: int = 4, resize_target: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """-> (uint8 [N, target, target, 3], status [N], 0 on success; a failed
    slot is zero-filled). ``resize_target`` is the shorter-side size before
    the direct center crop to ``target`` (default ``target``)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native loader not available at {_LIB_PATH}")
    resize = int(resize_target) if resize_target else int(target)
    n = len(paths)
    out = np.zeros((n, target, target, 3), np.uint8)
    status = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.dfd_decode_batch_rc(c_paths, n, resize, target, out.ctypes.data_as(_U8P),
                            status.ctypes.data_as(_IP), max(int(n_threads), 1))
    return out, status


def has_buffer_batch() -> bool:
    """True when the library has the buffer-batch entry point
    (``dfd_decode_buffer_batch_rc``; rebuild with ``make -C native`` if not)."""
    lib = _lib()
    return lib is not None and hasattr(lib, "dfd_decode_buffer_batch_rc")


def decode_buffer_batch(
    buffers: list[bytes], target: int, *, n_threads: int = 4, resize_target: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """``decode_batch`` over in-memory JPEG/PNG buffers: (uint8 [N, target,
    target, 3], status [N], 0 on success; a failed slot is zero-filled), all
    buffers decoded by the library's pool in one call."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native loader not available at {_LIB_PATH}")
    if not hasattr(lib, "dfd_decode_buffer_batch_rc"):
        raise RuntimeError("native library has no dfd_decode_buffer_batch_rc; rebuild it with "
                           "`make -C native` or decode with PIL")
    resize = int(resize_target) if resize_target else int(target)
    n = len(buffers)
    out = np.zeros((n, target, target, 3), np.uint8)
    status = np.zeros((n,), np.int32)
    # the ctypes copies must outlive the call
    c_bufs = [(ctypes.c_ubyte * len(b)).from_buffer_copy(b) for b in buffers]
    ptrs = (_U8P * n)(*[ctypes.cast(b, _U8P) for b in c_bufs])
    lens = (ctypes.c_long * n)(*[len(b) for b in buffers])
    lib.dfd_decode_buffer_batch_rc(ptrs, lens, n, resize, target, out.ctypes.data_as(_U8P),
                                   status.ctypes.data_as(_IP), max(int(n_threads), 1))
    return out, status
