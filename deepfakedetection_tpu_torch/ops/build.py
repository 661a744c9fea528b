"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``ops/csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface under ``build/torch_kernels/`` at the
repository root. The library's name carries a hash of the sources and
flags, so an edited source builds anew and an unchanged one is reused. The
CPU never reaches this module: the kernel wrappers call ``library()`` only for
CUDA tensors. The first ``library()`` call builds and loads under a lock, so
threads that launch kernels at once (the server's batchers) share one build.

``define_op`` registers a wrapper as an operator of the ``dfd`` namespace
(``torch.ops.dfd.<name>``): a ``CUDA`` implementation that launches the
kernel, a ``CPU`` one that runs the plain version and a fake one that gives
the output's shapes to tracers (``torch.export``), through the low-level
``torch.library.Library`` route, which costs less a call than the
``custom_op`` decorator (``profile_dispatch``, ``PERF.md``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: name -> argtypes (pointers and the stream as c_void_p, so
# ctypes does not cut 64-bit addresses to a 32-bit int).
_SIGNATURES = {
    "dfd_attn4d": [_P] * 9 + [_I] * 5 + [_L] * 6 + [_I, _F, _I, _P],
    "dfd_attn4d_plan": [_I] * 6 + [_P],
    "dfd_attn4d_long": [_P] * 9 + [_I] * 5 + [_L] * 6 + [_I, _F, _I, _P],
    "dfd_attn4d_long_plan": [_I] * 6 + [_P],
    "dfd_attn_subblock": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    "dfd_attn_subblock_plan": [_I] * 4 + [_P],
    "dfd_attn_subblock_bwd": [_P, _I] + [_P] * 5 + [_I] + [_P] * 8 + [_I] * 5 + [_F, _P],
    "dfd_attn_subblock_bwd_plan": [_I] * 4 + [_P],
    "dfd_depthwise_plan": [_I] * 6 + [_P],
    "dfd_depthwise_silu_pool": [_P] * 5 + [_I] * 5 + [_P],
    "dfd_expand_dw_plan": [_I] * 7 + [_P],
    "dfd_expand_dw_silu_pool": [_P] * 8 + [_I] * 8 + [_P],
    "dfd_fused_mbconv_pack": [_P] * 6 + [_I] * 3 + [_P],
    "dfd_fused_mbconv_plan": [_I] * 2 + [_P],
    "dfd_fused_mbconv_se": [_P] * 16 + [_I] * 11 + [_P],
    "dfd_int8_depthwise": [_P] * 5 + [_I] * 12 + [_P],
    "dfd_shear_plan": [_I] * 5 + [_P],
    "dfd_silu_check": [_P, _P],
    "dfd_shear_rotate": [_P] * 4 + [_I] * 4 + [_F] * 2 + [_I] * 2 + [_P],
    "dfd_window_attention": [_P] * 5 + [_I] * 4 + [_L] * 12 + [_I, _F, _I, _P],
    "dfd_window_attention_plan": [_I] * 5 + [_P],
    "dfd_window_attention_bwd": [_P] * 5 + [_L, _P] + [_I] * 4 + [_L] * 4 + [_I, _F, _I, _P],
    "dfd_window_attention_bwd_plan": [_I] * 5 + [_P],
    "dfd_window_attention_long": [_P] * 5 + [_I] * 4 + [_L] * 12 + [_I, _F, _I, _P],
    "dfd_window_attention_long_plan": [_I] * 5 + [_P],
    "dfd_window_attention_long_bwd": [_P] * 5 + [_L, _P, _P, _L] + [_I] * 4 + [_L] * 4
    + [_I, _F, _I, _P],
    "dfd_window_attention_long_bwd_plan": [_I] * 5 + [_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libdfd_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the kernels unless this exact build exists: one nvcc process
    per source, in parallel, then one link. Raises with nvcc's output when a
    step fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = str(os.getpid())
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    failed = []
    for _, cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}{stderr}")
    objs = [obj for obj, _, _ in jobs]
    tmp = out.with_suffix(f".{tag}.tmp")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


_load_lock = threading.Lock()
_loaded: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. The first callers
    wait on one lock, so the library is built and loaded once per process:
    ``build`` names its objects by process id, and two threads building at
    once would compile and link into the same files."""
    global _loaded
    if _loaded is None:
        with _load_lock:
            if _loaded is None:
                _loaded = _load()
    return _loaded


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dfd_error_string.argtypes = [ctypes.c_int]
    lib.dfd_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raises when a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().dfd_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")


# one fragment for every module's operators: each module defines its own
_LIB = torch.library.Library("dfd", "FRAGMENT")


def define_op(schema: str, *, cuda: Callable, cpu: Callable, fake: Callable):
    """Registers ``dfd::<schema>`` with its CUDA, CPU and fake
    implementations and returns ``torch.ops.dfd.<name>``. The operator has no
    autograd kernel: callers that need a gradient wrap it in an
    ``autograd.Function``."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"dfd::{name}", fake, lib=_LIB)
    return getattr(torch.ops.dfd, name)
