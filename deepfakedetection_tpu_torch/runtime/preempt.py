"""Preemption: SIGTERM -> mid-epoch checkpoint -> exact resume.

Port of ``deepfakedetection_tpu/runtime/preempt.py`` without JAX: ``trap``
asks ``torch.distributed`` for the process count. While the trap is active a
SIGTERM only sets a flag; the train loop polls ``requested()`` once per step,
saves ``latest.ckpt`` with the mid-epoch state and writes the
``inprogress.json`` sidecar (the JAX package's functions, which this module
re-exports) with the number of batches done. Single-process runs only; with
more than one process the trap is a no-op.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Any

from deepfakedetection_tpu.runtime.preempt import (
    clear_progress,
    progress_path,
    read_progress,
    write_progress,
)
from deepfakedetection_tpu_torch.runtime.paths import world_size

__all__ = [
    "clear_progress", "progress_path", "read_progress", "request", "requested", "reset",
    "trap", "write_progress",
]

# Set from the signal handler, so it lives at module level.
_requested = threading.Event()


def requested() -> bool:
    """Has a graceful stop been requested (SIGTERM or ``request()``)?"""
    return _requested.is_set()


def request() -> None:
    _requested.set()


def reset() -> None:
    _requested.clear()


class trap:
    """SIGTERM -> ``request()`` while the context is active, on the main
    thread of a single-process run unless ``DFD_NO_PREEMPT_TRAP=1``. The
    previous handler comes back and the flag clears on exit."""

    def __enter__(self) -> trap:
        self._prev: Any = None
        self._installed = False
        if os.environ.get("DFD_NO_PREEMPT_TRAP", "") in ("1", "true"):
            return self
        if world_size() > 1 or threading.current_thread() is not threading.main_thread():
            return self
        self._prev = signal.signal(signal.SIGTERM, lambda s, f: request())
        self._installed = True
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
        reset()
