"""Preemption: SIGTERM -> mid-epoch checkpoint -> exact resume.

Port of ``deepfakedetection_tpu/runtime/preempt.py``: ``trap`` asks
``torch.distributed`` for the process count. While the trap is active a
SIGTERM only sets a flag; the train loop polls ``requested()`` once per step,
saves ``latest.ckpt`` with the mid-epoch state and writes the
``inprogress.json`` sidecar beside it with the number of batches done (the
checkpoint's own counters still say "previous epoch completed"). Single-
process runs only; with more than one process the trap is a no-op.
"""

from __future__ import annotations

import json
import os
import signal
import threading
from pathlib import Path
from typing import Any

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


def progress_path(checkpoints_dir: Path) -> Path:
    return Path(checkpoints_dir) / "inprogress.json"


def write_progress(
    checkpoints_dir: Path, *, epoch: int, batches_done: int, batch_size: int
) -> None:
    """Records a mid-epoch stop, atomically (a temporary file, then rename)."""
    path = progress_path(checkpoints_dir)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(
        {"epoch": int(epoch), "batches_done": int(batches_done), "batch_size": int(batch_size)}
    ))
    tmp.rename(path)


def read_progress(checkpoints_dir: Path) -> dict[str, int] | None:
    """The sidecar's record, or None when there is none or it is corrupt (the
    resume then starts at the epoch's beginning)."""
    path = progress_path(checkpoints_dir)
    if not path.exists():
        return None
    try:
        rec = json.loads(path.read_text())
        return {k: int(rec[k]) for k in ("epoch", "batches_done", "batch_size")}
    except (ValueError, KeyError, TypeError):
        return None


def clear_progress(checkpoints_dir: Path) -> None:
    progress_path(checkpoints_dir).unlink(missing_ok=True)
