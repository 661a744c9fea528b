"""Console, stream tee, throughput meter and metrics.jsonl writer.

The JAX package's console, ``TeeStream``, ``Throughput`` and ``progress`` are
reused as they are; ``tee_output`` and ``append_metrics`` ask
``torch.distributed`` for the rank instead of JAX.
"""

from __future__ import annotations

import contextlib
import json
import sys
from collections.abc import Iterator
from pathlib import Path
from typing import Any

from deepfakedetection_tpu.runtime.logging import TeeStream, Throughput, console, progress
from deepfakedetection_tpu_torch.runtime.paths import rank, world_size

__all__ = ["TeeStream", "Throughput", "append_metrics", "console", "progress", "tee_output"]


@contextlib.contextmanager
def tee_output(log_path: Path) -> Iterator[None]:
    """Mirror stdout+stderr into ``log_path`` for the scope of the block;
    processes other than 0 tee into ``<name>.p<rank>``."""
    if world_size() > 1 and rank() != 0:
        log_path = log_path.with_name(f"{log_path.name}.p{rank()}")
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with log_path.open("a", encoding="utf-8") as fh:
        old_out, old_err = sys.stdout, sys.stderr
        sys.stdout = TeeStream(old_out, fh)  # type: ignore[assignment]
        sys.stderr = TeeStream(old_err, fh)  # type: ignore[assignment]
        try:
            yield
        finally:
            sys.stdout, sys.stderr = old_out, old_err


def append_metrics(metrics_path: Path, record: dict[str, Any]) -> None:
    """Append one JSON record to logs/metrics.jsonl, from process 0 only."""
    if rank() != 0:
        return
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    with metrics_path.open("a", encoding="utf-8") as fh:
        fh.write(json.dumps(record) + "\n")
