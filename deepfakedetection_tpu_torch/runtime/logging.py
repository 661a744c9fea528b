"""Console, stream tee, throughput meter and metrics.jsonl writer.

The port's copy of ``deepfakedetection_tpu/runtime/logging.py``: a rich
console, the stdout/stderr tee into per-run logs, a live progress bar with
img/s on an interactive terminal (a bare meter otherwise, so tee'd logs stay
plain), and append-only ``metrics.jsonl``. ``tee_output`` and
``append_metrics`` ask ``torch.distributed`` for the rank.
"""

from __future__ import annotations

import contextlib
import json
import sys
from collections.abc import Iterator
from pathlib import Path
from time import perf_counter
from typing import Any, TextIO

from rich.console import Console

from deepfakedetection_tpu_torch.runtime.paths import rank, world_size

console = Console()


class TeeStream:
    """Writes to a stream and mirrors them into a log file."""

    def __init__(self, stream: TextIO, log_file: TextIO) -> None:
        self._stream = stream
        self._log = log_file

    def write(self, data: str) -> int:
        n = self._stream.write(data)
        with contextlib.suppress(ValueError):  # the log was closed
            self._log.write(data)
        return n

    def flush(self) -> None:
        self._stream.flush()
        with contextlib.suppress(ValueError):
            self._log.flush()

    def isatty(self) -> bool:
        return bool(getattr(self._stream, "isatty", lambda: False)())

    def fileno(self) -> int:
        return self._stream.fileno()


class Throughput:
    """img/s since the meter started."""

    def __init__(self) -> None:
        self.start = perf_counter()
        self.seen = 0

    def update(self, n: int) -> float:
        self.seen += n
        return self.seen / max(perf_counter() - self.start, 1e-6)


@contextlib.contextmanager
def progress(description: str, total: int | None) -> Iterator[Any]:
    """Yields ``update(n_images) -> img/s``; draws a rich progress bar only
    on an interactive terminal."""
    if not getattr(sys.stdout, "isatty", lambda: False)():
        yield Throughput().update
        return
    from rich.progress import BarColumn, MofNCompleteColumn, Progress, TextColumn, TimeElapsedColumn

    prog = Progress(
        TextColumn("[progress.description]{task.description}"),
        BarColumn(),
        MofNCompleteColumn(),
        TextColumn("{task.fields[rate]:>8.1f} img/s"),
        TimeElapsedColumn(),
        console=console,
        transient=True,
    )
    with prog:
        task = prog.add_task(description, total=total, rate=0.0)
        meter = Throughput()

        def update(n: int) -> float:
            rate = meter.update(n)
            prog.update(task, advance=n, rate=rate)
            return rate

        yield update


def process_log_path(log_path: Path) -> Path:
    """This process's log: ``log_path`` on process 0, ``<name>.p<rank>``
    on the others."""
    if world_size() > 1 and rank() != 0:
        return log_path.with_name(f"{log_path.name}.p{rank()}")
    return log_path


@contextlib.contextmanager
def tee_output(log_path: Path) -> Iterator[None]:
    """Mirror stdout+stderr into this process's ``log_path``
    (``process_log_path``) for the scope of the block."""
    log_path = process_log_path(log_path)
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
