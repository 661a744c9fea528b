"""Checkpoints of a training run, written with ``torch.save``.

Port of ``deepfakedetection_tpu/runtime/checkpoint.py``'s contract:
``latest.ckpt`` every epoch (epoch counters, model, optimizer, schedule
position, EMA), ``best.ckpt`` and ``<weights_key>.pth`` on improvement, and
auto-resume from ``latest.ckpt``. Each file is written to a temporary name
and renamed over the old one, so a crash mid-write never loses the previous
checkpoint. The ``.pth`` is a plain torch state dict under the
efficientnet_pytorch names, which the eval job loads with ``weights: auto``.
``AsyncSaver`` (``training.async_checkpoint``) writes them on a worker
thread while the next epoch trains; ``InlineSaver`` at once, with the same
interface. Under a process group rank 0 writes, and every rank passes a
barrier after each write before any of them reads it or goes on.
"""

from __future__ import annotations

import os
from collections.abc import Callable
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import torch

from deepfakedetection_tpu_torch.parallel import multihost
from deepfakedetection_tpu_torch.parallel.mesh import data_axis
from deepfakedetection_tpu_torch.runtime.paths import rank


def latest_path(checkpoints_dir: Path) -> Path:
    return Path(checkpoints_dir) / "latest.ckpt"


def best_path(checkpoints_dir: Path) -> Path:
    return Path(checkpoints_dir) / "best.ckpt"


def has_latest(checkpoints_dir: Path) -> bool:
    return latest_path(checkpoints_dir).exists()


def _map_tensors(obj: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``obj`` with ``fn`` applied to every tensor and every dict, list and
    tuple rebuilt."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _cpu(obj: Any) -> Any:
    return _map_tensors(obj, lambda t: t.detach().cpu())


def save(path: Path, obj: Any) -> None:
    """``torch.save`` of ``obj`` (tensors moved to the CPU) to ``path``,
    atomically, from process 0 only."""
    if rank() != 0:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    torch.save(_cpu(obj), tmp)
    os.replace(tmp, path)


def load(path: Path) -> Any:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def export_weights(path: Path, model: torch.nn.Module) -> Path:
    """The model's state dict (parameters and BN statistics) as a ``.pth``."""
    save(path, model.state_dict())
    return Path(path)


def _snapshot(obj: Any, devices: set[torch.device]) -> Any:
    """``obj`` with every tensor copied on its device and every container
    rebuilt, so that in-place updates of the originals leave it as it is;
    the CUDA devices of the copies go into ``devices``."""
    def copy(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            devices.add(t.device)
        return t.detach().clone()

    return _map_tensors(obj, copy)


class InlineSaver:
    """The epoch-end writes done at once on the calling thread, with
    ``AsyncSaver``'s interface: the trainer's writer without
    ``training.async_checkpoint``. Each write is followed by a barrier."""

    def submit_tree(self, path: Path, obj: Any) -> None:
        save(path, obj)
        multihost.barrier()

    def submit_export(self, path: Path, model: torch.nn.Module) -> None:
        export_weights(path, model)
        multihost.barrier()

    def submit_call(self, fn: Callable[..., Any], *args: Any) -> None:
        fn(*args)

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


class AsyncSaver:
    """The epoch-end writes on one worker thread, overlapping the next
    epoch's steps; the counterpart of the JAX package's ``AsyncSaver``.

    A submit snapshots its tensors on the calling thread with a copy on
    their device: ``model.state_dict()`` and the optimizer's state alias the
    live tensors that the next ``opt.step`` updates in place. The worker
    waits for the copies (an event on each device's current stream), moves
    them to the host and writes them as ``save`` does (a temporary name,
    then a rename). Work runs in submission order, so ``latest.ckpt`` ends
    up holding the newest state and a queued call (``submit_call``) runs
    only after every write before it has landed. ``wait()`` drains the queue
    and re-raises the first failure: a lost checkpoint would break resume.

    Under a process group the JAX saver's protocol holds: the worker issues
    no collective (one from a second thread would interleave with the train
    step's, a deadlock the JAX package measured). Rank 0's worker writes
    ``<name>.tmp``; the rename to ``<name>`` and the barrier after it run on
    the main thread at the next drain point (the next write to that path,
    ``wait()`` or ``close()``), so ``latest.ckpt`` is always complete and
    lags the write in flight by at most one epoch. The drain's barrier tells
    every rank whether rank 0's write failed, and each raises. The ``.pth``
    export is written at once, then a barrier; a queued call runs on every
    rank once the writes submitted before it have been renamed."""

    def __init__(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save")
        self._futures: list[Future] = []
        self._multi = data_axis() is not None
        # under a process group: final path -> (its .tmp, rank 0's write)
        self._pending: dict[Path, tuple[Path, Future | None]] = {}
        # calls waiting for the paths still pending when they were queued
        self._calls: list[tuple[set[Path], Callable[..., Any], tuple]] = []

    def _write_later(self, path: Path, obj: Any) -> Future:
        """``save(path, obj)`` of a snapshot of ``obj`` taken now, queued."""
        devices: set[torch.device] = set()
        snap = _snapshot(obj, devices)
        copied = []
        for device in devices:
            copied.append(torch.cuda.Event())
            copied[-1].record(torch.cuda.current_stream(device))

        def write() -> None:
            for event in copied:
                event.synchronize()
            save(path, snap)

        return self._pool.submit(write)

    def submit_tree(self, path: Path, obj: Any) -> None:
        """``save(path, obj)`` of a snapshot of ``obj`` taken now."""
        if not self._multi:
            self._futures.append(self._write_later(path, obj))
            return
        path = Path(path)
        self._drain(path)  # the last write to this path lands before its .tmp is reused
        tmp = path.with_name(f"{path.name}.tmp")
        self._pending[path] = (tmp, self._write_later(tmp, obj) if rank() == 0 else None)

    def _drain(self, path: Path) -> None:
        """Under a process group: waits for rank 0's write to ``path``, renames
        it into place, passes the barrier (which carries the write's failure
        to every rank), then runs the calls that were waiting for it."""
        if path not in self._pending:
            return
        tmp, future = self._pending.pop(path)
        error = future.exception() if future is not None else None
        if future is not None and error is None:
            os.replace(tmp, path)
        failed = multihost.broadcast_object(repr(error) if error is not None else None)
        if error is not None:
            raise error
        if failed is not None:
            raise RuntimeError(f"rank 0's write of {path.name} failed: {failed}")
        ready = []
        for waiting in self._calls:
            waiting[0].discard(path)
            if not waiting[0]:
                ready.append(waiting)
        for waiting in ready:
            self._calls.remove(waiting)
            waiting[1](*waiting[2])

    def submit_export(self, path: Path, model: torch.nn.Module) -> None:
        """``export_weights(path, model)`` of the model as it is now."""
        if self._multi:
            export_weights(path, model)
            multihost.barrier()
            return
        self.submit_tree(path, model.state_dict())

    def submit_call(self, fn: Callable[..., Any], *args: Any) -> None:
        """``fn(*args)`` after every write submitted before it: on the worker,
        or under a process group on each rank's main thread once those
        writes are renamed."""
        if not self._multi:
            self._futures.append(self._pool.submit(fn, *args))
        elif self._pending:
            self._calls.append((set(self._pending), fn, args))
        else:
            fn(*args)

    def wait(self) -> None:
        """Blocks until everything submitted has run; re-raises the first
        failure."""
        futures, self._futures = self._futures, []
        for error in [f.exception() for f in futures]:
            if error is not None:
                raise error
        for path in list(self._pending):
            self._drain(path)

    def close(self) -> None:
        """``wait()``, then the worker thread ends (idempotent)."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
