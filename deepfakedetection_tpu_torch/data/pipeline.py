"""Loaders over the JAX package's host pipeline, and the host-to-device copy.

``Loader`` is the JAX package's loader (``deepfakedetection_tpu/data/
pipeline.py``: decode, static batches, zero padding with a validity mask,
seeded per-epoch shuffling with ``set_epoch``) with the process count and
index taken from ``torch.distributed`` instead of JAX. ``DeviceStager``
moves each uint8 batch to the device through pinned host buffers with a
``non_blocking`` copy. ``prefetch`` stages the next batch (copy and
augmentation) on a second CUDA stream while the caller's step runs, as the
JAX package's ``device_prefetch`` does through async dispatch.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Iterator

import numpy as np
import torch

from deepfakedetection_tpu.data import pipeline as _jax_pipeline
from deepfakedetection_tpu.data.folder import ImageFolderDataset, scan_image_folder
from deepfakedetection_tpu.data.pipeline import Batch
from deepfakedetection_tpu.data.transforms import (
    EvalTransformPlan,
    TrainTransformPlan,
    build_eval_plan,
    build_train_plan,
)
from deepfakedetection_tpu_torch.runtime.paths import rank, world_size

__all__ = [
    "Batch", "DeviceStager", "Loader", "build_eval_plan", "build_train_plan",
    "make_eval_loader", "make_train_loader", "prefetch", "scan_image_folder",
]

Staged = tuple[torch.Tensor, ...]


class Loader(_jax_pipeline.Loader):
    """The JAX package's loader; rank and world size from torch.distributed
    when it is initialised, else 0 and 1."""

    @staticmethod
    def _processes() -> tuple[int, int]:
        return world_size(), rank()


def make_eval_loader(
    dataset: ImageFolderDataset,
    plan: EvalTransformPlan,
    *,
    batch_size: int,
    num_workers: int = 0,
    lookahead: int = 2,
    cache_decoded: bool = False,
) -> Loader:
    """Deterministic-order loader; the final batch zero-padded with a mask."""
    return Loader(
        dataset, plan, batch_size=batch_size, shuffle=False, drop_last=False,
        num_workers=num_workers, lookahead=lookahead, cache_decoded=cache_decoded,
    )


def make_train_loader(
    dataset: ImageFolderDataset,
    plan: TrainTransformPlan,
    *,
    batch_size: int,
    seed: int | None,
    num_workers: int = 0,
    cache_decoded: bool = False,
) -> Loader:
    """Shuffled per ``set_epoch`` from ``(seed, epoch)``, last partial batch
    dropped; host canvases of ``plan.host_canvas_size``."""
    return Loader(
        dataset, plan, batch_size=batch_size, shuffle=True, drop_last=True, seed=seed,
        num_workers=num_workers, cache_decoded=cache_decoded,
    )


def prefetch(
    batches: Iterable[Batch], stage: Callable[[Batch, int], Staged], device: torch.device,
    skip: int = 0,
) -> Iterator[tuple[Staged, int]]:
    """Yields ``(stage(batch, i), batch.num_valid)`` for the batches after the
    first ``skip``, keeping ``i`` the batch's index in ``batches``; ``stage``
    returns a tuple of tensors. On a CUDA device batch i + 1 is staged on a
    side stream before batch i is handed out, so its copy and augmentation
    overlap the caller's work on batch i; the caller's stream waits for the
    staging before it uses the tensors."""
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    staged = None
    for i, batch in enumerate(batches):
        if i < skip:
            continue
        event = None
        if side is None:
            out = stage(batch, i)
        else:
            with torch.cuda.stream(side):
                out = stage(batch, i)
                event = torch.cuda.Event()
                event.record(side)
        if staged is not None:
            yield _ready(*staged, device)
        staged = (out, event, batch.num_valid)
    if staged is not None:
        yield _ready(*staged, device)


def _ready(out, event, num_valid: int, device: torch.device):
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in out:
            t.record_stream(current)  # allocated on the side stream, used here
    return out, num_valid


class DeviceStager:
    """Copies uint8 batches to ``device``. On a CUDA device each batch goes
    through one of ``SLOTS`` pinned host buffers and a ``non_blocking`` copy
    on the current stream; a buffer is refilled only after the copy out of it
    has finished (its event). On the CPU the array is wrapped as it is."""

    SLOTS = 3  # host-to-device copies in flight at once

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._buffers: list[torch.Tensor] = []
        self._events: list[torch.cuda.Event | None] = []
        self._next = 0

    def __call__(self, images: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type != "cuda":
            return host.to(self.device)
        if not self._buffers or self._buffers[0].shape != host.shape:
            self._buffers = [
                torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                for _ in range(self.SLOTS)
            ]
            self._events = [None] * self.SLOTS
        i = self._next
        self._next = (i + 1) % self.SLOTS
        if self._events[i] is not None:
            self._events[i].synchronize()
        self._buffers[i].copy_(host)
        out = self._buffers[i].to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[i] = event
        return out
