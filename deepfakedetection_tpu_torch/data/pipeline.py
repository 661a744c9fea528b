"""Eval loader over the JAX package's host pipeline, and the host-to-device copy.

``Loader`` is the JAX package's loader (``deepfakedetection_tpu/data/
pipeline.py``: decode, static batches, zero padding with a validity mask)
with the process count and index taken from ``torch.distributed`` instead of
JAX. ``DeviceStager`` moves each uint8 batch to the device through pinned
host buffers with a ``non_blocking`` copy.
"""

from __future__ import annotations

import numpy as np
import torch

from deepfakedetection_tpu.data import pipeline as _jax_pipeline
from deepfakedetection_tpu.data.folder import ImageFolderDataset, scan_image_folder
from deepfakedetection_tpu.data.pipeline import Batch
from deepfakedetection_tpu.data.transforms import EvalTransformPlan, build_eval_plan
from deepfakedetection_tpu_torch.runtime.paths import rank, world_size

__all__ = [
    "Batch", "DeviceStager", "Loader", "build_eval_plan", "make_eval_loader",
    "scan_image_folder",
]


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
) -> Loader:
    """Deterministic-order loader; the final batch zero-padded with a mask."""
    return Loader(
        dataset, plan, batch_size=batch_size, shuffle=False, drop_last=False,
        num_workers=num_workers, lookahead=lookahead,
    )


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
