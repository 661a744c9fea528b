"""The host loader, and the host-to-device copy.

``Loader`` is the port's copy of the loader of
``deepfakedetection_tpu/data/pipeline.py``: decode (PIL in a thread pool, or
the native library, which training takes when it is built and eval with
``DFD_NATIVE_EVAL=1``; a tar-shard split, ``data/shards.py``, is decoded
from its members' bytes the same two ways), static batches, the last eval
batch zero-padded with a validity mask, seeded per-epoch shuffling with ``set_epoch``, and up to
``lookahead`` batches decoding ahead of the consumer. With more than one
``torch.distributed`` process each decodes a disjoint contiguous shard of
the epoch order, the same number of batches on every process (training
drops the global remainder, eval pads with masked rows), and ``batch_size``
is the global batch, which the process count must divide.
``DeviceStager`` moves each uint8 batch to the device through pinned host
buffers with a ``non_blocking`` copy. ``prefetch`` stages the next batch
(copy and augmentation) on a second CUDA stream while the caller's step
runs, as the JAX package's ``device_prefetch`` does through async dispatch.
"""

from __future__ import annotations

import io
import os
from collections import deque
from collections.abc import Callable, Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from PIL import Image

from deepfakedetection_tpu_torch.data import native
from deepfakedetection_tpu_torch.data.decode import (
    decode_eval,
    decode_pil_eval,
    decode_pil_train,
    decode_train,
)
from deepfakedetection_tpu_torch.data.folder import ImageFolderDataset, scan_image_folder
from deepfakedetection_tpu_torch.data.transforms import (
    EvalTransformPlan,
    TrainTransformPlan,
    build_eval_plan,
    build_train_plan,
)
from deepfakedetection_tpu_torch.parallel.mesh import data_axis

__all__ = [
    "Batch", "DeviceStager", "Loader", "build_eval_plan", "build_train_plan",
    "make_eval_loader", "make_train_loader", "prefetch", "scan_image_folder",
]

Staged = tuple[torch.Tensor, ...]


@dataclass
class Batch:
    images: np.ndarray  # uint8 [B, S, S, 3]
    labels: np.ndarray  # int64 [B]
    mask: np.ndarray  # bool [B], False on padding rows
    num_valid: int


class Loader:
    """Iterable over padded (eval) or dropped (training) batches of decoded
    uint8 images."""

    def __init__(
        self,
        dataset: ImageFolderDataset,
        plan: TrainTransformPlan | EvalTransformPlan,
        *,
        batch_size: int,
        shuffle: bool,
        drop_last: bool,
        seed: int | None = None,
        num_workers: int = 0,
        cache_decoded: bool = False,
        lookahead: int = 1,
        shard: bool = True,
    ) -> None:
        # the data axis: the ranks of one model index read the same rows
        self.index, self.world = (data_axis() or (0, 1)) if shard else (0, 1)
        if batch_size % self.world:
            raise ValueError(
                f"batch size {batch_size} does not divide over {self.world} processes"
            )
        self.dataset = dataset
        self.plan = plan
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = 0 if seed is None else int(seed)
        self.num_workers = int(num_workers)
        self.lookahead = max(1, int(lookahead))
        self._epoch = 0
        self._train = isinstance(plan, TrainTransformPlan)
        self._target = plan.host_canvas_size if self._train else plan.img_size
        self.use_native = native.available() and (
            self._train or os.environ.get("DFD_NATIVE_EVAL") == "1"
        )
        # the host decode is the same every epoch (all randomness is on the
        # device), so cached canvases make later epochs decode-free
        self.cache_decoded = bool(cache_decoded)
        self._cache: dict[int, np.ndarray] = {}
        self._pool: ThreadPoolExecutor | None = None

    def set_epoch(self, epoch: int) -> None:
        """Selects the epoch's shuffled order."""
        self._epoch = int(epoch)

    def _local_batch_rows(self) -> int:
        return max(self.batch_size // self.world, 1)

    def _shard_len(self) -> int:
        n, pc = len(self.dataset), self.world
        if pc == 1:
            return n
        return n // pc if self.shuffle else -(-n // pc)

    def _order(self) -> np.ndarray:
        """This process's sample slots for the epoch (-1 marks a padding slot
        of multi-process eval)."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng([self.seed, self._epoch]).permutation(n)
        else:
            order = np.arange(n)
        pc = self.world
        if pc == 1:
            return order
        per = self._shard_len()
        if not self.shuffle and per * pc > n:
            order = np.concatenate([order, np.full(per * pc - n, -1, order.dtype)])
        return order[self.index * per : (self.index + 1) * per]

    def __len__(self) -> int:
        rows, n = self._local_batch_rows(), self._shard_len()
        return n // rows if self.drop_last else -(-n // rows)

    def _decode_indices(self, idx: np.ndarray) -> Batch:
        B = self._local_batch_rows()
        images = np.zeros((B, self._target, self._target, 3), np.uint8)
        labels = np.zeros((B,), np.int64)
        mask = np.zeros((B,), bool)
        valid_pos = [k for k, i in enumerate(idx) if int(i) >= 0]
        for k in valid_pos:
            labels[k] = self.dataset.samples[int(idx[k])][1]
        if self.cache_decoded:
            todo = [k for k in valid_pos if int(idx[k]) not in self._cache]
            if todo:
                decoded, ok = self._decode_raw(np.asarray([int(idx[k]) for k in todo]))
                for k, arr, good in zip(todo, decoded, ok):
                    if good:
                        self._cache[int(idx[k])] = arr
            for k in valid_pos:
                arr = self._cache.get(int(idx[k]))
                if arr is not None:
                    images[k], mask[k] = arr, True
        elif valid_pos:
            decoded, ok = self._decode_raw(np.asarray([int(idx[k]) for k in valid_pos]))
            for j, k in enumerate(valid_pos):
                images[k], mask[k] = decoded[j], ok[j]
        return Batch(images=images, labels=labels, mask=mask, num_valid=int(mask.sum()))

    def _decode_raw(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The samples ``idx`` -> (uint8 [n, T, T, 3], ok [n])."""
        if hasattr(self.dataset, "read_bytes"):
            return self._decode_bytes([int(i) for i in idx])
        paths = [self.dataset.samples[i][0] for i in idx]
        if self.use_native:
            decoded, status = native.decode_batch(
                paths, self._target, n_threads=max(self.num_workers, 1),
                resize_target=self._resize_target(),
            )
            return decoded, status == 0
        decode = decode_train if self._train else decode_eval
        return self._map(lambda p: decode(p, self.plan), paths), np.ones(len(idx), bool)

    def _decode_bytes(self, ids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """A bytes-backed dataset's samples (tar shards): with the native
        library, the members read in turn and decoded in one buffer-batch
        call at the file branch's geometry; else PIL decodes each from
        memory in the loader's pool."""
        if self.use_native and native.has_buffer_batch():
            decoded, status = native.decode_buffer_batch(
                [self.dataset.read_bytes(i) for i in ids], self._target,
                n_threads=max(self.num_workers, 1), resize_target=self._resize_target(),
            )
            return decoded, status == 0
        decode = decode_pil_train if self._train else decode_pil_eval

        def decode_one(i: int) -> np.ndarray:
            with Image.open(io.BytesIO(self.dataset.read_bytes(i))) as img:
                return decode(img, self.plan)

        return self._map(decode_one, ids), np.ones(len(ids), bool)

    def _resize_target(self) -> int:
        """The shorter side's size before the native decoder's direct crop."""
        return self._target if self._train else (self.plan.resize_size or self.plan.img_size)

    def _map(self, fn, items: list) -> np.ndarray:
        """``fn`` over ``items`` in the decode pool (inline without
        workers), stacked."""
        if self.num_workers > 0:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            return np.stack(list(self._pool.map(fn, items)))
        return np.stack([fn(x) for x in items])

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        B = self._local_batch_rows()
        n_full = len(order) // B
        chunks = [order[i * B : (i + 1) * B] for i in range(n_full)]
        if not self.drop_last and len(order) > n_full * B:
            chunks.append(order[n_full * B :])
        if not chunks:
            return
        with ThreadPoolExecutor(max_workers=self.lookahead) as ahead:
            pending = deque(ahead.submit(self._decode_indices, c)
                            for c in chunks[: self.lookahead])
            for nxt in chunks[self.lookahead :]:
                current = pending.popleft().result()
                pending.append(ahead.submit(self._decode_indices, nxt))
                yield current
            while pending:
                yield pending.popleft().result()


def make_eval_loader(
    dataset: ImageFolderDataset,
    plan: EvalTransformPlan,
    *,
    batch_size: int,
    num_workers: int = 0,
    lookahead: int = 2,
    cache_decoded: bool = False,
    shard: bool = True,
) -> Loader:
    """Deterministic-order loader; the final batch zero-padded with a mask.
    ``shard=False`` gives every process the whole split in batches of
    ``batch_size``."""
    return Loader(
        dataset, plan, batch_size=batch_size, shuffle=False, drop_last=False,
        num_workers=num_workers, lookahead=lookahead, cache_decoded=cache_decoded,
        shard=shard,
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
