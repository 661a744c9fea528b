"""Multi-process runs: the process group and the host-side collectives.

Port of ``deepfakedetection_tpu/parallel/multihost.py``. JAX runs one
process a host over the devices of a pod; the port runs one process a card,
launched by ``torchrun`` (or any launcher that sets its environment)::

    torchrun --nproc-per-node N -m deepfakedetection_tpu_torch.orchestrator \\
        --mode training --config CFG

``maybe_initialize`` joins the process group (NCCL between cards, gloo with
``device: cpu``). The host-side collectives (``allgather_examples``, the
run id, the checkpoint barriers) carry numpy payloads, and a checkpoint
barrier must not interleave with the train step's device collectives, so
they run on a gloo group of their own beside an NCCL default group
(``host_group``). Without a process group every function here is the
single-process identity; with one, a world of one runs the collectives all
the same.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from deepfakedetection_tpu_torch.parallel import mesh

# the default group that the host group below was made beside, and that group
_HOST: tuple[object, object] | None = None


def requested() -> bool:
    """``DFD_MULTIHOST=1``, or torchrun's environment for more than one
    process (``WORLD_SIZE`` > 1 and ``MASTER_ADDR``)."""
    env = os.environ
    if env.get("DFD_MULTIHOST") == "1":
        return True
    return int(env.get("WORLD_SIZE", "1") or 1) > 1 and bool(env.get("MASTER_ADDR"))


def local_rank() -> int:
    """The process's card on its host: ``LOCAL_RANK`` (torchrun's), else 0."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def maybe_initialize(cpu: bool = False) -> bool:
    """Joins the process group when ``requested()``: gloo when ``cpu`` (the
    config's ``device: cpu``), else NCCL on card ``LOCAL_RANK``, made the
    current device before anything is allocated on a card. The rendezvous is
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``). Idempotent: returns True when a group is up, whoever
    made it. A failed initialisation raises; nothing goes on as one process."""
    if dist.is_initialized():
        return True
    if not requested():
        return False
    if cpu:
        dist.init_process_group("gloo", init_method="env://")
        return True
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a multi-process run on the card needs CUDA, and none is available; "
            "set device: cpu to run the ranks on the CPU over gloo"
        )
    torch.cuda.set_device(local_rank())
    dist.init_process_group("nccl", init_method="env://")
    return True


def host_group():
    """The group of the host-side collectives: the default group under
    gloo, else a gloo group over the same ranks, made on first use (every
    rank reaches its first host collective at the same point of the run)."""
    global _HOST
    default = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return default
    if _HOST is None or _HOST[0] is not default:
        _HOST = (default, dist.new_group(backend="gloo"))
    return _HOST[1]


def barrier() -> None:
    """Every rank waits here for the others (host group); no-op without a
    process group."""
    if dist.is_initialized():
        dist.barrier(group=host_group())


def broadcast_object(value, src: int = 0):
    """Rank ``src``'s ``value`` on every rank (picklable; host group)."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src, group=host_group())
    return box[0]


def local_rows(t: torch.Tensor) -> np.ndarray:
    """This process's rows of a batch, on the host. Each rank's tensor holds
    only its own rows (the loader decoded them), so this is a copy to the
    host; the JAX package must pick the addressable shards of a global
    array."""
    return t.detach().cpu().numpy()


def allgather_examples(arr: np.ndarray) -> np.ndarray:
    """Every data index's rows of ``arr`` (a ragged leading dim)
    concatenated in data-index order, on every rank: the counts first, then
    the rows padded to the largest count, gathered, and trimmed. The ranks
    of one data index (a model axis's) hold the same rows, so the first
    rank of each gives them. Without a process group it is the identity."""
    if not dist.is_initialized():
        return arr
    group = host_group()
    world = dist.get_world_size()
    arr = np.ascontiguousarray(arr)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([arr.shape[0]], dtype=torch.int64), group=group)
    counts = [int(c) for c in counts]
    padded = np.zeros((max(counts),) + arr.shape[1:], arr.dtype)
    padded[: arr.shape[0]] = arr
    rows = [torch.from_numpy(np.zeros_like(padded)) for _ in range(world)]
    dist.all_gather(rows, torch.from_numpy(padded), group=group)
    active = mesh.active()
    step = active.model if active is not None else 1
    return np.concatenate([r.numpy()[:n] for r, n in zip(rows, counts)][::step])
