"""The ``("data", "model")`` mesh over ``torch.distributed`` ranks, and the
data axis's collectives inside a train step.

Port of ``deepfakedetection_tpu/parallel/mesh.py``. There the step is one
program over a device mesh, and GSPMD inserts the all-reduces of a
data-parallel step; here each rank runs the step on its rows of the global
batch and issues them itself, so that a k-rank step computes what one
process computes on the whole global batch (``docs/SCALING.md``):

- ``sum_over_data``: a sum over the ranks with a backward (the sum of the
  incoming gradients), for BatchNorm's batch statistics, whose gradient
  reaches every rank's rows;
- ``all_reduce_`` and ``all_reduce_gradients``: in-place sums, for the loss
  normaliser, the logged counts and the phase's gradients (one flat buffer);
- ``global_rows``: a rank's random draws (augmentation, dropout,
  drop-path) are its rows of the draw for the global batch;
- ``roll_batch``: the global batch rolled by one (mixup's partner).

Each of them acts whenever a process group is up, a world of one included,
and is the single-process computation without one. The model axis (the JAX
package's tensor-parallel ``param_shardings``) is not ported: ``make_mesh``
refuses ``model > 1``.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

MODEL_AXIS_ITEM = "ROADMAP Queue 1 item 14 (model-axis sharding)"


@dataclass(frozen=True)
class Mesh:
    """The run's mesh: ``data`` ranks (the world) by ``model`` 1, this
    process's rank, and its device."""

    data: int
    model: int
    rank: int
    world: int
    device: torch.device


def mesh_dims(config: dict[str, Any]) -> tuple[int, int]:
    """The YAML ``mesh:`` block as (data, model), validated as the JAX
    orchestrator's ``_mesh_dims``: data -1 (every process) or >= 1, model
    >= 1."""
    mesh = config.get("mesh") or {}
    data = int(mesh.get("data") if mesh.get("data") is not None else -1)
    model = int(mesh.get("model") if mesh.get("model") is not None else 1)
    if data == 0 or data < -1 or model < 1:
        raise ValueError(
            f"invalid mesh config data={data} model={model}: data must be -1 "
            "(all remaining devices) or >= 1, model must be >= 1"
        )
    return data, model


def data_axis() -> tuple[int, int] | None:
    """(rank, world) of the data axis when a process group is up, else None."""
    if not dist.is_initialized():
        return None
    return dist.get_rank(), dist.get_world_size()


def make_mesh(data: int = -1, model: int = 1, device: torch.device | None = None) -> Mesh:
    """The mesh of this run: ``data`` must be -1 or the number of processes
    (a larger one exceeds them, a smaller one would leave ranks idle), and
    ``model`` 1 (``MODEL_AXIS_ITEM``)."""
    mesh_dims({"mesh": {"data": data, "model": model}})
    if model > 1:
        raise NotImplementedError(
            f"mesh model={model}: sharding parameters over a model axis (the JAX "
            f"package's param_shardings) is {MODEL_AXIS_ITEM}; the port runs model=1"
        )
    rank, world = data_axis() or (0, 1)
    if data == -1:
        data = world
    if data > world:
        raise ValueError(f"mesh {data}x{model} exceeds {world} processes")
    if data < world:
        raise ValueError(
            f"mesh {data}x{model} would leave {world - data} of {world} processes idle; "
            f"set mesh.data to -1 or {world}"
        )
    return Mesh(data=data, model=model, rank=rank, world=world,
                device=torch.device(device) if device is not None else torch.device("cpu"))


def shard_batch(mesh: Mesh, arrays: Any) -> Any:
    """This rank's rows (numpy arrays or tensors, alone or in a tuple, list
    or dict) on the rank's device. The JAX package assembles a global array
    from each process's rows (``make_array_from_process_local_data``); here
    the loader has already given this rank its rows of the global batch."""
    if isinstance(arrays, dict):
        return {k: shard_batch(mesh, v) for k, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(shard_batch(mesh, v) for v in arrays)
    if isinstance(arrays, np.ndarray):
        arrays = torch.from_numpy(arrays)
    return arrays.to(mesh.device)


class _SumOverData(torch.autograd.Function):
    """A sum over the ranks whose backward sums the incoming gradients: what
    ``torch.distributed.nn.functional.all_reduce`` computes (deprecated in
    torch 2.13)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _SumOverData.apply(grad)


def sum_over_data(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable; ``t`` without a group."""
    return t if data_axis() is None else _SumOverData.apply(t)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks in place (no gradient); returns it."""
    if data_axis() is not None:
        dist.all_reduce(t)
    return t


def all_reduce_gradients(grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The phase's gradients summed over the ranks through one flat buffer
    (one collective a step), each back in its tensor's shape; the list as
    it is without a group."""
    if data_axis() is None or not grads:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    return [f.view(g.shape) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def global_rows(n: int) -> tuple[int, int] | None:
    """(rows of the global batch, this rank's first row) for a local batch
    of ``n`` rows, every rank's equal (the loader's lockstep); None without a
    group. A random draw made for the global rows and sliced here equals the
    single-process draw on the whole batch."""
    axis = data_axis()
    if axis is None:
        return None
    rank, world = axis
    return n * world, n * rank


def roll_batch(t: torch.Tensor) -> torch.Tensor:
    """``torch.roll(t, 1, 0)`` of the global batch, this rank's rows: row 0
    takes the previous rank's last row (rank 0 the last rank's), by an
    all-gather of every rank's last row."""
    out = torch.roll(t, 1, 0)
    axis = data_axis()
    if axis is None:
        return out
    rank, world = axis
    last = t[-1:].contiguous()
    rows = [torch.empty_like(last) for _ in range(world)]
    dist.all_gather(rows, last)
    out[0] = rows[(rank - 1) % world][0]
    return out
