"""The ``("data", "model")`` mesh over ``torch.distributed`` ranks, and the
data axis's collectives inside a train step.

Port of ``deepfakedetection_tpu/parallel/mesh.py``. There the step is one
program over a device mesh, and GSPMD inserts the all-reduces of a
data-parallel step; here each rank runs the step on its rows of the global
batch and issues them itself, so that a k-rank step computes what one
process computes on the whole global batch (``docs/SCALING.md``):

- ``sum_over_data``: a sum over the data axis with a backward (the sum of
  the incoming gradients), for BatchNorm's batch statistics, whose gradient
  reaches every rank's rows;
- ``all_reduce_`` and ``all_reduce_gradients``: in-place sums over the data
  axis, for the loss normaliser, the logged counts and the phase's gradients
  (one flat buffer);
- ``global_rows``: a rank's random draws (augmentation, dropout,
  drop-path) are its data index's rows of the draw for the global batch;
- ``roll_batch``: the global batch rolled by one (mixup's partner).

Each of them acts whenever a process group is up, a world of one included,
and is the single-process computation without one.

The mesh is ``data`` x ``model`` ranks, rank r at (r // model, r % model), as
the JAX ``make_mesh`` reshapes its devices. As in the JAX trainer and eval
job, a model axis of M shards only the batch, over ``data``: the M ranks of
one data index read the same rows and compute the same step, and the data
axis's collectives run over the ranks of one model index. ``param_specs``
(the JAX ``param_shardings``' rule) and ``parallel/tensor.py``'s
``shard_parameters`` make layers column-parallel over the model axis; like
the JAX package's rule, nothing in the trainer calls them.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The run's mesh: ``data`` x ``model`` ranks (the world), this
    process's rank, its (data, model) indices, its device, and the process
    groups of its two axes: ``data_group`` the ranks of its model index,
    ``model_group`` the ranks of its data index (None where the axis is the
    whole world, or one rank)."""

    data: int
    model: int
    rank: int
    world: int
    device: torch.device
    data_index: int = 0
    model_index: int = 0
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)


# the mesh ``make_mesh`` last made under the current default group, and the
# groups made for each (data, model) shape under it (new_group is collective:
# every rank makes every group, once)
_ACTIVE: Mesh | None = None
_GROUPS: dict = {}


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


def active() -> Mesh | None:
    """The mesh ``make_mesh`` made under the process group that is up now,
    else None."""
    if not dist.is_initialized() or _ACTIVE is None or _GROUPS.get("world") is not \
            dist.group.WORLD:
        return None
    return _ACTIVE


def data_axis() -> tuple[int, int] | None:
    """(data index, data size) when a process group is up (the rank and the
    world without a model axis), else None."""
    if not dist.is_initialized():
        return None
    mesh = active()
    if mesh is None:
        return dist.get_rank(), dist.get_world_size()
    return mesh.data_index, mesh.data


def _data_group():
    """The data axis's process group for a collective (None: the world)."""
    mesh = active()
    return None if mesh is None else mesh.data_group


def _track_world() -> None:
    """Forgets the groups of an earlier default group."""
    if _GROUPS.get("world") is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS["world"] = dist.group.WORLD


def _groups(data: int, model: int) -> tuple[list, list]:
    """Every data group (the ranks of one model index) and every model group
    (the ranks of one data index) of a data x model mesh, made once under
    the current default group."""
    _track_world()
    if (data, model) not in _GROUPS:
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)])
                        for d in range(data)]
        _GROUPS[(data, model)] = (data_groups, model_groups)
    return _GROUPS[(data, model)]


def make_mesh(data: int = -1, model: int = 1, device: torch.device | None = None) -> Mesh:
    """The mesh of this run, data x model ranks: ``data`` -1 means the
    processes over ``model``; data x model must be the number of processes
    (a larger one exceeds them, a smaller one would leave ranks idle). Under
    a process group it becomes the mesh the collectives run over
    (``active``); every rank must make it, in the same order."""
    global _ACTIVE
    mesh_dims({"mesh": {"data": data, "model": model}})
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if data == -1:
        if world % model:
            raise ValueError(
                f"mesh -1x{model}: model={model} does not divide {world} processes; "
                f"{world % model} of them would be left idle"
            )
        data = world // model
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} exceeds {world} processes")
    if data * model < world:
        raise ValueError(
            f"mesh {data}x{model} would leave {world - data * model} of {world} processes "
            f"idle; set mesh.data to -1 or {world // model}"
        )
    dev = torch.device(device) if device is not None else torch.device("cpu")
    mesh = Mesh(data=data, model=model, rank=rank, world=world, device=dev,
                data_index=rank // model, model_index=rank % model)
    if dist.is_initialized():
        _track_world()
        if model > 1:
            data_groups, model_groups = _groups(data, model)
            mesh = replace(mesh, data_group=data_groups[mesh.model_index],
                           model_group=model_groups[mesh.data_index])
        _ACTIVE = mesh
    return mesh


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
        dist.all_reduce(out, group=_data_group())
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _SumOverData.apply(grad)


def sum_over_data(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data axis, differentiable; ``t`` without a group."""
    return t if data_axis() is None else _SumOverData.apply(t)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data axis in place (no gradient); returns it."""
    if data_axis() is not None:
        dist.all_reduce(t, group=_data_group())
    return t


def all_reduce_gradients(grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The phase's gradients summed over the data axis through one flat
    buffer (one collective a step), each back in its tensor's shape; the list
    as it is without a group. A parameter that ``parallel/tensor.py`` sharded
    over the model axis brings its own slice's gradient, which the ranks of
    one model index share."""
    if data_axis() is None or not grads:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=_data_group())
    return [f.view(g.shape) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def global_rows(n: int) -> tuple[int, int] | None:
    """(rows of the global batch, this rank's first row) for a local batch
    of ``n`` rows, every data index's equal (the loader's lockstep); None
    without a group. A random draw made for the global rows and sliced here
    equals the single-process draw on the whole batch."""
    axis = data_axis()
    if axis is None:
        return None
    rank, world = axis
    return n * world, n * rank


def roll_batch(t: torch.Tensor) -> torch.Tensor:
    """``torch.roll(t, 1, 0)`` of the global batch, this rank's rows: row 0
    takes the previous data index's last row (index 0 the last one's), by an
    all-gather of every data index's last row."""
    out = torch.roll(t, 1, 0)
    axis = data_axis()
    if axis is None:
        return out
    rank, world = axis
    last = t[-1:].contiguous()
    rows = [torch.empty_like(last) for _ in range(world)]
    dist.all_gather(rows, last, group=_data_group())
    out[0] = rows[(rank - 1) % world][0]
    return out
