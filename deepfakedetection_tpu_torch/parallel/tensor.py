"""Column parallelism over the mesh's model axis.

Port of the JAX package's tensor-parallel rule (``parallel/mesh.py``
``_param_spec``/``param_shardings``) and of what GSPMD runs for it. There a
parameter sharding is an annotation and the compiler inserts the
collectives; here ``shard_parameters`` makes each layer that ``param_specs``
shards column-parallel over the mesh's model group, with one
``autograd.Function`` a collective:

- the rank keeps its slice of the layer's output features (weight rows, and
  the bias's);
- ``_CopyToModel`` hands the layer its whole input and, in the backward,
  sums the input's gradient over the model group (each rank's slice of the
  weight reaches the input through its own features only);
- a dense layer or convolution computes its slice from the whole input, a
  depthwise convolution from its own channels of the input;
- ``_GatherFromModel`` all-gathers the output over the model group, in rank
  order, and in the backward takes the rank's slice of the gradient (every
  rank of the group computes the same thing past the layer).

So the model group computes the unsharded layer's output on every rank, and
the sliced weight's gradient is the rank's slice of the unsharded one; the
data axis sums it as any other (``mesh.all_reduce_gradients``). Like the JAX
rule, the trainer does not call this: ``tests/test_torch_model_axis.py``
runs a step with it against the JAX tensor-parallel step.

It acts on ``nn.Linear`` and ``nn.Conv2d`` layers that run their own
``forward`` (through hooks on it); a layer whose weight is read by other code
(the models' folded ``ConvBN``) is not made parallel by it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from deepfakedetection_tpu_torch.parallel.mesh import Mesh

# parameters the JAX models hold as plain tables, not ``kernel`` leaves, that
# the port keeps in a layer (EfficientFormerV2's talking heads, 1x1 convs in
# the port and timm, ``talking_head1``/``2`` params in flax): replicated
_TABLES = ("talking_head1.weight", "talking_head2.weight")


def param_specs(module: nn.Module, model: int) -> dict[str, int | None]:
    """Each parameter's dim sharded over a model axis of ``model`` ranks, or
    None (replicated): the JAX rule, a ``kernel`` of rank >= 2 whose output
    features divide by ``model``, which in the port's layouts is dim 0 of a
    ``Linear`` or ``Conv2d`` weight (depthwise included). Norms, biases and
    tables are replicated, and everything is at ``model`` 1."""
    specs: dict[str, int | None] = {name: None for name, _ in module.named_parameters()}
    if model <= 1:
        return specs
    for prefix, layer in module.named_modules():
        if not isinstance(layer, (nn.Linear, nn.Conv2d)):
            continue
        name = f"{prefix}.weight" if prefix else "weight"
        w = layer.weight
        if name.endswith(_TABLES) or w.dim() < 2 or w.shape[0] % model:
            continue
        specs[name] = 0
    return specs


class _CopyToModel(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's slices along ``dim`` concatenated in rank order;
    the backward takes this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, index: int, size: int, group) -> torch.Tensor:
        ctx.dim, ctx.index, ctx.width = dim, index, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        part = grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous()
        return part, None, None, None, None


def _slice(layer: nn.Module, name: str, lo: int, hi: int) -> None:
    p = getattr(layer, name)
    if p is not None:
        setattr(layer, name, nn.Parameter(p.detach()[lo:hi].clone(), requires_grad=p.requires_grad))


def shard_parameters(module: nn.Module, mesh: Mesh) -> list[str]:
    """Makes every layer ``param_specs`` shards over ``mesh.model`` ranks
    column-parallel over ``mesh.model_group`` (in place: its weight and bias
    become this rank's slice of the output features); returns their
    parameter names. A model axis of 1 changes nothing."""
    if mesh.model <= 1:
        return []
    specs = param_specs(module, mesh.model)
    done = []
    for prefix, layer in list(module.named_modules()):
        name = f"{prefix}.weight" if prefix else "weight"
        if specs.get(name) != 0:
            continue
        out = layer.weight.shape[0]
        width = out // mesh.model
        lo, hi = mesh.model_index * width, (mesh.model_index + 1) * width
        depthwise = isinstance(layer, nn.Conv2d) and layer.groups > 1
        if depthwise and not (layer.groups == layer.in_channels == out):
            raise ValueError(f"{name}: a grouped convolution ({layer.groups} groups) is neither "
                             "dense nor depthwise")
        _slice(layer, "weight", lo, hi)
        _slice(layer, "bias", lo, hi)
        if isinstance(layer, nn.Linear):
            layer.out_features = width
        else:
            layer.out_channels = width
            if depthwise:
                layer.in_channels = layer.groups = width
        group, index, size = mesh.model_group, mesh.model_index, mesh.model
        dim = -1 if isinstance(layer, nn.Linear) else 1

        def before(_layer, args, lo=lo, hi=hi, depthwise=depthwise, group=group):
            x = _CopyToModel.apply(args[0], group)
            return (x[:, lo:hi] if depthwise else x, *args[1:])

        def after(_layer, _args, y, dim=dim, index=index, size=size, group=group):
            return _GatherFromModel.apply(y, dim, index, size, group)

        layer.register_forward_pre_hook(before)
        layer.register_forward_hook(after)
        done.append(name)
    return done
