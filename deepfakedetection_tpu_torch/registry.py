"""Model registry: the JAX package's specs with the port's builders.

``ModelSpec`` metadata (family, variant, weights key, default image size,
recipe) comes from ``deepfakedetection_tpu/registry.py``; only the builder
differs. Families the port does not have yet raise, naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from deepfakedetection_tpu.registry import ModelSpec
from deepfakedetection_tpu.registry import get_model_spec as _jax_model_spec

# family -> the ROADMAP Queue 1 item that ports it
_NOT_PORTED = {
    "fastervit": "ROADMAP Queue 1 item 5 (FasterViT)",
    "efficientformerv2": "ROADMAP Queue 1 item 6 (EfficientFormerV2-S1)",
}


def _build_efficientnet(
    num_classes: int,
    variant: str = "b3",
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: torch.Generator | None = None,
    **kw: Any,
):
    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet

    return create_efficientnet(
        variant, num_classes=num_classes, dtype=dtype, generator=generator, **kw
    )


_BUILDERS = {"efficientnet": _build_efficientnet}


def get_model_spec(name: str) -> ModelSpec:
    """The spec of ``name`` with the port's builder. KeyError for an unknown
    name (as the JAX registry), NotImplementedError for a family not ported
    yet."""
    spec = _jax_model_spec(name)
    if spec.family not in _BUILDERS:
        raise NotImplementedError(
            f"model '{name}' ({spec.family}) is not ported to PyTorch yet: "
            f"{_NOT_PORTED.get(spec.family, 'see ROADMAP Queue 1')}"
        )
    builder = functools.partial(_BUILDERS[spec.family], variant=spec.variant)
    return dataclasses.replace(spec, builder=builder)
