"""Model registry: name -> spec (family, variant, recipe, the port's builder).

The port's copy of ``deepfakedetection_tpu/registry.py``: ``TrainRecipe``,
``ModelSpec``, the recipes of the ported families and the name rules
(``efficientnet_b3`` exactly, ``efficientformer*`` and ``faster_vit*`` by
prefix).
"""

from __future__ import annotations

import functools
import re
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import torch

@dataclass(frozen=True)
class TrainRecipe:
    """Per-model training regime: a head-only warmup at ``warmup_lr``, then
    the fine-tune at ``finetune_lr`` with cosine decay, label-smoothed CE,
    checkpoints on a val-accuracy gain over ``improvement_threshold``."""

    warmup_lr: float = 3e-4
    warmup_weight_decay: float = 5e-2
    finetune_lr: float = 1e-4
    finetune_weight_decay: float = 5e-2
    warmup_epochs: int = 1
    label_smoothing: float = 0.1
    improvement_threshold: float = 1e-4
    finetune_micro_batch: int | None = None  # None keeps the configured batch
    accum_steps: int = 1
    accum_steps_overridable: bool = True
    head_param_substrings: tuple[str, ...] = ("head",)  # what the warmup trains
    unfreeze: str | tuple[str, ...] = "all"  # what the fine-tune trains
    early_stop_patience: int | None = 4
    color_jitter: tuple[float, float, float, float] = (0.1, 0.1, 0.1, 0.05)
    default_train_toggles: dict[str, bool] = field(default_factory=dict)


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str  # "efficientnet" | "efficientformerv2" | "fastervit"
    variant: str
    weights_key: str
    default_image_size: int
    recipe: TrainRecipe
    # builder(num_classes, *, dtype, generator, **model_kwargs) -> nn.Module
    builder: Callable[..., Any]


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


def _build_fastervit(
    num_classes: int,
    variant: str = "2",
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: torch.Generator | None = None,
    **kw: Any,
):
    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit

    return create_faster_vit(
        variant, num_classes=num_classes, dtype=dtype, generator=generator, **kw
    )


def _build_efficientformer_v2(
    num_classes: int,
    variant: str = "s1",
    *,
    dtype: torch.dtype = torch.bfloat16,
    generator: torch.Generator | None = None,
    **kw: Any,
):
    from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2

    return create_efficientformer_v2(
        variant, num_classes=num_classes, dtype=dtype, generator=generator, **kw
    )


def _efficientformer_variant(name: str) -> str:
    """'efficientformerv2_s1' -> 's1'; V1 names and unknown variants raise."""
    tail = name.rsplit("_", 1)[-1].lower()
    if tail in ("s0", "s1", "s2", "l"):
        return tail
    if tail in ("l1", "l3", "l7"):
        raise KeyError(
            f"'{name}' is an EfficientFormer V1 model; this framework implements V2 "
            "(efficientformerv2_{s0,s1,s2,l})"
        )
    raise KeyError(f"unknown EfficientFormerV2 variant in '{name}' (known: s0, s1, s2, l)")


def _fastervit_variant(name: str) -> str:
    """'faster_vit_2_224' -> '2' (the wheel registers faster_vit_{0..4}_224)."""
    m = re.match(r"faster_vit_(\d)", name)
    if m and m.group(1) in "01234":
        return m.group(1)
    raise KeyError(
        f"unknown FasterViT variant in '{name}' (known: faster_vit_0..4, the wheel's registry)"
    )


_EFFICIENTNET_RECIPE = TrainRecipe(
    finetune_micro_batch=32,
    accum_steps=4,
    head_param_substrings=("classifier", "_fc", "fc"),
    color_jitter=(0.2, 0.2, 0.2, 0.05),
)
# the JAX package's unfreeze set (stages_3, blocks_3, norm_out, head: stage
# 4's blocks, the final norm, both heads and every talking head; 116 of S1's
# 357 tensors) in timm's names; "head" also selects the talking heads for
# the warmup, as in the JAX package
_EFFICIENTFORMER_RECIPE = TrainRecipe(
    head_param_substrings=("head",),
    unfreeze=("stages.3.blocks", "norm.", "head"),
    early_stop_patience=None,
    color_jitter=(0.1, 0.1, 0.1, 0.05),
    default_train_toggles={"train_random_rotation": False, "train_random_erasing": False},
)
_FASTERVIT_RECIPE = TrainRecipe(
    finetune_micro_batch=32,
    accum_steps=4,
    accum_steps_overridable=False,
    head_param_substrings=("head",),
    default_train_toggles={"train_random_rotation": False, "train_random_erasing": False},
)


def get_model_spec(name: str) -> ModelSpec:
    """The spec of ``name`` with the port's builder; KeyError for an unknown
    name."""
    if name == "efficientnet_b3":
        return ModelSpec(name, "efficientnet", "b3", name, 224, _EFFICIENTNET_RECIPE,
                         functools.partial(_build_efficientnet, variant="b3"))
    if name.startswith("efficientformer"):
        variant = _efficientformer_variant(name)
        return ModelSpec(name, "efficientformerv2", variant, name, 224, _EFFICIENTFORMER_RECIPE,
                         functools.partial(_build_efficientformer_v2, variant=variant))
    if name.startswith("faster_vit"):
        variant = _fastervit_variant(name)
        return ModelSpec(name, "fastervit", variant, name, 224, _FASTERVIT_RECIPE,
                         functools.partial(_build_fastervit, variant=variant))
    raise KeyError(
        f"Unknown model '{name}'. Known: efficientnet_b3, efficientformer*, faster_vit*"
    )
