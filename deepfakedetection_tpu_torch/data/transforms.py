"""Transform plans: the config's toggle vocabulary as frozen dataclasses.

The port's copy of ``deepfakedetection_tpu/data/transforms.py``. The host
decode reads a plan's geometry (the square it decodes to); the device
normalisation and augmentation (``data/augment.py``) read the rest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resolve_transform_mapping(model_cfg: dict[str, Any], phase: str) -> dict[str, Any]:
    """The toggles of ``phase`` ("train" or "eval"), looked up in order:
    ``model.transforms.{train|eval}``, a flat ``model.transforms`` whose
    values are all scalars, ``model.{training|inference}.transforms``."""
    if phase not in ("train", "eval"):
        raise ValueError(f"phase must be 'train' or 'eval', got {phase!r}")
    transforms = model_cfg.get("transforms")
    if isinstance(transforms, dict):
        phased = transforms.get(phase)
        if isinstance(phased, dict):
            return dict(phased)
        if transforms and all(not isinstance(v, dict) for v in transforms.values()):
            return dict(transforms)
    section = model_cfg.get("training" if phase == "train" else "inference")
    if isinstance(section, dict):
        nested = section.get("transforms")
        if isinstance(nested, dict):
            return dict(nested)
    return {}


@dataclass(frozen=True)
class EvalTransformPlan:
    """ensure_rgb -> Resize(shorter side -> ``resize_size``) ->
    CenterCrop(``img_size``) -> normalize. ``resize_size`` is ``img_size``
    on the eval job's path and max(img + 32, 1.15 img) on the trainers' val
    path."""

    img_size: int
    resize_size: int = 0  # 0 -> img_size
    ensure_rgb: bool = True
    resize: bool = True
    center_crop: bool = True
    normalize: bool = True
    mean: tuple[float, float, float] = IMAGENET_MEAN
    std: tuple[float, float, float] = IMAGENET_STD


def build_eval_plan(
    img_size: int, toggles: dict[str, Any] | None = None, *, trainer_val: bool = False
) -> EvalTransformPlan:
    """``trainer_val=True`` takes the trainers' val geometry (over-resize,
    then crop); the default resizes the shorter side to ``img_size``."""
    t = toggles or {}
    img_size = int(img_size)
    if trainer_val and img_size > 64:
        resize_size = max(img_size + 32, int(img_size * 1.15))
    else:
        resize_size = img_size
    return EvalTransformPlan(
        img_size=img_size,
        resize_size=resize_size,
        ensure_rgb=bool(t.get("ensure_rgb", True)),
        resize=bool(t.get("val_resize", True)),
        center_crop=bool(t.get("val_center_crop", True)),
        normalize=True,  # val_to_tensor / val_normalize are always on
    )


@dataclass(frozen=True)
class TrainTransformPlan:
    """The training augmentation. Small images (``img_size <= 64``): the host
    resizes to img + 4 and the device crops at random; larger ones: the host
    decodes a square canvas of ``host_canvas_size`` = max(img + 32, 1.15 img)
    and the device takes a RandomResizedCrop (scale 0.9-1.0) from it.
    Rotation, flip, jitter and erasing run on the device."""

    img_size: int
    small_images: bool
    host_canvas_size: int
    ensure_rgb: bool = True
    random_crop: bool = True
    center_crop: bool = False
    random_resized_crop: bool = True
    resize: bool = True
    horizontal_flip: bool = True
    rotation: bool = False
    rotation_degrees: float = 10.0
    color_jitter: bool = False
    jitter: tuple[float, float, float, float] = (0.1, 0.1, 0.1, 0.05)
    random_erasing: bool = False
    erasing_p: float = 0.5
    erasing_scale: tuple[float, float] = (0.02, 0.33)
    erasing_ratio: tuple[float, float] = (0.3, 3.3)
    normalize: bool = True
    mean: tuple[float, float, float] = IMAGENET_MEAN
    std: tuple[float, float, float] = IMAGENET_STD
    rrc_scale: tuple[float, float] = (0.9, 1.0)
    rrc_ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)


def build_train_plan(
    img_size: int,
    toggles: dict[str, Any] | None = None,
    *,
    recipe_defaults: dict[str, Any] | None = None,
    jitter_params: tuple[float, float, float, float] | None = None,
) -> TrainTransformPlan:
    """User toggles over the recipe's defaults over the base defaults."""
    img_size = int(img_size)
    small = img_size <= 64
    base: dict[str, Any] = {
        "ensure_rgb": True,
        "train_resize": True,
        "train_random_crop": small,
        "train_center_crop": False,
        "train_random_resized_crop": not small,
        "train_random_horizontal_flip": True,
        "train_random_rotation": not small,
        "train_color_jitter": not small,
        "train_random_erasing": not small,
        "train_rotation_degrees": 10.0,
    }
    merged = {**base, **(recipe_defaults or {}), **(toggles or {})}
    canvas = img_size + 4 if small else max(img_size + 32, int(img_size * 1.15))
    return TrainTransformPlan(
        img_size=img_size,
        small_images=small,
        host_canvas_size=canvas,
        ensure_rgb=bool(merged["ensure_rgb"]),
        resize=bool(merged["train_resize"]),
        random_crop=bool(merged["train_random_crop"]),
        center_crop=bool(merged["train_center_crop"]),
        random_resized_crop=bool(merged["train_random_resized_crop"]),
        horizontal_flip=bool(merged["train_random_horizontal_flip"]),
        rotation=bool(merged["train_random_rotation"]),
        rotation_degrees=float(merged["train_rotation_degrees"]),
        color_jitter=bool(merged["train_color_jitter"]),
        jitter=tuple(jitter_params) if jitter_params else (0.1, 0.1, 0.1, 0.05),
        random_erasing=bool(merged["train_random_erasing"]),
        normalize=True,  # train_to_tensor / train_normalize are always on
    )
