"""YAML configuration: the loader and its pydantic schema.

The port's copy of ``deepfakedetection_tpu/config.py``: the same keys,
defaults and validation rules (a non-empty ``models:``, ``selection``
defaulting to every model and rejecting unknown names, the allowed values
of ``precision``, ``inference.*`` and ``training.*``), so one YAML file
validates the same way for both packages. Unknown keys are kept, except
under ``data`` where they are dropped.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import yaml
from pydantic import BaseModel, ConfigDict, field_validator, model_validator


def _one_of(name: str, value: str | None, allowed: tuple[str, ...]) -> str | None:
    if value is not None and str(value).lower() not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")
    return value


class DataConfig(BaseModel):
    model_config = ConfigDict(extra="ignore")

    root: str
    train_split: str = "train"
    val_split: str = "val"
    test_split: str = "test"
    num_classes: int = 2
    img_size: int = 224
    class_labels: dict[str, str] | None = None


class InferenceConfig(BaseModel):
    model_config = ConfigDict(extra="allow")

    weights: str | None = None
    split: str | None = None
    batch_size: int = 64
    num_workers: int = 4
    img_size: int | None = None
    transforms: dict[str, Any] | None = None
    precision: str | None = None  # "bf16" or "int8"
    int8_calibration: str | None = None
    int8_percentile: float | None = None
    tta: str | None = None  # None or "hflip"
    calibration: str | None = None  # None or "temperature"
    threshold: float | str | None = None  # serving: a float in [0, 1] or "auto"

    @field_validator("threshold")
    @classmethod
    def _threshold_valid(cls, value):
        if value is None:
            return value
        if isinstance(value, str):
            if value.lower() != "auto":
                raise ValueError(
                    f"inference.threshold must be a float in [0,1] or 'auto', got {value!r}"
                )
            return value.lower()
        if not 0.0 <= float(value) <= 1.0:
            raise ValueError(f"inference.threshold must be in [0,1], got {value}")
        return float(value)

    @field_validator("precision")
    @classmethod
    def _precision(cls, value):
        return _one_of("inference.precision", value, ("bfloat16", "bf16", "int8", "i8"))

    @field_validator("int8_calibration")
    @classmethod
    def _int8_calibration(cls, value):
        return _one_of("inference.int8_calibration", value,
                       ("absmax", "percentile", "per-channel"))

    @field_validator("int8_percentile")
    @classmethod
    def _int8_percentile(cls, value: float | None) -> float | None:
        if value is not None and not 0.5 <= float(value) <= 1.0:
            raise ValueError(f"inference.int8_percentile must be in [0.5, 1], got {value}")
        return value

    @field_validator("tta")
    @classmethod
    def _tta(cls, value):
        return _one_of("inference.tta", value, ("hflip",))

    @field_validator("calibration")
    @classmethod
    def _calibration(cls, value):
        return _one_of("inference.calibration", value, ("temperature",))


class TrainingConfig(BaseModel):
    model_config = ConfigDict(extra="allow")

    batch_size: int = 64
    epochs: int = 10
    num_workers: int = 4
    img_size: int | None = None
    transforms: dict[str, Any] | None = None
    resume: str | bool | None = None
    init_weights: str | None = None
    unfreeze: str | list[str] | None = None
    ema_decay: float | None = None
    grad_clip_norm: float | None = None
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    class_weights: str | list[float] | None = None  # "auto" or per-class floats

    @field_validator("class_weights")
    @classmethod
    def _class_weights_valid(cls, value):
        if value is None:
            return value
        if isinstance(value, str):
            if value.lower() != "auto":
                raise ValueError(
                    f"class_weights must be 'auto' or a list of positive floats, got {value!r}"
                )
            return value.lower()
        weights = [float(v) for v in value]
        if not weights or any(not w > 0.0 for w in weights):
            raise ValueError(f"class_weights must all be > 0, got {value!r}")
        return weights

    @field_validator("mixup_alpha", "cutmix_alpha")
    @classmethod
    def _mix_alpha_non_negative(cls, value: float) -> float:
        if value < 0.0:
            raise ValueError(f"mixup/cutmix alpha must be >= 0, got {value}")
        return value

    @field_validator("ema_decay")
    @classmethod
    def _ema_decay_in_unit_interval(cls, value: float | None) -> float | None:
        if value is not None and not (0.0 < value < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {value}")
        return value

    @field_validator("grad_clip_norm")
    @classmethod
    def _grad_clip_norm_positive(cls, value: float | None) -> float | None:
        if value is not None and not value > 0.0:
            raise ValueError(f"grad_clip_norm must be > 0, got {value}")
        return value


class ModelConfig(BaseModel):
    model_config = ConfigDict(extra="allow")

    output_dir: str | None = None
    transforms: dict[str, Any] | None = None
    training: TrainingConfig | None = None
    inference: InferenceConfig | None = None
    display_name: str | None = None
    label: str | None = None


class MeshConfig(BaseModel):
    model_config = ConfigDict(extra="allow")

    data: int = -1
    model: int = 1


class EnsembleConfig(BaseModel):
    model_config = ConfigDict(extra="allow")

    enabled: bool = True
    weights: dict[str, float] | None = None
    output_dir: str | None = None

    @field_validator("weights")
    @classmethod
    def _weights_positive(cls, value: dict[str, float] | None):
        if value is not None:
            bad = {k: v for k, v in value.items() if not float(v) > 0.0}
            if bad:
                raise ValueError(f"ensemble.weights must be > 0, got {bad}")
        return value


class OrchestratorConfig(BaseModel):
    model_config = ConfigDict(extra="allow")

    seed: int | None = None
    device: str | None = None
    data: DataConfig
    models: dict[str, ModelConfig]
    selection: list[str] | None = None
    mesh: MeshConfig | None = None
    precision: str = "bfloat16"
    profile_dir: str | None = None
    ensemble: EnsembleConfig | bool | None = None

    @field_validator("models")
    @classmethod
    def _models_must_be_non_empty(cls, value: dict[str, ModelConfig]) -> dict[str, ModelConfig]:
        if not value:
            raise ValueError("config.models cannot be empty")
        return value

    @field_validator("precision")
    @classmethod
    def _precision_supported(cls, value: str) -> str:
        return _one_of("precision", value, ("bfloat16", "bf16", "float32", "fp32"))

    @model_validator(mode="after")
    def _resolve_selection(self) -> OrchestratorConfig:
        if self.selection is None:
            self.selection = list(self.models.keys())
        else:
            unknown = [m for m in self.selection if m not in self.models]
            if unknown:
                raise ValueError(f"selection references unknown models: {', '.join(unknown)}")
        if isinstance(self.ensemble, EnsembleConfig) and self.ensemble.weights:
            unknown = [m for m in self.ensemble.weights if m not in self.models]
            if unknown:
                raise ValueError(
                    f"ensemble.weights references unknown models: {', '.join(unknown)}"
                )
        return self


def load_config(path: str | Path) -> dict[str, Any]:
    """``yaml.safe_load``, pydantic validation, then back to a plain dict."""
    with Path(path).open("r", encoding="utf-8") as fh:
        raw = yaml.safe_load(fh) or {}
    return OrchestratorConfig(**raw).model_dump(exclude_none=False)
