"""Checkpoints of a training run, written with ``torch.save``.

Port of ``deepfakedetection_tpu/runtime/checkpoint.py``'s contract:
``latest.ckpt`` every epoch (epoch counters, model, optimizer, schedule
position, EMA), ``best.ckpt`` and ``<weights_key>.pth`` on improvement, and
auto-resume from ``latest.ckpt``. Each file is written to a temporary name
and renamed over the old one, so a crash mid-write never loses the previous
checkpoint. The ``.pth`` is a plain torch state dict under the
efficientnet_pytorch names, which the eval job loads with ``weights: auto``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch

from deepfakedetection_tpu_torch.runtime.paths import rank


def latest_path(checkpoints_dir: Path) -> Path:
    return Path(checkpoints_dir) / "latest.ckpt"


def best_path(checkpoints_dir: Path) -> Path:
    return Path(checkpoints_dir) / "best.ckpt"


def has_latest(checkpoints_dir: Path) -> bool:
    return latest_path(checkpoints_dir).exists()


def _cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save(path: Path, obj: Any) -> None:
    """``torch.save`` of ``obj`` (tensors moved to the CPU) to ``path``,
    atomically, from process 0 only."""
    if rank() != 0:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    torch.save(_cpu(obj), tmp)
    os.replace(tmp, path)


def load(path: Path) -> Any:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def export_weights(path: Path, model: torch.nn.Module) -> Path:
    """The model's state dict (parameters and BN statistics) as a ``.pth``."""
    save(path, model.state_dict())
    return Path(path)
