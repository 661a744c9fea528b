"""Run-directory layout and config snapshots, with torch.distributed ranks.

The layout of ``deepfakedetection_tpu/runtime/paths.py``:
``runs/<model>/<YYYYmmdd-HHMMSS>/{checkpoints,logs,plots}`` and a
``config_snapshot.yaml`` per run. Process 0's run id and writes win when
``torch.distributed`` is initialised.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any

import yaml

__all__ = ["RunPaths", "ensure_run_dirs", "snapshot_config", "rank", "world_size"]


@dataclass(frozen=True)
class RunPaths:
    root: Path
    checkpoints: Path
    logs: Path
    plots: Path


def timestamp_now() -> str:
    return datetime.now().strftime("%Y%m%d-%H%M%S")


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def sync_run_id(run_id: str) -> str:
    """Every process adopts process 0's run id (no-op single-process), over
    the host group (``parallel/multihost.py``)."""
    from deepfakedetection_tpu_torch.parallel.multihost import broadcast_object

    return broadcast_object(run_id)


def ensure_run_dirs(base_output_dir: str | Path, *, run_id: str | None = None) -> RunPaths:
    """Create a fresh timestamped run dir with the standard subdirs."""
    root = Path(base_output_dir) / (run_id or sync_run_id(timestamp_now()))
    paths = RunPaths(
        root=root, checkpoints=root / "checkpoints", logs=root / "logs", plots=root / "plots"
    )
    for p in (paths.root, paths.checkpoints, paths.logs, paths.plots):
        p.mkdir(parents=True, exist_ok=True)
    return paths


def snapshot_config(config: dict[str, Any], model_name: str, run_paths: RunPaths) -> Path:
    """Write config_snapshot.yaml (globals minus models/selection + this
    model's block), from process 0 only."""
    out = run_paths.root / "config_snapshot.yaml"
    if rank() != 0:
        return out
    snapshot = {k: copy.deepcopy(v) for k, v in config.items() if k not in ("models", "selection")}
    model_block = copy.deepcopy((config.get("models") or {}).get(model_name) or {})
    snapshot["model"] = {"name": model_name, **model_block}
    with out.open("w", encoding="utf-8") as fh:
        yaml.safe_dump(snapshot, fh, sort_keys=False)
    return out
