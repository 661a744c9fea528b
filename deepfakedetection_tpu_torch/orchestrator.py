"""Orchestration: config -> per-model run dirs -> eval job, on PyTorch.

Port of the inference half of ``deepfakedetection_tpu/orchestrator.py``: the
same YAML schema (validated by the JAX package's ``config.py``), selection
order, fresh timestamped run dirs with a config snapshot, and the same eval
job fields. Run it from the repository root as::

    python -m deepfakedetection_tpu_torch.orchestrator --mode inference --config CFG

The YAML ``device`` picks the CUDA card for any value but ``cpu``; the
top-level ``precision`` is bf16 by default, or float32.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

import torch

from deepfakedetection_tpu.config import load_config
from deepfakedetection_tpu.data.transforms import resolve_transform_mapping
from deepfakedetection_tpu.runtime.seeding import apply_seed
from deepfakedetection_tpu_torch.evaluate.job import EvalJob, EvalResult, run_eval_job
from deepfakedetection_tpu_torch.registry import get_model_spec
from deepfakedetection_tpu_torch.runtime.flags import compute_dtype, resolve_device
from deepfakedetection_tpu_torch.runtime.logging import console
from deepfakedetection_tpu_torch.runtime.paths import ensure_run_dirs, snapshot_config


def _resolve_path(value: str | Path) -> Path:
    p = Path(value).expanduser()
    return p if p.is_absolute() else (Path.cwd() / p).resolve()


def _latest_weights_export(output_dir: Path) -> Path | None:
    """Newest run dir's exported weights: ``<output_dir>/<ts>/checkpoints/*.pth``."""
    if not output_dir.exists():
        return None
    for run in sorted((d for d in output_dir.iterdir() if d.is_dir()), reverse=True):
        pths = sorted((run / "checkpoints").glob("*.pth"))
        if pths:
            return pths[-1]
    return None


def _model_kwargs(model_cfg: dict[str, Any]) -> dict[str, Any]:
    kw = dict(model_cfg.get("model_kwargs") or {})
    if model_cfg.get("head_config"):
        kw["head_config"] = model_cfg["head_config"]
    return kw


def build_eval_job(
    config: dict[str, Any],
    model_name: str,
    model_cfg: dict[str, Any],
    run_paths,
    device: torch.device,
) -> EvalJob:
    """The JAX package's ``build_eval_job`` fallback chains, on the port's job."""
    spec = get_model_spec(model_name)
    data_cfg = config.get("data", {})
    infer_cfg = model_cfg.get("inference") or {}
    train_cfg = model_cfg.get("training") or {}
    img_size = int(
        infer_cfg.get("img_size")
        or train_cfg.get("img_size")
        or data_cfg.get("img_size")
        or spec.default_image_size
    )
    weights = infer_cfg.get("weights")
    if isinstance(weights, str) and weights.strip().lower() == "auto":
        out_dir = model_cfg.get("output_dir") or f"runs/{model_name}"
        weights = _latest_weights_export(_resolve_path(out_dir))
        if weights is None:
            raise SystemExit(
                f"inference.weights: auto — no exported .pth found under "
                f"{out_dir}/*/checkpoints/; point weights at a file"
            )
        console.print(f"  weights: auto → {weights}")
    batch_size = infer_cfg.get("batch_size")
    if batch_size is None:
        batch_size = train_cfg.get("batch_size")
    if batch_size is None:
        batch_size = 64
    num_workers = infer_cfg.get("num_workers")
    if num_workers is None:
        num_workers = train_cfg.get("num_workers")
    if num_workers is None:
        num_workers = data_cfg.get("num_workers", 0)
    return EvalJob(
        model_name=model_name,
        spec=spec,
        run_paths=run_paths,
        data_root=_resolve_path(data_cfg.get("root", "data")),
        device=device,
        split=infer_cfg.get("split") or data_cfg.get("test_split", "test"),
        val_split=data_cfg.get("val_split", "val"),
        num_classes=int(model_cfg.get("num_classes", data_cfg.get("num_classes", 2))),
        img_size=img_size,
        batch_size=int(batch_size),
        num_workers=int(num_workers),
        weights=_resolve_path(weights) if weights else None,
        eval_toggles=resolve_transform_mapping(model_cfg, "eval"),
        compute_dtype=compute_dtype(config),
        precision=str(infer_cfg.get("precision") or "bf16"),
        lookahead=int(infer_cfg.get("lookahead", 2)),
        tta=(str(infer_cfg["tta"]).lower() if infer_cfg.get("tta") else None),
        calibration=(
            str(infer_cfg["calibration"]).lower() if infer_cfg.get("calibration") else None
        ),
        model_kwargs=_model_kwargs(model_cfg),
    )


def orchestrate(
    config_path: str | Path, mode: str = "inference"
) -> dict[str, EvalResult | None]:
    """Evaluate every selected model; returns the results by model name.
    Fails before any work for a model or option the port does not have yet."""
    if mode == "training":
        raise NotImplementedError("training on PyTorch is ROADMAP Queue 1 item 4")
    if mode != "inference":
        raise ValueError(f"unknown mode '{mode}'")
    config = load_config(Path(config_path))
    device = resolve_device(config)
    models = config.get("models") or {}
    selection = config.get("selection") or list(models.keys())
    for model_name in selection:
        if model_name in models:
            get_model_spec(model_name)  # raises for a family not ported yet
    ensemble = config.get("ensemble")
    if ensemble is True or (isinstance(ensemble, dict) and ensemble.get("enabled", True)):
        raise NotImplementedError("ensembles on PyTorch are ROADMAP Queue 1 item 10")
    apply_seed(config.get("seed"))

    results: dict[str, EvalResult | None] = {}
    for model_name in selection:
        model_cfg = models.get(model_name)
        if model_cfg is None:
            console.print(f"[yellow]⚠ unknown model '{model_name}' — skipping[/]")
            continue
        model_cfg = dict(model_cfg)
        model_cfg["name"] = model_name
        output_dir = model_cfg.get("output_dir") or f"runs/{model_name}"
        run_paths = ensure_run_dirs(_resolve_path(output_dir))
        snapshot_config(config, model_name, run_paths)
        job = build_eval_job(config, model_name, model_cfg, run_paths, device)
        results[model_name] = run_eval_job(job)
    return results


def run_cli(default_mode: str = "inference") -> None:
    parser = argparse.ArgumentParser(description="deepfakedetection_tpu_torch orchestrator")
    parser.add_argument("--config", type=Path, default=Path("config/inference.yaml"))
    parser.add_argument("--mode", choices=["training", "inference"], default=default_mode)
    args = parser.parse_args()
    orchestrate(args.config, mode=args.mode)


if __name__ == "__main__":
    run_cli()
