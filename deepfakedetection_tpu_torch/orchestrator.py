"""Orchestration: config -> per-model run dirs -> train or eval job, on PyTorch.

Port of ``deepfakedetection_tpu/orchestrator.py``: the same YAML schema
(validated by the port's ``config.py``, a copy of the JAX package's), selection order, fresh
timestamped run dirs with a config snapshot (or the newest one under
``training.resume: continue``), and the same train and eval job fields. Run it
from the repository root as::

    python -m deepfakedetection_tpu_torch.orchestrator --mode training --config CFG
    python -m deepfakedetection_tpu_torch.orchestrator --mode inference --config CFG

The YAML ``device`` picks the CUDA card for any value but ``cpu``; the
top-level ``precision`` is bf16 by default, or float32. In inference mode a
top-level ``ensemble:`` combines the evaluated models afterwards
(``evaluate/ensemble.py``).

More than one process: launch the same command under ``torchrun`` (one
process a card over NCCL, or over gloo with ``device: cpu``)::

    torchrun --nproc-per-node N -m deepfakedetection_tpu_torch.orchestrator \
        --mode training --config CFG

``orchestrate`` joins the process group first (``parallel/multihost.py``),
then checks the ``mesh:`` block before any work: the JAX orchestrator's
``_mesh_dims`` rules, ``data`` -1 or the number of processes, and ``model``
1 (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

import torch

from deepfakedetection_tpu_torch.config import load_config
from deepfakedetection_tpu_torch.data.transforms import resolve_transform_mapping
from deepfakedetection_tpu_torch.evaluate.ensemble import run_ensemble
from deepfakedetection_tpu_torch.evaluate.job import EvalJob, EvalResult, run_eval_job
from deepfakedetection_tpu_torch.parallel.mesh import make_mesh, mesh_dims
from deepfakedetection_tpu_torch.parallel.multihost import maybe_initialize
from deepfakedetection_tpu_torch.registry import get_model_spec
from deepfakedetection_tpu_torch.runtime.flags import compute_dtype, resolve_device
from deepfakedetection_tpu_torch.runtime.logging import console
from deepfakedetection_tpu_torch.runtime.paths import ensure_run_dirs, snapshot_config
from deepfakedetection_tpu_torch.runtime.seeding import apply_seed
from deepfakedetection_tpu_torch.train.loop import (
    TrainJob,
    TrainResult,
    run_training,
    unported_options,
)


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


def _parse_resume(value: Any) -> bool:
    """``training.resume`` in {1, true, "auto", "yes", "continue"} resumes."""
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)):
        return bool(value)
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "auto", "yes", "continue")
    return False


def _parse_unfreeze(value: Any) -> str | tuple[str, ...] | None:
    """``training.unfreeze``: "all", a substring or a list of substrings;
    None defers to the recipe."""
    if value is None:
        return None
    if isinstance(value, str):
        v = value.strip()
        if not v:
            raise SystemExit("training.unfreeze must not be empty")
        return "all" if v.lower() == "all" else (v,)
    subs = tuple(str(s).strip() for s in value)
    if not subs or any(not s for s in subs):
        raise SystemExit(
            "training.unfreeze must be 'all' or a non-empty list of parameter-name substrings"
        )
    return subs


def _resolve_run_paths(model_cfg: dict[str, Any], output_dir: Path, mode: str):
    """A fresh timestamped run dir, or under ``training.resume: continue`` the
    newest existing one that holds ``checkpoints/latest.ckpt``."""
    train_cfg = (model_cfg.get("training") or {}) if mode == "training" else {}
    if str(train_cfg.get("resume") or "").strip().lower() == "continue" and output_dir.exists():
        runs = sorted(
            d for d in output_dir.iterdir()
            if d.is_dir() and (d / "checkpoints" / "latest.ckpt").exists()
        )
        if runs:
            console.print(f"  resume: continue → reusing run dir {runs[-1]}")
            return ensure_run_dirs(output_dir, run_id=runs[-1].name)
    return ensure_run_dirs(output_dir)


def ensemble_settings(config: dict[str, Any]) -> dict[str, Any] | None:
    """The top-level ``ensemble:`` key as a dict (``true`` gives {}), or None
    when it is absent or disabled."""
    raw = config.get("ensemble")
    if raw is True:
        return {}
    if isinstance(raw, dict) and raw.get("enabled", True):
        return raw
    return None


def _opt(cfg: dict[str, Any], key: str, cast):
    return cast(cfg[key]) if cfg.get(key) is not None else None


def build_train_job(
    config: dict[str, Any],
    model_name: str,
    model_cfg: dict[str, Any],
    run_paths,
    device: torch.device,
) -> TrainJob:
    """The JAX package's ``build_train_job`` fallback chains, on the port's job."""
    spec = get_model_spec(model_name)
    data_cfg = config.get("data", {})
    train_cfg = model_cfg.get("training") or {}
    img_size = int(
        train_cfg.get("img_size") or data_cfg.get("img_size") or spec.default_image_size
    )
    class_weights = train_cfg.get("class_weights")
    if isinstance(class_weights, (list, tuple)):
        class_weights = tuple(float(w) for w in class_weights)
    return TrainJob(
        model_name=model_name,
        spec=spec,
        run_paths=run_paths,
        data_root=_resolve_path(data_cfg.get("root", "data")),
        device=device,
        train_split=data_cfg.get("train_split", "train"),
        val_split=data_cfg.get("val_split", "val"),
        num_classes=int(model_cfg.get("num_classes", data_cfg.get("num_classes", 2))),
        img_size=img_size,
        batch_size=int(train_cfg.get("batch_size", 64)),
        epochs=int(train_cfg.get("epochs", 10)),
        num_workers=int(train_cfg.get("num_workers", 4)),
        lr=_opt(train_cfg, "lr", float),
        weight_decay=_opt(train_cfg, "weight_decay", float),
        accum_steps=_opt(train_cfg, "accum_steps", int),
        warmup_epochs=_opt(train_cfg, "warmup_epochs", int),
        early_stop_patience=_opt(train_cfg, "early_stop_patience", int),
        resume_auto=_parse_resume(train_cfg.get("resume")),
        init_weights=_opt(train_cfg, "init_weights", _resolve_path),
        unfreeze=_parse_unfreeze(train_cfg.get("unfreeze")),
        seed=config.get("seed"),
        profile_dir=config.get("profile_dir"),
        remat=bool(train_cfg.get("remat", False)),
        bn_recalc_batches=int(train_cfg.get("bn_recalc_batches", 0) or 0),
        cache_decoded=bool(train_cfg.get("cache_decoded", False)),
        async_checkpoint=bool(train_cfg.get("async_checkpoint", False)),
        ema_decay=_opt(train_cfg, "ema_decay", float),
        grad_clip_norm=_opt(train_cfg, "grad_clip_norm", float),
        mixup_alpha=float(train_cfg.get("mixup_alpha", 0.0) or 0.0),
        cutmix_alpha=float(train_cfg.get("cutmix_alpha", 0.0) or 0.0),
        class_weights=class_weights,
        train_toggles=resolve_transform_mapping(model_cfg, "train"),
        eval_toggles=resolve_transform_mapping(model_cfg, "eval"),
        compute_dtype=compute_dtype(config),
        model_kwargs=_model_kwargs(model_cfg),
        **_mesh_fields(config),
    )


def _mesh_fields(config: dict[str, Any]) -> dict[str, int]:
    data, model = mesh_dims(config)
    return {"mesh_data": data, "mesh_model": model}


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
        # lower-cased here: the validator checks the value lower-cased but
        # keeps it as written ("Percentile" must calibrate by percentile)
        int8_calibration=str(infer_cfg.get("int8_calibration") or "absmax").lower(),
        int8_percentile=float(infer_cfg.get("int8_percentile") or 0.999),
        lookahead=int(infer_cfg.get("lookahead", 2)),
        tta=(str(infer_cfg["tta"]).lower() if infer_cfg.get("tta") else None),
        calibration=(
            str(infer_cfg["calibration"]).lower() if infer_cfg.get("calibration") else None
        ),
        model_kwargs=_model_kwargs(model_cfg),
        **_mesh_fields(config),
    )


def orchestrate(
    config_path: str | Path, mode: str = "inference"
) -> dict[str, EvalResult | TrainResult | None]:
    """Train or evaluate every selected model; returns the results by model
    name. Fails before any work for a model or option the port does not have
    yet. A training run stopped by SIGTERM ends the selection loop."""
    if mode not in ("training", "inference"):
        raise ValueError(f"unknown mode '{mode}'")
    config = load_config(Path(config_path))
    mesh_data, mesh_model = mesh_dims(config)
    maybe_initialize(cpu=str(config.get("device") or "").strip().lower().startswith("cpu"))
    device = resolve_device(config)
    make_mesh(mesh_data, mesh_model, device)  # refuses model > 1 and idle or missing ranks
    models = config.get("models") or {}
    selection = config.get("selection") or list(models.keys())
    for model_name in selection:
        if model_name not in models:
            continue
        get_model_spec(model_name)  # raises for a family not ported yet
        if mode == "training":
            job = build_train_job(config, model_name, dict(models[model_name]), None, device)
            refused = unported_options(job)
            if refused:
                raise NotImplementedError("; ".join(refused))
    apply_seed(config.get("seed"))

    results: dict[str, EvalResult | TrainResult | None] = {}
    for model_name in selection:
        model_cfg = models.get(model_name)
        if model_cfg is None:
            console.print(f"[yellow]⚠ unknown model '{model_name}' — skipping[/]")
            continue
        model_cfg = dict(model_cfg)
        model_cfg["name"] = model_name
        output_dir = model_cfg.get("output_dir") or f"runs/{model_name}"
        run_paths = _resolve_run_paths(model_cfg, _resolve_path(output_dir), mode)
        snapshot_config(config, model_name, run_paths)
        if mode == "inference":
            job = build_eval_job(config, model_name, model_cfg, run_paths, device)
            results[model_name] = run_eval_job(job)
            continue
        result = results[model_name] = run_training(
            build_train_job(config, model_name, model_cfg, run_paths, device)
        )
        if result.interrupted:
            console.print(f"[yellow]⚠ {model_name} preempted — stopping; rerun to resume[/]")
            break
        console.print(
            f"[bold green]✓ {model_name}[/]: best val acc "
            f"{result.best_val_acc:.4f} @ epoch {result.best_epoch + 1}"
        )
    if mode == "inference":
        _run_ensemble(config, results)
    return results


def _run_ensemble(config: dict[str, Any], results: dict[str, Any]) -> None:
    """The top-level ``ensemble:`` over the selection's eval results, in its
    own run dir (``evaluate/ensemble.py``)."""
    settings = ensemble_settings(config)
    if settings is None:
        return
    evaluated = sum(1 for r in results.values() if r is not None)
    if evaluated < 2:
        console.print(f"[yellow]⚠ ensemble skipped: {evaluated} evaluated model(s), need ≥2[/]")
        return
    run_paths = ensure_run_dirs(_resolve_path(settings.get("output_dir") or "runs/ensemble"))
    snapshot_config(config, "ensemble", run_paths)
    run_ensemble(results, run_paths,
                 num_classes=int((config.get("data") or {}).get("num_classes", 2)),
                 weights=settings.get("weights"))


def run_cli(default_mode: str = "inference") -> None:
    parser = argparse.ArgumentParser(description="deepfakedetection_tpu_torch orchestrator")
    parser.add_argument("--config", type=Path, default=None,
                        help="config/train.yaml for training, config/inference.yaml otherwise")
    parser.add_argument("--mode", choices=["training", "inference"], default=default_mode)
    args = parser.parse_args()
    default = "config/train.yaml" if args.mode == "training" else "config/inference.yaml"
    orchestrate(args.config or Path(default), mode=args.mode)


if __name__ == "__main__":
    run_cli()
