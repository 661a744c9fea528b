"""The batch-eval job: threshold sweep on val -> test pass -> metrics, plots, logs.

Port of ``deepfakedetection_tpu/evaluate/job.py``: padded static batches with
a validity mask, f32 softmax probabilities (with optional hflip TTA), the
501-point threshold sweep on val, optional temperature calibration, the
binary decision ``p1 >= t``, accuracy / ROC-AUC / confusion matrix, plots,
``metrics.jsonl`` with the same fields, the ``inference.log`` tee and the
one-line JSON summary. With ``precision: int8`` the job first calibrates
per-ConvBN activation scales on up to 2 val batches (the test split when val
is missing or empty), then runs the sweep and the test pass under them
(``ops/quant.py``). Under a process group each rank evaluates its shard of
a split and the rows are gathered in the split's order, so the sweep and
the metrics see the whole split on every rank; rank 0 writes the files.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np
import torch

from deepfakedetection_tpu_torch.data.augment import normalize_batch
from deepfakedetection_tpu_torch.data.folder import require_num_classes, scan_image_folder
from deepfakedetection_tpu_torch.data.pipeline import DeviceStager, make_eval_loader
from deepfakedetection_tpu_torch.data.transforms import build_eval_plan
from deepfakedetection_tpu_torch.evaluate.metrics import (
    apply_temperature,
    confusion,
    expected_calibration_error,
    fit_temperature,
    roc_auc,
    sweep_threshold,
)
from deepfakedetection_tpu_torch.evaluate.plots import save_confusion_matrix, save_roc_curve
from deepfakedetection_tpu_torch.ops import quant
from deepfakedetection_tpu_torch.parallel.mesh import make_mesh
from deepfakedetection_tpu_torch.parallel.multihost import allgather_examples, local_rows
from deepfakedetection_tpu_torch.registry import ModelSpec
from deepfakedetection_tpu_torch.runtime.convert import fastervit_head_config, load_weights
from deepfakedetection_tpu_torch.runtime.logging import (
    append_metrics,
    console,
    process_log_path,
    progress,
    tee_output,
)
from deepfakedetection_tpu_torch.runtime.paths import RunPaths


@dataclass
class EvalJob:
    model_name: str
    spec: ModelSpec
    run_paths: RunPaths
    data_root: Path
    device: torch.device
    split: str = "test"
    val_split: str = "val"
    num_classes: int = 2
    img_size: int = 224
    batch_size: int = 64
    num_workers: int = 4
    weights: Path | None = None
    eval_toggles: dict[str, Any] = field(default_factory=dict)
    compute_dtype: torch.dtype = torch.bfloat16
    # inference.precision: "bf16" or "int8" (the ConvBN convs quantized with
    # scales calibrated before the sweep, ops/quant.py)
    precision: str = "bf16"
    # int8 activation-range statistic: "absmax" | "percentile" (at
    # int8_percentile of |x|) | "per-channel"
    int8_calibration: str = "absmax"
    int8_percentile: float = 0.999
    lookahead: int = 2
    # test-time augmentation: None or "hflip" (probs averaged over the flip)
    tta: str | None = None
    # None or "temperature" (fit T on the val pass)
    calibration: str | None = None
    model_kwargs: dict[str, Any] = field(default_factory=dict)
    # the YAML mesh: block (parallel/mesh.py): data -1 or the process count
    mesh_data: int = -1
    mesh_model: int = 1


@dataclass
class EvalResult:
    metrics: dict[str, Any]
    probs: np.ndarray
    targets: np.ndarray
    preds: np.ndarray
    classes: list[str] = field(default_factory=list)
    val_probs: np.ndarray | None = None
    val_targets: np.ndarray | None = None
    # test pass images per second, host clock, device synchronised at the end
    images_per_s: float = 0.0
    # the int8 run's activation scales by ConvBN name (None for bf16)
    int8_scales: dict[str, Any] | None = None


_F32_NOTE = {
    "efficientnet": "stride-1 MBConv blocks run the unfused f32 ConvBN chain (K1 and K2 "
                    "take bf16)",
    "fastervit": "window attention runs in plain f32 PyTorch ops (K5 takes bf16)",
    "efficientformerv2": "Attention4D runs in plain f32 PyTorch ops (K7 takes bf16)",
}


def pick_head_config(family: str, model_kwargs: dict[str, Any],
                     state: dict[str, torch.Tensor] | None) -> dict[str, Any]:
    """``model_kwargs`` with a FasterViT's ``head_config`` taken from the
    weights it will load (``fastervit_head_config``) unless the config pins
    one; other families and runs without weights unchanged."""
    if family != "fastervit" or "head_config" in model_kwargs or state is None:
        return model_kwargs
    config = fastervit_head_config(state)
    console.print(f"  torch checkpoint's tensors → faster_vit head_config='{config}'")
    return {**model_kwargs, "head_config": config}


def builder_kwargs(family: str, model_kwargs: dict[str, Any],
                   state: dict[str, torch.Tensor] | None, img_size: int) -> dict[str, Any]:
    """The builder's keyword arguments: ``pick_head_config``'s, and for an
    EfficientFormerV2 the ``img_size`` its attention bias tables are sized
    for."""
    kwargs = pick_head_config(family, dict(model_kwargs), state)
    if family == "efficientformerv2":
        kwargs["img_size"] = img_size
    return kwargs


def load_model_for_eval(job: EvalJob) -> torch.nn.Module:
    """Build the model (init from a generator seeded 0), load the weights
    when the file exists (a torch ``.pth`` or a native flax msgpack export;
    a warning and the init weights when it does not),
    move it to the job's device and switch it to eval. A FasterViT is built
    in the head configuration its weights were made in (``pick_head_config``)
    unless the config pins one; an EfficientFormerV2 at the job's
    ``img_size`` (its attention bias tables' sizes depend on it)."""
    wpath = Path(job.weights) if job.weights is not None else None
    state = (load_weights(wpath, job.spec.family) if wpath is not None and wpath.exists()
             else None)
    model = job.spec.builder(
        job.num_classes,
        dtype=job.compute_dtype,
        generator=torch.Generator().manual_seed(0),
        **builder_kwargs(job.spec.family, job.model_kwargs, state, job.img_size),
    )
    if job.compute_dtype == torch.float32 and job.spec.family in _F32_NOTE:
        console.print(f"  precision float32: {_F32_NOTE[job.spec.family]}")
    if wpath is not None:
        if state is not None:
            missing, unexpected = model.load_state_dict(state, strict=False)
            counters = [k for k in model.state_dict() if k.endswith("num_batches_tracked")]
            missing = [k for k in missing if k not in counters]
            if len(missing) == len(model.state_dict()) - len(counters):
                raise ValueError(
                    f"{wpath}: no tensor matches {job.model_name} — refusing to "
                    "evaluate randomly-initialized weights"
                )
            if missing or unexpected:
                console.print(
                    f"[yellow]⚠ {len(missing) + len(unexpected)} checkpoint tensors not "
                    f"loaded (strict=False): {(missing + list(unexpected))[:5]}…[/]"
                )
        else:
            console.print(f"[yellow]⚠ weights not found at {wpath}; using init weights[/]")
    return model.to(job.device).eval()


def make_eval_step(model: torch.nn.Module, tta: str | None = None):
    """f32 softmax probabilities of a normalized NCHW batch; ``tta="hflip"``
    averages them over the width flip."""

    @torch.no_grad()
    def eval_step(x: torch.Tensor) -> torch.Tensor:
        p = torch.softmax(model(x).float(), dim=-1)
        if tta == "hflip":
            p = 0.5 * (p + torch.softmax(model(x.flip(3)).float(), dim=-1))
        return p

    return eval_step


def collect_probs(
    eval_step, loader, plan, stager: DeviceStager, compute_dtype, desc: str = "inference"
):
    """Run every batch; returns (probs, targets, images/s) for the valid rows.
    Probabilities stay on the device until the pass ends. Under a process
    group every rank returns the whole split's rows, its own gathered with
    the others' in rank order (``allgather_examples``), which is the
    split's order; images/s counts this rank's rows."""
    device_probs: list[torch.Tensor] = []
    masks: list[np.ndarray] = []
    targets: list[np.ndarray] = []
    start = time.perf_counter()
    with progress(desc, total=len(loader.dataset)) as advance:
        for batch in loader:
            x = normalize_batch(stager(batch.images), plan, out_dtype=compute_dtype)
            device_probs.append(eval_step(x))
            masks.append(batch.mask)
            targets.append(batch.labels[batch.mask])
            advance(int(batch.mask.sum()))
    if device_probs:
        probs = local_rows(torch.cat(device_probs))[np.concatenate(masks)]
        targets = np.concatenate(targets)
    else:
        probs, targets = np.zeros((0, 2), np.float32), np.zeros((0,), np.int64)
    speed = len(probs) / max(time.perf_counter() - start, 1e-9)
    return allgather_examples(probs), allgather_examples(targets), speed


def run_eval_job(job: EvalJob) -> EvalResult | None:
    console.print(f"[bold]→ inference {job.model_name}[/]")
    log_path = job.run_paths.logs / "inference.log"
    process_log_path(log_path).unlink(missing_ok=True)
    with tee_output(log_path):
        return _run_eval_job(job)


def _run_eval_job(job: EvalJob) -> EvalResult | None:
    mesh = make_mesh(job.mesh_data, job.mesh_model, job.device)
    # the batch must divide over the data axis; round up (padding absorbs it)
    job.batch_size = -(-job.batch_size // mesh.data) * mesh.data
    console.print(
        f"[bold]Model[/]: {job.model_name} | split={job.split} | batch={job.batch_size}"
        f" | device={job.device}"
    )
    model = load_model_for_eval(job)
    eval_step = make_eval_step(model, tta=job.tta)
    plan = build_eval_plan(job.img_size, job.eval_toggles)
    stager = DeviceStager(job.device)
    scales = _calibrate_int8(job, model, plan, stager)
    if scales is None:
        return _eval_passes(job, eval_step, plan, stager)
    with quant.quantized_eval(quant.QuantCtx(scales=scales)):
        result = _eval_passes(job, eval_step, plan, stager, int8=True)
    if result is not None:
        result.int8_scales = scales
    return result


def _scan_split(job: EvalJob, split: str):
    try:
        ds = scan_image_folder(job.data_root / split)
    except FileNotFoundError:
        return None
    return ds if len(ds) > 0 else None


def _calibrate_int8(job: EvalJob, model, plan, stager: DeviceStager) -> dict[str, Any] | None:
    """The int8 activation scales by ConvBN name when the job asks for int8,
    calibrated over up to 2 val batches (the test split's when val is
    missing or empty); None for bf16, and None with a warning when nothing
    could be calibrated (no images, or no quantizable conv), so that the run
    stays bf16 and is not labelled int8."""
    if str(job.precision).lower() not in ("int8", "i8"):
        return None
    calib_split, calib_ds = job.val_split, _scan_split(job, job.val_split)
    if calib_ds is None:
        calib_split, calib_ds = job.split, _scan_split(job, job.split)
    batches = []
    if calib_ds is not None:
        # every rank calibrates on the split's first batches, as one process
        # does: the same scales everywhere, with no collective
        loader = make_eval_loader(calib_ds, plan, batch_size=job.batch_size, num_workers=0,
                                  shard=False)
        for i, batch in enumerate(loader):
            if i >= 2:
                break
            batches.append(normalize_batch(stager(batch.images), plan,
                                           out_dtype=job.compute_dtype))
    mode = job.int8_calibration
    scales = (quant.calibrate_act_scales(model, batches, mode=mode,
                                         percentile=job.int8_percentile) if batches else {})
    if not scales:
        console.print(
            "[yellow]⚠ int8 requested but nothing calibrated "
            f"({'no quantizable conv layers' if batches else 'no calibration images'}) "
            "— staying bf16[/]"
        )
        return None
    note = "" if mode == "absmax" else (
        f" ({mode}" + (f" at {job.int8_percentile}" if mode == "percentile" else "") + ")")
    console.print(f"  int8 eval: calibrated {len(scales)} conv layers on {len(batches)} "
                  f"'{calib_split}' batches{note}")
    return scales


def _eval_passes(job: EvalJob, eval_step, plan, stager: DeviceStager,
                 int8: bool = False) -> EvalResult | None:
    # ---- binary decision-threshold sweep on val
    best_threshold = 0.5
    vprobs = vtargets = None
    want_calibration = str(job.calibration or "").lower() == "temperature"
    if job.num_classes == 2 or want_calibration:
        val_ds = _scan_split(job, job.val_split)
        if val_ds is not None:
            val_loader = make_eval_loader(
                val_ds, plan, batch_size=job.batch_size,
                num_workers=job.num_workers, lookahead=job.lookahead,
            )
            vprobs, vtargets, _ = collect_probs(
                eval_step, val_loader, plan, stager, job.compute_dtype
            )

    # ---- optional temperature calibration
    temperature = None
    if want_calibration:
        if vprobs is not None and vprobs.size:
            temperature = fit_temperature(vprobs, vtargets)
            console.print(f"  calibration: temperature T={temperature:.4f} (fit on val)")
        else:
            console.print(
                "[yellow]⚠ calibration requested but no val pass ran — "
                "probabilities stay uncalibrated[/]"
            )
    if temperature is not None and vprobs is not None and vprobs.size:
        vprobs = apply_temperature(vprobs, temperature)
    if job.num_classes == 2 and vprobs is not None and vprobs.size:
        best_threshold = sweep_threshold(vprobs[:, 1], vtargets)

    # ---- test pass
    test_path = job.data_root / job.split
    if not test_path.exists():
        console.print(f"[bold red]Split not found:[/] {test_path}")
        raise SystemExit(1)
    test_ds = scan_image_folder(test_path)
    require_num_classes(test_ds, job.num_classes, split=job.split, dataset_root=test_path)
    if len(test_ds) == 0:
        console.print(f"[bold yellow]No images found in[/] {test_path}")
        return None
    loader = make_eval_loader(
        test_ds, plan, batch_size=job.batch_size,
        num_workers=job.num_workers, lookahead=job.lookahead,
    )
    probs, targets, speed = collect_probs(eval_step, loader, plan, stager, job.compute_dtype)
    console.print(f"  eval throughput: {speed:.1f} img/s")

    ece_raw = None
    if temperature is not None and probs.size:
        ece_raw = expected_calibration_error(probs, targets)
        probs = apply_temperature(probs, temperature)

    if job.num_classes == 2:
        preds = (probs[:, 1] >= best_threshold).astype(np.int64)
    else:
        preds = probs.argmax(axis=-1)

    accuracy = float((preds == targets).mean()) if targets.size else 0.0
    metrics: dict[str, Any] = {
        "model": job.model_name,
        "split": job.split,
        "accuracy": accuracy,
        "timestamp": datetime.now().isoformat(),
    }
    if np.unique(targets).size > 1:
        auc = (
            roc_auc(targets, probs[:, 1])
            if job.num_classes == 2
            else roc_auc(targets, probs, multi_class=True)
        )
        if auc is not None:
            metrics["roc_auc"] = auc
    if job.num_classes == 2:
        metrics["threshold"] = float(best_threshold)
    if int8:
        metrics["precision"] = "int8"
    if temperature is not None:
        metrics["temperature"] = float(temperature)
        if ece_raw is not None:
            metrics["ece_uncalibrated"] = ece_raw
            metrics["ece"] = expected_calibration_error(probs, targets)

    cm = confusion(targets, preds, num_classes=job.num_classes)
    metrics["confusion_matrix"] = cm.tolist()
    save_confusion_matrix(cm, test_ds.classes, job.run_paths.plots / "confusion_matrix.png")
    if job.num_classes == 2 and np.unique(targets).size > 1:
        save_roc_curve(targets, probs[:, 1], job.run_paths.plots / "roc_curve.png")

    append_metrics(job.run_paths.logs / "metrics.jsonl", metrics)
    console.print(
        "[bold]Accuracy[/]: "
        f"{accuracy:.4f} "
        + " ".join(
            f"{k}={v:.4f}"
            for k, v in metrics.items()
            if isinstance(v, float) and k != "accuracy"
        )
    )
    # machine-readable one-liner for harness consumption
    console.print(
        json.dumps({"model": job.model_name, "split": job.split, "accuracy": accuracy})
    )
    return EvalResult(
        metrics=metrics, probs=probs, targets=targets, preds=preds,
        classes=list(test_ds.classes), val_probs=vprobs, val_targets=vtargets,
        images_per_s=speed,
    )
