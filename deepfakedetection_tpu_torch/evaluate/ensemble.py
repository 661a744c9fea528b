"""The softmax-averaged ensemble over the batch job's results.

Port of ``deepfakedetection_tpu/evaluate/ensemble.py``, with the same
semantics (the top-level ``ensemble:`` key; off by default):

- every member must have evaluated the same split with identical targets, or
  the ensemble is skipped with a warning rather than combining misaligned rows;
- the members' softmax probabilities combine as a weighted mean in float64,
  weights 1 for a member the config does not name, normalised here
  (``weighted_mean``, which ``serve`` and the web UI use too);
- the binary decision threshold is swept again on the ensemble's val
  probabilities (the 501-point sweep of a single model), or 0.5 when any
  member lacks a val pass;
- metrics, plots and ``metrics.jsonl`` go to their own run dir (by default
  ``runs/ensemble/<ts>/``), the record with a single model's fields under
  ``"model": "ensemble"`` plus a ``"members"`` list.
"""

from __future__ import annotations

import json
from datetime import datetime
from typing import Any

import numpy as np

from deepfakedetection_tpu_torch.evaluate.job import EvalResult
from deepfakedetection_tpu_torch.evaluate.metrics import confusion, roc_auc, sweep_threshold
from deepfakedetection_tpu_torch.evaluate.plots import save_confusion_matrix, save_roc_curve
from deepfakedetection_tpu_torch.runtime.logging import append_metrics, console
from deepfakedetection_tpu_torch.runtime.paths import RunPaths


def weighted_mean(named: list[tuple[str, np.ndarray]],
                  weights: dict[str, float] | None) -> np.ndarray:
    """The arrays of ``(name, array)`` pairs averaged in float64 with
    ``weights`` (1 for a name it lacks), normalised to sum to 1."""
    w = np.asarray([float((weights or {}).get(n, 1.0)) for n, _ in named], np.float64)
    w = w / w.sum()
    return np.tensordot(w, np.stack([a for _, a in named]).astype(np.float64), axes=1)


def combine_probs(
    results: dict[str, EvalResult], weights: dict[str, float] | None, attr: str
) -> np.ndarray | None:
    """Weighted mean of ``attr`` ("probs" or "val_probs") across members;
    None when a member lacks the array or the shapes disagree."""
    arrays = [(n, getattr(r, attr)) for n, r in results.items()]
    if any(a is None for _, a in arrays) or len({a.shape for _, a in arrays}) != 1:
        return None
    return weighted_mean(arrays, weights)


def run_ensemble(
    results: dict[str, EvalResult | None],
    run_paths: RunPaths,
    *,
    num_classes: int,
    weights: dict[str, float] | None = None,
) -> dict[str, Any] | None:
    """Combine two or more members' results into the ensemble's metrics,
    plots and ``metrics.jsonl`` record; returns the record, or None when no
    ensemble can be formed (fewer than two members, different splits,
    misaligned targets)."""
    members = {n: r for n, r in results.items() if r is not None}
    if len(members) < 2:
        console.print("[yellow]⚠ ensemble skipped: fewer than two evaluated models[/]")
        return None
    names = list(members)
    first = members[names[0]]
    splits = {r.metrics.get("split") for r in members.values()}
    if len(splits) != 1:
        console.print(
            f"[yellow]⚠ ensemble skipped: members evaluated different splits {sorted(splits)}[/]"
        )
        return None
    for n in names[1:]:
        t = members[n].targets
        if t.shape != first.targets.shape or not np.array_equal(t, first.targets):
            console.print(
                f"[yellow]⚠ ensemble skipped: target rows of '{n}' do not align "
                f"with '{names[0]}'[/]"
            )
            return None

    probs = combine_probs(members, weights, "probs")
    if probs is None:
        console.print("[yellow]⚠ ensemble skipped: member probabilities misaligned[/]")
        return None
    targets = first.targets

    # the threshold is swept again on the ensemble's val probabilities (binary only)
    best_threshold = 0.5
    val_probs = combine_probs(members, weights, "val_probs")
    vt = [members[n].val_targets for n in names]
    val_aligned = (
        val_probs is not None
        and all(v is not None for v in vt)
        and all(np.array_equal(v, vt[0]) for v in vt[1:])
    )
    if num_classes == 2 and val_aligned and val_probs.size:
        best_threshold = sweep_threshold(val_probs[:, 1], vt[0])

    if num_classes == 2:
        preds = (probs[:, 1] >= best_threshold).astype(np.int64)
    else:
        preds = probs.argmax(axis=-1)

    accuracy = float((preds == targets).mean()) if targets.size else 0.0
    metrics: dict[str, Any] = {
        "model": "ensemble",
        "members": names,
        "split": first.metrics.get("split"),
        "accuracy": accuracy,
        "timestamp": datetime.now().isoformat(),
    }
    if weights:
        metrics["weights"] = {n: float(weights.get(n, 1.0)) for n in names}
    if np.unique(targets).size > 1:
        auc = (
            roc_auc(targets, probs[:, 1])
            if num_classes == 2
            else roc_auc(targets, probs, multi_class=True)
        )
        if auc is not None:
            metrics["roc_auc"] = auc
    if num_classes == 2:
        metrics["threshold"] = float(best_threshold)

    cm = confusion(targets, preds, num_classes=num_classes)
    metrics["confusion_matrix"] = cm.tolist()
    classes = first.classes or [str(i) for i in range(num_classes)]
    save_confusion_matrix(cm, classes, run_paths.plots / "confusion_matrix.png")
    if num_classes == 2 and np.unique(targets).size > 1:
        save_roc_curve(targets, probs[:, 1], run_paths.plots / "roc_curve.png")

    append_metrics(run_paths.logs / "metrics.jsonl", metrics)
    console.print(
        f"[bold]Ensemble[/] ({', '.join(names)}): accuracy {accuracy:.4f} "
        + " ".join(
            f"{k}={v:.4f}"
            for k, v in metrics.items()
            if isinstance(v, float) and k != "accuracy"
        )
    )
    console.print(
        json.dumps({"model": "ensemble", "split": metrics["split"], "accuracy": accuracy})
    )
    return metrics
