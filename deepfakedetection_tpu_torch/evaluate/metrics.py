"""Metrics: threshold sweep, calibration, confusion matrix, ROC-AUC.

The port's copy of ``deepfakedetection_tpu/evaluate/metrics.py``, in numpy
on the host.
"""

from __future__ import annotations

import numpy as np


def sweep_threshold(scores: np.ndarray, targets: np.ndarray) -> float:
    """The best of 501 thresholds in [0, 1] by balanced accuracy, scanned
    upwards so the lowest wins a tie; 0.5 when one class is missing."""
    scores = np.asarray(scores, np.float64)
    targets = np.asarray(targets, np.int64)
    if scores.size == 0 or np.unique(targets).size < 2:
        return 0.5
    thresholds = np.linspace(0.0, 1.0, 501)
    preds = scores[:, None] >= thresholds[None, :]
    pos = targets == 1
    tpr = preds[pos].sum(axis=0) / max(int(pos.sum()), 1)
    tnr = (~preds[~pos]).sum(axis=0) / max(int((~pos).sum()), 1)
    return float(thresholds[int(np.argmax((tpr + tnr) / 2.0))])


def expected_calibration_error(probs: np.ndarray, targets: np.ndarray, n_bins: int = 15) -> float:
    """ECE of the max-probability confidence over equal-width bins."""
    probs = np.asarray(probs, np.float64)
    targets = np.asarray(targets, np.int64)
    if probs.size == 0:
        return 0.0
    conf = probs.max(axis=-1)
    correct = probs.argmax(axis=-1) == targets
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(conf, edges[1:-1], right=True), 0, n_bins - 1)
    ece = 0.0
    for b in range(n_bins):
        in_bin = idx == b
        n = int(in_bin.sum())
        if n:
            ece += (n / len(conf)) * abs(correct[in_bin].mean() - conf[in_bin].mean())
    return float(ece)


def fit_temperature(
    probs: np.ndarray, targets: np.ndarray, bounds: tuple[float, float] = (0.05, 20.0)
) -> float:
    """The temperature T minimising the NLL of softmax(log(p) / T) on held-out
    rows: golden-section search over log T. log(p) equals the logits up to a
    per-row constant, so saved probabilities suffice."""
    probs = np.asarray(probs, np.float64)
    targets = np.asarray(targets, np.int64)
    if probs.size == 0:
        return 1.0
    logit = np.log(np.clip(probs, 1e-12, 1.0))

    def nll(log_t: float) -> float:
        z = logit / np.exp(log_t)
        z = z - z.max(axis=-1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
        return float(-logp[np.arange(len(targets)), targets].mean())

    a, b = np.log(bounds[0]), np.log(bounds[1])
    inv_phi = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - inv_phi * (b - a), a + inv_phi * (b - a)
    fc, fd = nll(c), nll(d)
    for _ in range(60):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - inv_phi * (b - a)
            fc = nll(c)
        else:
            a, c, fc = c, d, fd
            d = a + inv_phi * (b - a)
            fd = nll(d)
    return float(np.exp((a + b) / 2.0))


def apply_temperature(probs: np.ndarray, temperature: float) -> np.ndarray:
    """Saved probability rows re-softmaxed at ``temperature``."""
    probs = np.asarray(probs, np.float64)
    if probs.size == 0 or temperature == 1.0:
        return probs
    z = np.log(np.clip(probs, 1e-12, 1.0)) / float(temperature)
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def confusion(targets: np.ndarray, preds: np.ndarray, num_classes: int | None = None) -> np.ndarray:
    """Confusion matrix indexed by raw label, sized to cover every label."""
    targets = np.asarray(targets, np.int64)
    preds = np.asarray(preds, np.int64)
    max_label = int(max(targets.max(initial=-1), preds.max(initial=-1)))
    n = max(num_classes or 0, max_label + 1, 1)
    cm = np.zeros((n, n), dtype=np.int64)
    np.add.at(cm, (targets, preds), 1)
    return cm


def roc_auc(targets: np.ndarray, scores: np.ndarray, *, multi_class: bool = False) -> float | None:
    """ROC-AUC through scikit-learn where it is installed, else the
    rank-based binary AUC (None for multi-class)."""
    try:
        from sklearn.metrics import roc_auc_score
    except ImportError:
        return None if multi_class else _binary_auc(np.asarray(targets), np.asarray(scores))
    try:
        if multi_class:
            return float(roc_auc_score(targets, scores, multi_class="ovr"))
        return float(roc_auc_score(targets, scores))
    except ValueError:
        return None


def _binary_auc(targets: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney U with average ranks for ties."""
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(len(scores), dtype=np.float64)
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    pos = targets == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
