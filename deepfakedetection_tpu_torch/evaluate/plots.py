"""confusion_matrix.png and roc_curve.png, as the JAX package draws them
(``deepfakedetection_tpu/evaluate/plots.py``), written by process 0 only.
Skipped, returning False, where matplotlib or scikit-learn is missing."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deepfakedetection_tpu_torch.runtime.paths import rank


def save_confusion_matrix(cm: np.ndarray, labels: list[str], path: Path) -> bool:
    if rank() != 0:
        return False
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.metrics import ConfusionMatrixDisplay
    except ImportError:
        return False
    disp = ConfusionMatrixDisplay(confusion_matrix=cm, display_labels=labels)
    fig, ax = plt.subplots(figsize=(6, 5))
    disp.plot(ax=ax, cmap="Blues", colorbar=False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def save_roc_curve(y_true: np.ndarray, y_scores: np.ndarray, path: Path) -> bool:
    if rank() != 0:
        return False
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.metrics import RocCurveDisplay
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(6, 5))
    RocCurveDisplay.from_predictions(y_true, y_scores, ax=ax)
    ax.set_title("ROC Curve")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True
