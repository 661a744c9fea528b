"""Batch prediction CLI: every selected model's prediction for an image or a
directory, on PyTorch, optionally with Grad-CAM triptychs.

Port of the root ``predict.py``; it goes through ``web_ui``'s model loading
and CAM path. Run it from the repository root as::

    python -m deepfakedetection_tpu_torch.predict --config config/inference.yaml --input photo.jpg
    python -m deepfakedetection_tpu_torch.predict --input frames/ --cam --json

``--json`` prints one JSON record an image: ``{"image", "predictions": {model:
{"label", "confidence", "probs"}}}``, or with ``--cam`` ``{"image",
"summary": [lines]}``. ``--ensemble`` (or the config's top-level
``ensemble:`` key) adds the softmax-averaged ensemble of the selected models.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
from PIL import Image

from deepfakedetection_tpu_torch import web_ui
from deepfakedetection_tpu_torch.config import load_config
from deepfakedetection_tpu_torch.data.folder import IMG_EXTENSIONS
from deepfakedetection_tpu_torch.orchestrator import ensemble_settings


def _record(probs: np.ndarray) -> dict:
    cls_idx = int(probs.argmax())
    return {"label": web_ui.label_of(cls_idx),
            "confidence": round(float(probs[cls_idx] * 100.0), 2),
            "probs": [round(float(p), 6) for p in probs]}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Deepfake detection prediction CLI (PyTorch)")
    parser.add_argument("--config", type=Path, default=Path("config/inference.yaml"))
    parser.add_argument("--input", type=Path, required=True, help="image file or directory")
    parser.add_argument("--cam", action="store_true", help="export Grad-CAM triptychs")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    parser.add_argument(
        "--ensemble", action="store_true",
        help="also report the softmax-averaged ensemble of the selected models "
        "(on by default when the config sets a top-level 'ensemble:' key)",
    )
    args = parser.parse_args(argv)

    web_ui.initialize_from_config(args.config)
    ens_cfg = ensemble_settings(load_config(args.config))
    if args.ensemble and ens_cfg is None:
        ens_cfg = {}

    if args.input.is_dir():
        paths = sorted(p for p in args.input.rglob("*")
                       if p.is_file() and p.suffix.lower() in IMG_EXTENSIONS)
    else:
        paths = [args.input]
    if not paths:
        raise SystemExit(f"no images found at {args.input}")

    for path in paths:
        with Image.open(path) as img:
            if args.cam:
                _, summary = web_ui.predict_and_visualize(img.copy())
                if args.json:
                    print(json.dumps({"image": str(path), "summary": summary.splitlines()}))
                else:
                    print(f"{path}:")
                    for line in summary.splitlines():
                        print(f"  {line}")
                continue
            record: dict = {"image": str(path), "predictions": {}}
            lines = []
            member_probs: list[tuple[str, np.ndarray]] = []
            for bundle in web_ui.MODEL_CACHE:
                probs = bundle.probs(bundle.prepare(img))
                member_probs.append((bundle.name, probs))
                pred = record["predictions"][bundle.name] = _record(probs)
                lines.append(f"  {bundle.display_label}: {pred['label']} "
                             f"({probs.max() * 100.0:.2f}% confidence)")
            if ens_cfg is not None and len(member_probs) >= 2:
                probs = web_ui.ensemble_probs(member_probs, ens_cfg)
                pred = record["predictions"]["ensemble"] = _record(probs)
                lines.append(f"  ensemble: {pred['label']} ({probs.max() * 100.0:.2f}% confidence)")
            if args.json:
                print(json.dumps(record))
            else:
                print(f"{path}:")
                print("\n".join(lines))


if __name__ == "__main__":
    main()
