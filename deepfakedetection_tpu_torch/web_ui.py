"""Web UI for real-vs-fake face detection with Grad-CAM panels, on PyTorch.

Port of the root ``web_ui.py``: loads every selected model of an inference
YAML through the eval job's loader (on the device of the YAML's ``device``),
predicts per model with softmax confidence, renders a Grad-CAM overlay panel
per model with a text label (``cam.py``), concatenates the panels side by
side, exports a 2x bicubic-upscaled PNG to
``outputs/cam_exports/cam_triptych_<UTC %Y%m%d_%H%M%S>.png`` and serves a
Gradio interface. With a top-level ``ensemble:`` key the summary gains the
softmax-averaged ensemble's verdict. Run it from the repository root as::

    python -m deepfakedetection_tpu_torch.web_ui --config config/inference.yaml

Gradio is needed only by ``build_interface``; ``predict_and_visualize`` works
without it.
"""

from __future__ import annotations

import argparse
from collections.abc import Callable
from dataclasses import dataclass
from datetime import UTC, datetime
from pathlib import Path
from typing import Any

import numpy as np
import torch
from PIL import Image, ImageDraw, ImageFont

from deepfakedetection_tpu_torch.cam import compute_cam, denormalize_to_rgb, show_cam_on_image
from deepfakedetection_tpu_torch.config import load_config
from deepfakedetection_tpu_torch.data.augment import normalize_batch
from deepfakedetection_tpu_torch.data.decode import decode_pil_eval
from deepfakedetection_tpu_torch.data.transforms import (
    EvalTransformPlan,
    build_eval_plan,
    resolve_transform_mapping,
)
from deepfakedetection_tpu_torch.evaluate.ensemble import weighted_mean
from deepfakedetection_tpu_torch.evaluate.job import load_model_for_eval, make_eval_step
from deepfakedetection_tpu_torch.orchestrator import build_eval_job, ensemble_settings
from deepfakedetection_tpu_torch.runtime.flags import resolve_device
from deepfakedetection_tpu_torch.runtime.paths import ensure_run_dirs

DEFAULT_CONFIG_PATH = Path("config/inference.yaml")
EXPORT_SCALE = 2
EXPORT_DIR = Path("outputs") / "cam_exports"


@dataclass
class ModelBundle:
    """One selected model's inference resources."""

    name: str
    display_label: str
    model: torch.nn.Module
    eval_step: Callable[[torch.Tensor], torch.Tensor]
    plan: EvalTransformPlan
    device: torch.device

    def prepare(self, image: Image.Image) -> torch.Tensor:
        """The normalised f32 [1, 3, S, S] batch of one image, on the
        device."""
        arr = decode_pil_eval(image, self.plan)
        return normalize_batch(torch.from_numpy(arr)[None].to(self.device), self.plan)

    def probs(self, x: torch.Tensor) -> np.ndarray:
        """Softmax probabilities [C] of one prepared image."""
        return self.eval_step(x).float().cpu().numpy()[0]


CLASS_LABELS: dict[int, str] = {0: "fake", 1: "real"}
MODEL_CACHE: list[ModelBundle] = []
ENSEMBLE_CFG: dict[str, Any] | None = None


def ensemble_probs(member_probs: list[tuple[str, np.ndarray]],
                   settings: dict[str, Any]) -> np.ndarray:
    """The members' softmax outputs averaged with the settings' ``weights``
    (1 for a member it does not name), in float64: the batch ensemble's
    ``weighted_mean``."""
    return weighted_mean(member_probs, settings.get("weights"))


def label_of(cls_idx: int) -> str:
    return CLASS_LABELS.get(cls_idx, f"class_{cls_idx}")


def initialize_from_config(config_path: Path) -> None:
    """Load the config and fill ``MODEL_CACHE`` with its selected models."""
    global CLASS_LABELS, MODEL_CACHE, ENSEMBLE_CFG
    config = load_config(config_path)
    ENSEMBLE_CFG = ensemble_settings(config)
    labels_cfg = config.get("data", {}).get("class_labels")
    if isinstance(labels_cfg, dict):
        CLASS_LABELS = {int(k): str(v) for k, v in labels_cfg.items()}
    device = resolve_device(config)
    models_cfg: dict[str, dict[str, Any]] = config.get("models", {})
    selection: list[str] = config.get("selection") or list(models_cfg.keys())

    bundles: list[ModelBundle] = []
    for model_name in selection:
        model_cfg = models_cfg.get(model_name)
        if not isinstance(model_cfg, dict):
            print(f"[UI] Skipping unknown model '{model_name}' in selection.")
            continue
        run_paths = ensure_run_dirs(
            Path(model_cfg.get("output_dir") or f"runs/{model_name}"), run_id="webui"
        )
        # the orchestrator's job carries the img_size fallbacks, model_kwargs,
        # the weights path and the transforms exactly as the eval job reads them
        job = build_eval_job(config, model_name, dict(model_cfg, name=model_name), run_paths,
                             device)
        plan = build_eval_plan(job.img_size, resolve_transform_mapping(model_cfg, "eval"))
        model = load_model_for_eval(job)
        display_label = str(model_cfg.get("display_name") or model_cfg.get("label") or model_name)
        bundles.append(ModelBundle(name=model_name, display_label=display_label, model=model,
                                   eval_step=make_eval_step(model, tta=job.tta), plan=plan,
                                   device=device))
    if not bundles:
        raise RuntimeError("No valid models configured for inference.")
    MODEL_CACHE = bundles


def _add_label(img_rgb_uint8: np.ndarray, text: str) -> np.ndarray:
    """Text label at the top left, white with a black stroke."""
    img = Image.fromarray(img_rgb_uint8)
    draw = ImageDraw.Draw(img)
    draw.text((6, 6), text, fill=(255, 255, 255), stroke_width=2, stroke_fill=(0, 0, 0),
              font=ImageFont.load_default())
    return np.asarray(img)


def predict_and_visualize(image: Image.Image) -> tuple[np.ndarray, str]:
    """Every model's prediction and Grad-CAM panel; returns the exported
    triptych (uint8 [2h, 2w, 3]) and the summary text."""
    panels: list[np.ndarray] = []
    summary_lines: list[str] = []
    member_probs: list[tuple[str, np.ndarray]] = []
    for bundle in MODEL_CACHE:
        x = bundle.prepare(image)
        probs = bundle.probs(x)
        member_probs.append((bundle.name, probs))
        cls_idx = int(probs.argmax())
        confidence = float(probs[cls_idx] * 100.0)
        label = label_of(cls_idx)
        summary_lines.append(f"{bundle.display_label}: {label} ({confidence:.2f}% confidence)")
        cam = compute_cam(bundle.model, x, cls_idx)[0].cpu().numpy()
        rgb = denormalize_to_rgb(x[0].permute(1, 2, 0).cpu().numpy(), bundle.plan.mean,
                                 bundle.plan.std, normalize=bundle.plan.normalize)
        panels.append(_add_label(show_cam_on_image(rgb, cam),
                                 f"{bundle.display_label} {label} ({confidence:.1f}%)"))
    if not panels:
        raise RuntimeError("No models available for inference.")

    # the ensemble's verdict goes into the summary only: the panels are per model
    if ENSEMBLE_CFG is not None and len(member_probs) >= 2:
        eprobs = ensemble_probs(member_probs, ENSEMBLE_CFG)
        cls_idx = int(eprobs.argmax())
        summary_lines.append(f"Ensemble: {label_of(cls_idx)} "
                             f"({float(eprobs[cls_idx] * 100.0):.2f}% confidence)")

    side_by_side = np.concatenate(panels, axis=1)
    h, w, _ = side_by_side.shape
    export_img = Image.fromarray(side_by_side).resize(
        (w * EXPORT_SCALE, h * EXPORT_SCALE), resample=Image.BICUBIC)
    EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    out_path = EXPORT_DIR / f"cam_triptych_{datetime.now(tz=UTC).strftime('%Y%m%d_%H%M%S')}.png"
    export_img.save(out_path, format="PNG", optimize=True)
    summary = "\n".join(summary_lines + [f"Saved: {out_path.resolve()}"])
    return np.asarray(export_img), summary


def build_interface(config_path: Path = DEFAULT_CONFIG_PATH):
    """The Gradio interface over ``predict_and_visualize`` (needs the
    ``gradio`` package)."""
    try:
        import gradio as gr
    except ImportError as err:
        raise RuntimeError("the web UI needs the 'gradio' package, which is not installed "
                           "(predict_and_visualize and the predict CLI work without it)") from err
    initialize_from_config(config_path)
    return gr.Interface(
        fn=predict_and_visualize,
        inputs=gr.Image(type="pil"),
        outputs=[gr.Image(type="numpy"), "text"],
        title="Real vs Fake Face Detection",
        description="Upload an image to determine if the face is real or fake.",
    )


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Deepfake detection UI (PyTorch)")
    parser.add_argument("--config", type=Path, default=DEFAULT_CONFIG_PATH)
    args = parser.parse_args(argv)
    build_interface(args.config).launch()


if __name__ == "__main__":
    main()
