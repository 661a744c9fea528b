"""Mixup / CutMix over a training batch (opt-in).

Port of ``deepfakedetection_tpu/train/mixup.py``: one lambda per batch from
Beta(alpha, alpha); the partner is the batch rolled by one; with both modes
on, CutMix is picked with probability ``switch_prob``; CutMix pastes a box of
area about 1 - lambda and corrects lambda to the pasted fraction. The loss is
``lam * CE(y) + (1 - lam) * CE(roll(y))``.

Split into ``sample_mix`` (the per-batch draws: mode, lambda, box centre, on
the host from a numpy Generator) and ``apply_mix`` (deterministic), so the
tests can hand a given lambda to both frameworks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deepfakedetection_tpu_torch.parallel import mesh


@dataclass(frozen=True)
class MixupSpec:
    mixup_alpha: float = 0.0  # 0 = mode off
    cutmix_alpha: float = 0.0
    switch_prob: float = 0.5  # P(cutmix) when both modes are on

    @property
    def enabled(self) -> bool:
        return self.mixup_alpha > 0.0 or self.cutmix_alpha > 0.0


@dataclass(frozen=True)
class MixDraw:
    cutmix: bool
    lam: float  # the Beta draw
    center: tuple[int, int] = (0, 0)  # CutMix box centre (y, x)


def sample_mix(rng: np.random.Generator, spec: MixupSpec, height: int, width: int) -> MixDraw:
    if spec.mixup_alpha > 0.0 and spec.cutmix_alpha > 0.0:
        cutmix = bool(rng.random() < spec.switch_prob)
    else:
        cutmix = spec.cutmix_alpha > 0.0
    alpha = spec.cutmix_alpha if cutmix else spec.mixup_alpha
    lam = float(np.float32(rng.beta(alpha, alpha)))
    center = (int(rng.integers(0, height)), int(rng.integers(0, width)))
    return MixDraw(cutmix=cutmix, lam=lam, center=center)


def _cut_box(height: int, width: int, draw: MixDraw) -> tuple[int, int, int, int]:
    ratio = np.sqrt(np.float32(1.0) - np.float32(draw.lam))
    cut_h, cut_w = int(ratio * np.float32(height)), int(ratio * np.float32(width))
    cy, cx = draw.center
    y0 = min(max(cy - cut_h // 2, 0), height)
    y1 = min(max(cy + (cut_h + 1) // 2, 0), height)
    x0 = min(max(cx - cut_w // 2, 0), width)
    x1 = min(max(cx + (cut_w + 1) // 2, 0), width)
    return y0, y1, x0, x1


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=torch.float32).to(dtype).item()


def apply_mix(images: torch.Tensor, draw: MixDraw) -> tuple[torch.Tensor, float]:
    """Mix an NCHW batch with its roll-by-one partner, in the batch's dtype;
    returns the mixed batch and the label weight (f32) of its own labels.
    Under a process group the partner is the global batch rolled by one
    (``mesh.roll_batch``)."""
    partner = mesh.roll_batch(images)
    if not draw.cutmix:
        lam = _in_dtype(draw.lam, images.dtype)
        return images * lam + partner * _in_dtype(1.0 - lam, images.dtype), draw.lam
    h, w = images.shape[-2:]
    y0, y1, x0, x1 = _cut_box(h, w, draw)
    box = torch.zeros(h, w, dtype=images.dtype, device=images.device)
    box[y0:y1, x0:x1] = 1
    pasted = np.float32((y1 - y0) * (x1 - x0)) / np.float32(h * w)
    return images * (1 - box) + partner * box, float(np.float32(1.0) - pasted)
