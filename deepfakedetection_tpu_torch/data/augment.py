"""Eval-time input normalisation on the device.

Port of ``normalize_batch`` in ``deepfakedetection_tpu/data/augment.py``.
The training augmentations are ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import torch

from deepfakedetection_tpu.data.transforms import EvalTransformPlan


def normalize_batch(
    images: torch.Tensor, plan: EvalTransformPlan, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 [B,S,S,3] -> ``(x/255 - mean) / std`` (ImageNet statistics) in
    ``out_dtype``, computed in f32 on the tensor's device. Returns the
    NCHW-logical view of the NHWC data, which is channels_last in memory."""
    x = images.permute(0, 3, 1, 2).float()
    if not images.dtype.is_floating_point:
        x = x * (1.0 / 255.0)
    if plan.normalize:
        mean = torch.tensor(plan.mean, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(plan.std, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
        x = (x - mean) / std
    return x.to(out_dtype)
