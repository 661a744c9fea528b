"""Grad-CAM over the models' final feature maps.

Port of ``deepfakedetection_tpu/cam.py``. Each model's ``cam_features``
returns the map the JAX model sows as ``cam_features`` (B3 after its head
ConvBN, FasterViT-2 and EfficientFormerV2 after their final norm), and
``classify`` is the head over it. The eval forward runs to the map without a
gradient, so on the card it runs the kernels (K1/K2, K5, K7), which have no
backward; the gradient comes from the head alone, replayed in f32 on the
map.

The overlay follows pytorch_grad_cam's ``show_cam_on_image``: a jet
heatmap, a 0.5/0.5 blend, renormalised by its max.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def head_logits(model: nn.Module, feats: torch.Tensor) -> torch.Tensor:
    """The model's head replayed in f32 on a [B, C, h, w] map: the f32 mean
    pool through ``_fc`` (EfficientNet), ``head`` (FasterViT) or the mean of
    ``head`` and ``head_dist`` (EfficientFormerV2)."""
    return model.classify(feats.float())


def compute_cam(model: nn.Module, x: torch.Tensor, cls_idx: int | torch.Tensor) -> torch.Tensor:
    """Grayscale CAM [B, H, W] in [0, 1] at the input's resolution, f32.

    The weights are the spatial mean of d(score)/dA per channel, where score
    is the sum over the batch of each image's logit of ``cls_idx``; the map
    is ReLU(sum_c w_c A_c), min-max normalised per image and then resized
    bilinearly (half-pixel centres) to the input: pytorch_grad_cam's
    ``scale_cam_image`` order. ``model`` must be in eval mode."""
    with torch.no_grad():
        feats = model.cam_features(x)
    if feats.dim() != 4:
        raise ValueError(f"cam_features must be a [B, C, h, w] map, got {tuple(feats.shape)}")
    a = feats.detach().float().requires_grad_(True)
    with torch.enable_grad():
        logits = head_logits(model, a)
        idx = torch.as_tensor(cls_idx, device=logits.device).reshape(-1).expand(len(logits))
        score = logits[torch.arange(len(logits), device=logits.device), idx].sum()
        (grads,) = torch.autograd.grad(score, a)
    weights = grads.mean(dim=(2, 3), keepdim=True)
    cam = torch.relu((weights * a.detach()).sum(dim=1))
    cam = cam - cam.amin(dim=(1, 2), keepdim=True)
    cam = cam / (1e-7 + cam.amax(dim=(1, 2), keepdim=True))
    return F.interpolate(cam[:, None], size=tuple(x.shape[2:]), mode="bilinear",
                         align_corners=False)[:, 0]


def jet_colormap(gray: np.ndarray) -> np.ndarray:
    """OpenCV-style JET colormap: [H, W] in [0, 1] -> [H, W, 3] float RGB in
    [0, 1]."""
    g = np.clip(gray, 0.0, 1.0)
    v = 4.0 * g
    r = np.clip(np.minimum(v - 1.5, -v + 4.5), 0.0, 1.0)
    gch = np.clip(np.minimum(v - 0.5, -v + 3.5), 0.0, 1.0)
    b = np.clip(np.minimum(v + 0.5, -v + 2.5), 0.0, 1.0)
    return np.stack([r, gch, b], axis=-1).astype(np.float32)


def show_cam_on_image(rgb: np.ndarray, cam: np.ndarray, image_weight: float = 0.5) -> np.ndarray:
    """The overlay: blend the heatmap with the image, renormalise by the
    max, uint8."""
    heatmap = jet_colormap(cam)
    overlay = (1.0 - image_weight) * heatmap + image_weight * rgb
    overlay = overlay / max(float(overlay.max()), 1e-7)
    return np.uint8(255 * overlay)


def denormalize_to_rgb(x: np.ndarray, mean: tuple[float, ...], std: tuple[float, ...], *,
                       normalize: bool) -> np.ndarray:
    """[H, W, 3] normalised float -> RGB float in [0, 1]."""
    arr = np.asarray(x, np.float32)
    if normalize:
        arr = arr * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(arr, 0.0, 1.0)
