"""Loss and metric primitives.

Port of ``deepfakedetection_tpu/train/objectives.py``: label-smoothed cross
entropy over the valid rows of a padded batch, optionally class-weighted as
torch's ``CrossEntropyLoss(weight=w, label_smoothing=s)``, and the
correct/valid counts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.parallel import mesh


def smoothed_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    label_smoothing: float = 0.1,
    class_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean label-smoothed softmax CE over the valid rows; logits [B, C].
    With ``class_weights`` each class component of the smoothed target is
    weighted by ``w_c`` and the mean normalises by ``sum w[y_i]`` over the
    valid rows. Under a process group that normaliser is summed over the
    ranks first, so each rank's loss is its share of the global batch's
    and the ranks' gradients sum to the global one."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    smooth = F.one_hot(labels, num_classes).float() * (1.0 - label_smoothing)
    smooth = smooth + label_smoothing / num_classes
    logp = F.log_softmax(logits, dim=-1)
    if class_weights is not None:
        w = class_weights.float()
        losses = -(smooth * w[None, :] * logp).sum(-1)
        norm_w = w[labels]
    else:
        losses = -(smooth * logp).sum(-1)
        norm_w = torch.ones_like(losses)
    if mask is not None:
        m = mask.float()
        losses = losses * m
        norm_w = norm_w * m
    return losses.sum() / torch.clamp(mesh.all_reduce_(norm_w.sum()), min=1e-6)


def accuracy_count(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(correct, valid) counts as int32 tensors, left on the device."""
    correct = logits.argmax(-1) == labels
    if mask is None:
        total = torch.tensor(labels.shape[0], dtype=torch.int32, device=labels.device)
    else:
        correct = correct & mask
        total = mask.sum(dtype=torch.int32)
    return correct.sum(dtype=torch.int32), total
