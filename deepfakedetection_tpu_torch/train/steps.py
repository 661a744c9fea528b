"""Train step, BN recalibration, weight EMA.

Port of ``deepfakedetection_tpu/train/steps.py``. PyTorch runs eagerly, so
the step is a function over the live model and its ``PhaseOptimizer``
instead of a jitted ``TrainState -> TrainState`` program; the numerics are
the JAX step's: bf16 compute cast explicitly (no autocast, no GradScaler),
label-smoothed CE over the valid rows, the optimizer's AdamW; with ``remat``
the forward runs under ``models/common.remat`` (``jax.checkpoint`` in the
JAX step): the same numbers, the activations recomputed in the backward.
Validation
uses the eval job's step (``evaluate/job.make_eval_step``), whose forward
runs K1 and K2 in bf16.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence

import numpy as np
import torch
from torch import nn

from deepfakedetection_tpu_torch.models import common
from deepfakedetection_tpu_torch.parallel import mesh
from deepfakedetection_tpu_torch.train.mixup import MixDraw, apply_mix
from deepfakedetection_tpu_torch.train.objectives import accuracy_count, smoothed_cross_entropy
from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer

__all__ = ["EMA", "recalibrate_bn", "train_step"]


def train_step(
    model: nn.Module,
    opt: PhaseOptimizer,
    images: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator | None,
    *,
    label_smoothing: float = 0.1,
    class_weights: torch.Tensor | None = None,
    mix: MixDraw | None = None,
    remat: bool = False,
) -> dict[str, torch.Tensor]:
    """One optimizer step on a normalised NCHW batch; ``generator`` draws
    the dropout and drop-path masks, ``mix`` is the batch's mixup draw (off
    when None), ``remat`` recomputes the forward's activations in the
    backward. Returns the loss and correct/valid counts, on the device.

    Under a process group the batch is this rank's rows of the global batch
    and the step is the global batch's (``parallel/mesh.py``): BatchNorm's
    statistics, the masks, the loss normaliser and mixup's partner are the
    global batch's, the phase's gradients are summed over the ranks before
    the optimizer (no ``DistributedDataParallel``: its reducer acts on
    ``.grad``, and the step takes ``autograd.grad``), and the returned loss
    and counts are the global ones."""
    model.train()
    if mix is not None:
        images, lam = apply_mix(images, mix)
    if remat:
        logits = common.remat(model, images, generator, generator=generator)
    else:
        logits = model(images, generator)
    loss = smoothed_cross_entropy(
        logits, labels, mask, label_smoothing=label_smoothing, class_weights=class_weights
    )
    if mix is not None:
        loss_b = smoothed_cross_entropy(
            logits, mesh.roll_batch(labels), mask, label_smoothing=label_smoothing,
            class_weights=class_weights,
        )
        loss = loss * lam + loss_b * float(np.float32(1.0) - np.float32(lam))
    grads = torch.autograd.grad(loss, opt.grad_params())
    opt.step(mesh.all_reduce_gradients(grads))
    correct, total = accuracy_count(logits.detach(), labels, mask)
    if mesh.data_axis() is None:
        return {"loss": loss.detach(), "correct": correct, "total": total}
    # each rank's loss is its share of the global batch's: the sums are the
    # global loss and counts, the same on every rank
    summed = mesh.all_reduce_(torch.stack([loss.detach(), correct.float(), total.float()]))
    return {"loss": summed[0], "correct": summed[1].to(torch.int32),
            "total": summed[2].to(torch.int32)}


@torch.no_grad()
def recalibrate_bn(
    model: nn.Module,
    batches: Iterable[torch.Tensor],
    generator_of: Callable[[int], torch.Generator],
) -> int:
    """Precise BN: every BatchNorm's running statistics become the pooled
    statistics of training forwards over ``batches`` (batch i's masks from
    ``generator_of(i)``): mean = E[mean_k], var = E[var_k] + Var[mean_k].
    Returns the number of batches; with none the statistics stay. Under a
    process group each forward's statistics are the global batch's, so the
    pooled statistics are the same on every rank."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    was_training = model.training
    model.train()
    count = 0
    sums: list[list[torch.Tensor]] = []
    try:
        with common.bn_momentum_override(0.0):
            for i, images in enumerate(batches):
                model(images, generator_of(i))
                fresh = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
                if not sums:
                    sums = [[m, v, m * m] for m, v in fresh]
                else:
                    for acc, (m, v) in zip(sums, fresh):
                        acc[0] += m
                        acc[1] += v
                        acc[2] += m * m
                count += 1
    finally:
        model.train(was_training)
    for bn, (sm, sv, smm) in zip(bns, sums):
        mean = sm / count
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(sv / count + (smm / count - mean * mean))
    return count


class EMA:
    """Exponential moving average of the parameters, ``ema = d*ema +
    (1-d)*p`` in f32 after every optimizer step, with the timm ramp
    ``d_t = min(decay, (1+t)/(10+t))`` over the phase's step count t."""

    def __init__(
        self, params: Sequence[torch.Tensor], decay: float, *, warmup: bool = True,
        shadow: Sequence[torch.Tensor] | None = None,
    ) -> None:
        self.decay, self.warmup = float(decay), warmup
        src = params if shadow is None else shadow
        self.shadow = [t.detach().clone().to(p.device) for t, p in zip(src, params)]

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], step: int) -> None:
        d = np.float32(self.decay)
        if self.warmup:
            t = np.float32(step)
            d = min(d, (np.float32(1.0) + t) / (np.float32(10.0) + t))
        torch._foreach_mul_(self.shadow, float(d))
        torch._foreach_add_(
            self.shadow, torch._foreach_mul(list(params), float(np.float32(1.0) - d))
        )
