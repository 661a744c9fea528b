"""Optimizer phases: AdamW over a freeze mask, the per-epoch cosine schedule.

Port of ``deepfakedetection_tpu/train/optim.py``. ``PhaseOptimizer`` is
the update of optax's ``adamw`` inside ``multi_transform`` as the JAX
package builds it, through ``torch.optim.AdamW``: b1 0.9, b2 0.999, eps
1e-8, weight decay decoupled (``p * (1 - lr * wd)``, then the bias-corrected
Adam step; optax adds the two in one update, which differs in rounding only)
and applied to every trainable tensor (BatchNorm scale and bias included:
one parameter group), frozen tensors left out, optional global-norm clipping
over every gradient before the freeze (``clip_grad_norm_`` divides by the
norm plus 1e-6 where optax divides by the norm). The freeze predicates match
by name substring as the JAX package's do; they run on the port's
efficientnet_pytorch names (the B3 head is ``_fc`` here, ``classifier`` in
the JAX package, and the recipe lists both).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import numpy as np
import torch


def head_predicate(substrings: Sequence[str]) -> Callable[[str], bool]:
    """True for a name that contains one of ``substrings`` (case-insensitive)."""
    subs = tuple(s.lower() for s in substrings)
    return lambda name: any(s in name.lower() for s in subs)


def unfreeze_predicate(policy) -> Callable[[str], bool]:
    """``"all"``, one substring, or a sequence of substrings."""
    if policy == "all":
        return lambda name: True
    if isinstance(policy, str):
        policy = (policy,)
    return head_predicate(policy)


def epoch_cosine_schedule(
    base_lr: float, epochs: int, steps_per_epoch: int
) -> Callable[[int], float]:
    """CosineAnnealingLR(T_max=epochs-1) stepped once per epoch, as a
    function of the optimizer step, in f32 as the JAX package computes it."""
    t_max = max(epochs - 1, 1)

    def schedule(step: int) -> float:
        epoch = min(step // max(steps_per_epoch, 1), t_max)
        c = np.cos(np.float32(math.pi) * np.float32(epoch) / np.float32(t_max))
        return float(np.float32(base_lr * 0.5) * (np.float32(1.0) + c))

    return schedule


class PhaseOptimizer:
    """``torch.optim.AdamW`` (fused) over the parameters ``trainable(name)``
    selects; the rest get no update. ``lr`` is a constant or a function of
    the step count, set before each step. ``step`` takes the gradients of
    ``grad_params()`` in order."""

    def __init__(
        self,
        named_params: Sequence[tuple[str, torch.nn.Parameter]],
        *,
        lr: float | Callable[[int], float],
        weight_decay: float,
        trainable: Callable[[str], bool],
        grad_clip_norm: float | None = None,
    ) -> None:
        self.params = [p for _, p in named_params]
        self.train_names = [n for n, _ in named_params if trainable(n)]
        self.trainable = [p for n, p in named_params if trainable(n)]
        self.lr = lr if callable(lr) else (lambda _step, v=float(lr): v)
        self.grad_clip_norm = grad_clip_norm
        self.count = 0
        self.adamw = None
        if self.trainable:
            self.adamw = torch.optim.AdamW(self.trainable, lr=self.lr(0), betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=weight_decay, fused=True)

    @property
    def n_train(self) -> int:
        return len(self.trainable)

    @property
    def n_total(self) -> int:
        return len(self.params)

    def grad_params(self) -> list[torch.nn.Parameter]:
        """The tensors the step needs gradients of: every parameter when
        clipping (the norm is over the full gradient), else the trainable."""
        return list(self.params) if self.grad_clip_norm is not None else list(self.trainable)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if self.adamw is None:
            return
        held = self.grad_params()
        for p, g in zip(held, grads):
            # the fused step walks grad and param memory in step: a conv
            # weight's gradient can come back channels_last
            p.grad = g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)
        if self.grad_clip_norm is not None:
            torch.nn.utils.clip_grad_norm_(held, self.grad_clip_norm)
        self.adamw.param_groups[0]["lr"] = self.lr(self.count)
        self.adamw.step()
        self.count += 1
        for p in held:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "names": list(self.train_names),
                "adamw": self.adamw.state_dict() if self.adamw is not None else None}

    def load_state_dict(self, state: dict) -> None:
        if state["names"] != self.train_names:
            raise ValueError("optimizer state is for another set of trainable tensors")
        self.count = int(state["count"])
        if self.adamw is not None:
            self.adamw.load_state_dict(state["adamw"])
