"""Determinism: host RNG seeding and the generators of a run.

Port of ``deepfakedetection_tpu/runtime/seeding.py``. Every random draw of a
training run (augmentation, dropout, drop-path, mixup, BN recalibration)
comes from a generator derived from the run's root ``torch.Generator`` and a
path of integers, such as (phase, epoch, batch): a derived generator depends
on its path only, not on what was drawn before, so a resumed run replays
the draws of the batches it repeats. The JAX package folds keys into a
``jax.random.key`` the same way; the two give different numbers.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def apply_seed(seed: int | None) -> None:
    """Seed Python's, numpy's and torch's global generators; no-op for None."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def root_generator(seed: int | None) -> torch.Generator:
    """The run's root generator; seed None counts as 0, as in the JAX package."""
    return torch.Generator().manual_seed(0 if seed is None else int(seed))


def derive_seed(root: torch.Generator, *path: int) -> int:
    """A 63-bit seed from the root's seed and ``path`` (numpy SeedSequence)."""
    seq = np.random.SeedSequence(entropy=root.initial_seed(), spawn_key=tuple(map(int, path)))
    return int(seq.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def fold_in(root: torch.Generator, *path: int, device: torch.device | str = "cpu"):
    """A fresh ``torch.Generator`` on ``device`` for ``path`` under ``root``."""
    return torch.Generator(device=device).manual_seed(derive_seed(root, *path))


def fold_in_numpy(root: torch.Generator, *path: int) -> np.random.Generator:
    """A numpy Generator for host-side draws (mixup's per-batch scalars)."""
    return np.random.default_rng(derive_seed(root, *path))
