"""Weights into the port's models.

``state_dict_from_jax`` carries a JAX package ``{"params", "batch_stats"}``
tree across through ``export_torch_state_dict`` (the name maps of
``deepfakedetection_tpu/runtime/torch_convert.py``). ``load_weights`` reads a
genuine torch ``.pth``. A native flax msgpack export (the JAX package's
``checkpoints/<Model>.pth``) is converted once with the existing CLI:
``python tools/convert.py --model NAME --weights ckpt.pth --out for_torch.pth``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from deepfakedetection_tpu.runtime.torch_convert import export_torch_state_dict

_WRAPPERS = ("state_dict", "model")


def state_dict_from_jax(tree: dict[str, Any], family: str) -> dict[str, torch.Tensor]:
    """JAX package variables (numpy leaves) -> the port's state dict."""
    return {
        k: torch.from_numpy(np.array(v, np.float32))
        for k, v in export_torch_state_dict(tree, family).items()
    }


def load_state_dict_strict(model: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """``load_state_dict(strict=True)``, except that BatchNorm's
    ``num_batches_tracked`` counters may be absent."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")


def is_torch_checkpoint(path: Path) -> bool:
    """True for a PyTorch checkpoint (zip or legacy pickle)."""
    with Path(path).open("rb") as f:
        magic = f.read(2)
    return magic[:2] == b"PK" or magic[:1] == b"\x80"


def load_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """A torch ``.pth`` state dict, unwrapped from ``{"state_dict": ...}`` or
    ``{"model": ...}``. Raises for a native msgpack export, which
    ``tools/convert.py --out x.pth`` turns into a torch file."""
    path = Path(path)
    if not is_torch_checkpoint(path):
        raise ValueError(
            f"{path} is not a torch checkpoint (a native msgpack export?); convert it "
            "once with: python tools/convert.py --model NAME --weights "
            f"{path} --out for_torch.pth"
        )
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for wrapper in _WRAPPERS:
            if isinstance(obj.get(wrapper), dict):
                obj = obj[wrapper]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"{path} holds no state dict")
    return obj
