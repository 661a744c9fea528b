"""The device rule and the compute dtype, from the YAML config, the one
numerics switch, ``DFD_EXACT_GELU``, and the two opt-in kernel switches,
``DFD_FUSED_ATTN`` (FasterViT's attention sub-block as K6) and
``DFD_FUSED_MBCONV`` (B3's residual MBConv blocks as K3). Otherwise the port
has no dispatch flags: on the card the kernels are the path."""

from __future__ import annotations

import os
from typing import Any

import torch

_FALSY = ("", "0", "false", "no")  # the JAX package's env_flag


def fused_attn() -> bool:
    """``DFD_FUSED_ATTN`` set (the JAX package's opt-in fused qkv ->
    attention -> proj FasterViT sub-block): a bf16 FasterViT built with it
    runs every attention through K6 (``ops/attn_block.py``) instead of the
    qkv Linear, K5 and the proj Linear."""
    return os.environ.get("DFD_FUSED_ATTN", "").strip().lower() not in _FALSY


def fused_mbconv() -> bool:
    """``DFD_FUSED_MBCONV`` set: a bf16 EfficientNet built with it runs every
    eval block that K3 takes (stride 1, an expansion, in == out, k 3 or 5,
    symmetric pads) through ``ops/fused_mbconv.py`` instead of K2, the SE
    gate, the project ConvBN and the residual add. The JAX package has no
    model route to its K3."""
    return os.environ.get("DFD_FUSED_MBCONV", "").strip().lower() not in _FALSY


def exact_gelu() -> bool:
    """``DFD_EXACT_GELU=1`` selects the erf GELU; by default GELU takes its
    tanh form, as the JAX package does (``models/common.py`` there, PARITY
    delta 15): at most 4.8e-4 from erf, under one bf16 step."""
    return os.environ.get("DFD_EXACT_GELU") == "1"


def resolve_device(config: dict[str, Any]) -> torch.device:
    """The YAML ``device``: ``cpu`` runs the kernels' plain versions on the
    CPU; any other value (the shipped configs say ``tpu``), or none, means the
    CUDA card, and raises when there is none. Nothing falls back to the CPU.
    Under a process group the card is the rank's, ``cuda:LOCAL_RANK``
    (``parallel/multihost.py``); else ``cuda:N`` names one, and the current
    device serves."""
    name = str(config.get("device") or "").strip().lower()
    if name.startswith("cpu"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name or '(unset)'!r} needs a CUDA card and none is available; "
            "set device: cpu to run on the CPU"
        )
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        from deepfakedetection_tpu_torch.parallel.multihost import local_rank

        return torch.device("cuda", local_rank())
    index = name.split(":", 1)[1] if name.startswith("cuda:") else None
    return torch.device("cuda", int(index) if index else torch.cuda.current_device())


def compute_dtype(config: dict[str, Any]) -> torch.dtype:
    """The top-level ``precision``: bf16 by default, or float32."""
    precision = str(config.get("precision") or "bfloat16").lower()
    return {
        "bfloat16": torch.bfloat16,
        "bf16": torch.bfloat16,
        "float32": torch.float32,
        "fp32": torch.float32,
    }[precision]
