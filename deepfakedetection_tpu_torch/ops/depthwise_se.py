"""K1: fused stride-1 depthwise conv + bias + SiLU + SE spatial mean.

Port of ``deepfakedetection_tpu/ops/pallas/depthwise_se.py``
(``depthwise_silu_pool``). The CUDA kernel is ``csrc/depthwise_se.cu``;
``depthwise_silu_pool_plain`` is the same contract in plain PyTorch, with the
same rounding points, which the wrapper runs for CPU tensors and the tests
and ``chip_smoke.py`` hold the kernel against.

Layout is the JAX package's: NHWC. A channels_last NCHW activation gives
that view with ``x.permute(0, 2, 3, 1)`` at no copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.ops import build

MAX_SMEM_BYTES = 232448  # shared memory one H100 block may use


@dataclass(frozen=True)
class Plan:
    """Launch geometry: output tiles of TH x TW pixels, CB channels a block."""

    TH: int
    TW: int
    CB: int
    tiles: int
    smem_bytes: int


def _balanced(n: int, cap: int) -> int:
    parts = -(-n // cap)
    return -(-n // parts)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def plan(H: int, W: int, C: int, k: int) -> Plan:
    """Tiles of at most 16 x 16 pixels, split evenly; a block takes all of C
    when C <= 64, else 64 channels. Mirrors the layout in depthwise_se.cu."""
    TH, TW = _balanced(H, 16), _balanced(W, 16)
    CB = C if C <= 64 else 64
    smem = _align16(2 * (TH + k - 1) * (TW + k - 1) * CB) + 4 * (256 // CB) * CB
    tiles = (-(-H // TH)) * (-(-W // TW))
    return Plan(TH, TW, CB, tiles, smem)


def depthwise_silu_pool_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,H,W,C] bf16, w [k,k,C] f32, b [C] f32 -> (y [B,H,W,C] bf16 =
    silu(dw(x) + b) with zero padding k//2, pool [B,C] f32 = mean of the
    bf16-rounded y). Taps and bias in f32."""
    C = x.shape[-1]
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.permute(2, 0, 1).reshape(C, 1, k, k)
    acc = F.conv2d(xf, wf, None, 1, k // 2, 1, C) + b.view(1, C, 1, 1)
    y = F.silu(acc).to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
    return y, y.float().mean(dim=(1, 2))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int) -> None:
    if k not in (3, 5):
        raise ValueError(f"depthwise_silu_pool: k must be 3 or 5, got {k}")
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            "depthwise_silu_pool: x must be a contiguous NHWC bf16 tensor, got "
            f"shape {tuple(x.shape)} {x.dtype} strides {x.stride()}"
        )
    C = x.shape[-1]
    for name, t, shape in (("w", w, (k, k, C)), ("b", b, (C,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"depthwise_silu_pool: {name} must be contiguous f32 {shape}, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"depthwise_silu_pool: {name} on {t.device}, x on {x.device}")


def depthwise_silu_pool(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 (see ``depthwise_silu_pool_plain`` for the contract). Launches the
    CUDA kernel on the current stream for a CUDA tensor, runs the plain
    version for a CPU tensor, raises on any other device."""
    _check(x, w, b, k)
    if x.device.type == "cpu":
        return depthwise_silu_pool_plain(x, w, b, k=k)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_silu_pool: unsupported device {x.device}")
    B, H, W, C = x.shape
    p = plan(H, W, C, k)
    if p.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"depthwise_silu_pool: {p} needs more than {MAX_SMEM_BYTES} B")
    y = torch.empty_like(x)
    partial = torch.empty((B, p.tiles, C), dtype=torch.float32, device=x.device)
    pool = torch.empty((B, C), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dfd_depthwise_silu_pool(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            partial.data_ptr(), pool.data_ptr(), B, H, W, C, k, p.TH, p.TW, p.CB, stream,
        )
    build.check(rc, "depthwise_silu_pool")
    depthwise_silu_pool.launches += 1
    return y, pool


depthwise_silu_pool.launches = 0
