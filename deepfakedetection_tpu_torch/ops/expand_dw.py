"""K2: fused MBConv expand 1x1 -> depthwise k x k (+ SiLUs, + SE mean).

Port of ``deepfakedetection_tpu/ops/pallas/expand_dw.py``
(``expand_dw_silu_pool``). The CUDA kernel is ``csrc/expand_dw.cu``;
``expand_dw_silu_pool_plain`` is the same contract in plain PyTorch, with the
same rounding points, which the wrapper runs for CPU tensors and the tests
and ``chip_smoke.py`` hold the kernel against. Layout is NHWC, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops.depthwise_se import MAX_SMEM_BYTES, _align16, _balanced


@dataclass(frozen=True)
class Plan:
    """Launch geometry: output tiles of TH x TW pixels, CB Ce-channels a block."""

    TH: int
    TW: int
    CB: int
    tiles: int
    smem_bytes: int


def _conflict_free(words: int) -> int:
    return words + (12 - words % 8) % 8


def _smem_bytes(TH: int, TW: int, H: int, W: int, Cin: int, CB: int, k: int) -> int:
    """Mirrors ``smem_layout`` in expand_dw.cu: the in-image part of the
    haloed x tile (Cin padded to 16), the wexp slice as bf16 pairs, the
    expanded halo tile, each row padded against bank conflicts, then the
    pool reduction rows (f32)."""
    kp = -(-Cin // 16) * 16
    HH, WW = TH + k - 1, TW + k - 1
    xs = _align16(4 * min(HH, H) * min(WW, W) * _conflict_free(kp // 2))
    ws = _align16(4 * (kp // 2) * (CB + 8))
    es = _align16(2 * HH * WW * (CB + 8))
    return xs + ws + es + 4 * (256 // CB) * CB


# Shared memory under which two blocks share one SM (228 KB, 1 KB each reserved)
TWO_BLOCKS_PER_SM = 113 * 1024


def plan(H: int, W: int, Cin: int, Ce: int, k: int) -> Plan:
    """Tiles of at most 14 x 14 pixels, split evenly (a map of 14 x 14 or less
    is one tile, so its expand is not recomputed on a halo); 64 Ce-channels a
    block (32 when Ce <= 32). While a block would need more shared memory than
    lets two blocks share an SM, the longer tile side is halved: on the H100
    that was faster at B3's 14 x 14 x 136 -> 816, k5 block (0.34 against
    0.47 ms at batch 128) and changed no other B3 shape."""
    CB = 32 if Ce <= 32 else 64
    TH, TW = _balanced(H, 14), _balanced(W, 14)
    while _smem_bytes(TH, TW, H, W, Cin, CB, k) > TWO_BLOCKS_PER_SM and (TH > 1 or TW > 1):
        if TH >= TW:
            TH = -(-TH // 2)
        else:
            TW = -(-TW // 2)
    smem = _smem_bytes(TH, TW, H, W, Cin, CB, k)
    tiles = (-(-H // TH)) * (-(-W // TW))
    return Plan(TH, TW, CB, tiles, smem)


def expand_dw_silu_pool_plain(
    x: torch.Tensor,
    wexp: torch.Tensor,
    bexp: torch.Tensor,
    wdw: torch.Tensor,
    bdw: torch.Tensor,
    *,
    kernel: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,H,W,Cin] bf16; wexp [Cin,Ce], bexp [Ce], wdw [k,k,Ce], bdw [Ce]
    f32 -> (y [B,H,W,Ce] bf16, pool [B,Ce] f32).

    The expand multiplies bf16 x by bf16-rounded wexp with f32 accumulation,
    adds bexp, applies SiLU and rounds to bf16; the expanded map is then
    zero-padded by k//2, the taps run in f32, + bdw, SiLU. The pool is the
    mean of that f32 activation before it is rounded to bf16."""
    k = kernel
    Ce = wexp.shape[1]
    e = x.float() @ wexp.to(torch.bfloat16).float() + bexp
    e = F.silu(e).to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wf = wdw.permute(2, 0, 1).reshape(Ce, 1, k, k)
    yf = F.silu(F.conv2d(e, wf, None, 1, k // 2, 1, Ce) + bdw.view(1, Ce, 1, 1))
    y = yf.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
    return y, yf.mean(dim=(2, 3))


def _check(x, wexp, bexp, wdw, bdw, k: int) -> None:
    if k not in (3, 5):
        raise ValueError(f"expand_dw_silu_pool: kernel must be 3 or 5, got {k}")
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            "expand_dw_silu_pool: x must be a contiguous NHWC bf16 tensor, got "
            f"shape {tuple(x.shape)} {x.dtype} strides {x.stride()}"
        )
    Cin = x.shape[-1]
    Ce = wexp.shape[-1] if wexp.dim() == 2 else -1
    for name, t, shape in (
        ("wexp", wexp, (Cin, Ce)), ("bexp", bexp, (Ce,)),
        ("wdw", wdw, (k, k, Ce)), ("bdw", bdw, (Ce,)),
    ):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"expand_dw_silu_pool: {name} must be contiguous f32 {shape}, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"expand_dw_silu_pool: {name} on {t.device}, x on {x.device}")


def expand_dw_silu_pool(
    x: torch.Tensor,
    wexp: torch.Tensor,
    bexp: torch.Tensor,
    wdw: torch.Tensor,
    bdw: torch.Tensor,
    *,
    kernel: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 (see ``expand_dw_silu_pool_plain`` for the contract). Launches the
    CUDA kernel on the current stream for a CUDA tensor, runs the plain
    version for a CPU tensor, raises on any other device."""
    _check(x, wexp, bexp, wdw, bdw, kernel)
    if x.device.type == "cpu":
        return expand_dw_silu_pool_plain(x, wexp, bexp, wdw, bdw, kernel=kernel)
    if x.device.type != "cuda":
        raise ValueError(f"expand_dw_silu_pool: unsupported device {x.device}")
    B, H, W, Cin = x.shape
    Ce = wexp.shape[1]
    p = plan(H, W, Cin, Ce, kernel)
    if p.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"expand_dw_silu_pool: {p} needs more than {MAX_SMEM_BYTES} B")
    y = torch.empty((B, H, W, Ce), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((B, p.tiles, Ce), dtype=torch.float32, device=x.device)
    pool = torch.empty((B, Ce), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dfd_expand_dw_silu_pool(
            x.data_ptr(), wexp.data_ptr(), bexp.data_ptr(), wdw.data_ptr(),
            bdw.data_ptr(), y.data_ptr(), partial.data_ptr(), pool.data_ptr(),
            B, H, W, Cin, Ce, kernel, p.TH, p.TW, p.CB, stream,
        )
    build.check(rc, "expand_dw_silu_pool")
    expand_dw_silu_pool.launches += 1
    return y, pool


expand_dw_silu_pool.launches = 0
