"""K4: batched rotation by Paeth's three shears.

Port of ``deepfakedetection_tpu/ops/pallas/shear_rotate.py``
(``rotate_batch`` over three ``_shear_pass`` calls). Rotation by theta is an
x-shear by -tan(theta/2), a y-shear by sin(theta) and the same x-shear again.
Each pass shifts every row by its own sub-pixel amount with a two-tap
triangle blend in f32 and writes bf16, so a rotation rounds three times, as
the TPU kernel does. It is not one bilinear rotation: that samples
differently (``docs/PARITY.md`` delta 14).

The CUDA kernel is ``csrc/shear_rotate.cu``: the three passes in one launch,
a block an output tile that stages its input region once and keeps both
intermediate passes in shared memory (``plan`` mirrors its launch plan,
``emulate`` its tile walk). ``rotate_batch_plain`` is the same contract in
plain PyTorch, with the TPU kernel's 32-row blocks and block-wide base tap,
which the wrapper runs for CPU tensors and the tests and ``chip_smoke.py``
hold the kernel against: the kernel's output is the plain version's bit for
bit. Layout is the JAX package's: NHWC.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from deepfakedetection_tpu_torch.ops import build

ROWS_PER_BLOCK = 32  # the TPU kernel's row block, which sets the base tap m0
MAX_THETA = 0.45  # radians; larger angles take the gather warp
MAX_THREADS = 384  # the widest tile region a block takes, in element columns
MAX_SMEM_BYTES = 232448  # shared memory one H100 block may use


def taps(max_theta: float) -> tuple[int, int]:
    """(taps_x, taps_y): the two-tap blends of one row block at ``max_theta``
    fall within this many base-relative taps, as in the TPU kernel."""
    span = ROWS_PER_BLOCK - 1
    return (int(math.ceil(math.tan(max_theta / 2.0) * span)) + 2,
            int(math.ceil(math.sin(max_theta) * span)) + 2)


def _passes(thetas: torch.Tensor, H: int, W: int, max_theta: float):
    """(coef [B] f32, center, taps, along_h) of the three passes."""
    a = -torch.tan(thetas / 2.0)
    b = torch.sin(thetas)
    taps_x, taps_y = taps(max_theta)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    return ((a, cy, taps_x, False), (b, cx, taps_y, True), (a, cy, taps_x, False))


@dataclass(frozen=True)
class Plan:
    """The fused kernel's launch plan (``make_plan`` in ``csrc/shear_rotate.cu``):
    output tiles of 32 rows x TW columns (tiles_x x tiles_y an image); a tile's
    region is W2 = TW + taps_x - 1 columns of pass 2, in at most nb segments
    of 32 image columns, each H1 = 32 + taps_y - 1 rows of pass 1; row0
    staged input elements a region row, NE = W2 * C element columns, and the
    block's threads and shared memory bytes."""

    TW: int
    tiles_x: int
    tiles_y: int
    W2: int
    H1: int
    nb: int
    row0: int
    NE: int
    threads: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(H: int, W: int, C: int, max_theta: float) -> Plan:
    """Mirrors ``make_plan``: the widest tile whose region has at most
    MAX_THREADS element columns, W split into balanced tiles."""
    taps_x, taps_y = taps(max_theta)
    twmax = max(1, MAX_THREADS // C - (taps_x - 1))
    TW = _cdiv(W, _cdiv(W, twmax))
    W2, H1 = TW + taps_x - 1, ROWS_PER_BLOCK + taps_y - 1
    nb = (W2 + 30) // ROWS_PER_BLOCK + 1
    row0 = _cdiv((W2 + nb) * C + 14 * nb, 8) * 8
    NE = W2 * C
    threads = _cdiv(min(NE, MAX_THREADS), 32) * 32
    # S0 (S2 over it), the (segment, row) tables of 16 and 24 bytes, the
    # column and row tables, S1
    smem = (2 * H1 * row0 + 16 * nb * H1 + _cdiv(24 * nb * H1, 16) * 16 + 16 * W2
            + 16 * ROWS_PER_BLOCK + _cdiv(2 * H1 * NE, 16) * 16)
    return Plan(TW, _cdiv(W, TW), _cdiv(H, ROWS_PER_BLOCK), W2, H1, nb, row0, NE, threads,
                smem)


def kernel_plan(H: int, W: int, C: int, max_theta: float) -> Plan:
    """The plan the built kernel computes (``dfd_shear_plan``), to hold
    ``plan`` to on the card."""
    out = (ctypes.c_int * 10)()
    build.check(build.library().dfd_shear_plan(H, W, C, *taps(max_theta), out), "kernel_plan")
    return Plan(*out)


def shear_pass_plain(
    x: torch.Tensor, coef: torch.Tensor, *, center: float, taps: int, along_h: bool
) -> torch.Tensor:
    """One pass: x [B,H,W,C] bf16, coef [B] f32 -> [B,H,W,C] bf16, with
    ``out[b,r,l] = sum_{k<taps} max(0, 1-|frac-k|) x[b,r,l+m0+k]`` (rows r
    along H and shifts along W, or the other way round when ``along_h``)."""
    if along_h:
        out = shear_pass_plain(x.transpose(1, 2), coef, center=center, taps=taps, along_h=False)
        return out.transpose(1, 2).contiguous()
    B, H, W, C = x.shape
    r = torch.arange(H, device=x.device)
    r0 = (r // ROWS_PER_BLOCK) * ROWS_PER_BLOCK
    k = coef.float()[:, None]
    s_first = k * (r0.float() - center)
    s_last = k * ((r0 + ROWS_PER_BLOCK - 1).float() - center)
    m0 = torch.floor(torch.minimum(s_first, s_last))  # [B, H], whole numbers
    frac = k * (r.float() - center) - m0
    ka = torch.floor(frac)
    xf = x.float()
    lanes = torch.arange(W, device=x.device)
    out = torch.zeros(B, H, W, C, dtype=torch.float32, device=x.device)
    for j in (ka, ka + 1.0):  # the only taps with a nonzero weight
        w = torch.clamp(1.0 - (frac - j).abs(), min=0.0) * ((j >= 0) & (j < taps))
        src = lanes + (m0 + j).long()[:, :, None]  # [B, H, W]
        inside = (src >= 0) & (src < W)
        v = torch.gather(xf, 2, src.clamp(0, W - 1)[..., None].expand(B, H, W, C))
        out = out + w[:, :, None, None] * (v * inside[..., None])
    return out.to(torch.bfloat16)


def rotate_batch_plain(
    imgs: torch.Tensor, thetas: torch.Tensor, *, max_theta: float = 0.2
) -> torch.Tensor:
    """imgs [B,H,W,C] bf16, thetas [B] f32 radians -> each image rotated about
    its center, zero fill, bf16."""
    _check(imgs, thetas, max_theta)
    x = imgs
    for coef, center, taps, along_h in _passes(thetas, imgs.shape[1], imgs.shape[2], max_theta):
        x = shear_pass_plain(x, coef, center=center, taps=taps, along_h=along_h)
    return x


def _check(imgs: torch.Tensor, thetas: torch.Tensor, max_theta: float) -> None:
    if max_theta > MAX_THETA:
        raise ValueError(
            f"rotate_batch: the shear kernel takes |theta| <= {MAX_THETA} rad, got "
            f"max_theta={max_theta:.3f}; larger angles take the gather warp"
        )
    if imgs.dim() != 4 or imgs.dtype != torch.bfloat16 or not imgs.is_contiguous():
        raise ValueError(
            "rotate_batch: imgs must be a contiguous NHWC bf16 tensor, got shape "
            f"{tuple(imgs.shape)} {imgs.dtype} strides {imgs.stride()}"
        )
    if thetas.shape != (imgs.shape[0],) or thetas.dtype != torch.float32:
        raise ValueError(
            f"rotate_batch: thetas must be f32 [{imgs.shape[0]}], got "
            f"{tuple(thetas.shape)} {thetas.dtype}"
        )
    if thetas.device != imgs.device:
        raise ValueError(f"rotate_batch: thetas on {thetas.device}, imgs on {imgs.device}")


def rotate_batch(
    imgs: torch.Tensor, thetas: torch.Tensor, *, max_theta: float = 0.2
) -> torch.Tensor:
    """K4 (see ``rotate_batch_plain`` for the contract). Launches the CUDA
    kernel once on the current stream for a CUDA tensor (the coefficients
    are the plain version's own torch calls), runs the plain version for a
    CPU tensor, raises on any other device."""
    if imgs.device.type == "cpu":
        return rotate_batch_plain(imgs, thetas, max_theta=max_theta)
    _check(imgs, thetas, max_theta)
    if imgs.device.type != "cuda":
        raise ValueError(f"rotate_batch: unsupported device {imgs.device}")
    B, H, W, C = imgs.shape
    if plan(H, W, C, max_theta).smem > MAX_SMEM_BYTES:
        raise ValueError(f"rotate_batch: {C} channels need more than {MAX_SMEM_BYTES} B a block")
    (a, cy, taps_x, _), (b, cx, taps_y, _), _ = _passes(thetas, H, W, max_theta)
    y = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        rc = build.library().dfd_shear_rotate(
            imgs.data_ptr(), y.data_ptr(), a.contiguous().data_ptr(), b.contiguous().data_ptr(),
            B, H, W, C, cy, cx, taps_x, taps_y, stream,
        )
    build.check(rc, "rotate_batch")
    rotate_batch.launches += 1
    return y


rotate_batch.launches = 0
