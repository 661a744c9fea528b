"""K3: the whole stride-1, in == out MBConv+SE block, for inference.

Port of ``deepfakedetection_tpu/ops/pallas/fused_mbconv.py``
(``fused_mbconv_se``): expand 1x1 + SiLU -> depthwise k x k + SiLU -> SE
(pool, FC + SiLU, FC + sigmoid) -> gate -> project 1x1 + bias + residual, on
BN-folded weights. The CUDA kernels are ``csrc/fused_mbconv.cu``: K2's kernel
writes the depthwise map and its pool, two SE kernels compute the gate, and
the gated projection runs on wgmma, fed by TMA. ``plan`` mirrors the
kernels' launch plan (K2's and ``choose_plan`` in the ``.cu``); ``pack``
packs the weights into the layouts the kernels take, once per model in
``MBConv``. ``fused_mbconv_se_plain`` is the same contract in plain PyTorch,
with the Pallas kernel's rounding points, which the wrapper runs for CPU
tensors and the tests and ``chip_smoke.py`` hold the kernels against. Layout
is NHWC, as in the JAX package, and the weights come in the JAX wrapper's
layout.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops import expand_dw as k2
from deepfakedetection_tpu_torch.ops.expand_dw import expand_dw_silu_pool_plain

# Mirrors the constants of csrc/fused_mbconv.cu (and hopper.cuh's kAlign).
PROJ_ROWS = 128  # output rows a projection block
PROJ_STAGES = 3  # the TMA ring's depth
PROJ_WIDTHS = (32, 48, 64, 128, 144, 192)  # BN: one wgmma's N
MMA_COLS = 64  # the mma.sync projection's output columns a block
K_TILE = 64  # Cmid channels a ring stage (128-byte rows)
SMS = k2.SMS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def proj_smem(BN: int) -> int:
    """``proj_smem``: a wgmma projection block's shared memory in bytes, the
    1024-byte alignment slack, three stages of 128 map rows and BN w_proj^T
    rows of 128 bytes, and the ring's barriers."""
    return 1024 + PROJ_STAGES * (PROJ_ROWS + BN) * 2 * K_TILE + 2 * PROJ_STAGES * 8


def choose_plan(C: int, Cmid: int) -> tuple:
    """``choose_plan`` in csrc/fused_mbconv.cu: (projection, BN, column
    tiles, shared bytes). wgmma where Cmid % 8 == 0 (TMA's 16-byte rows), the
    BN of PROJ_WIDTHS that wastes the fewest columns counting 32 more for
    each column tile, the narrower on a tie; else the mma.sync kernel (64
    columns a block)."""
    if Cmid % 8:
        return "mma", MMA_COLS, _cdiv(C, MMA_COLS), 0
    best = PROJ_WIDTHS[0]
    for w in PROJ_WIDTHS:
        if _cdiv(C, w) * (w + 32) < _cdiv(C, best) * (best + 32):
            best = w
    return "wgmma", best, _cdiv(C, best), proj_smem(best)


@dataclass(frozen=True)
class Plan:
    """K3's launch plan: K2's (``k2``), then the projection's: ``proj``
    "wgmma" or "mma", BN output columns a block, ``tiles`` column tiles and
    ``smem_bytes`` a wgmma block."""

    k2: k2.Plan
    proj: str
    BN: int
    tiles: int
    smem_bytes: int

    def describe(self) -> str:
        return (f"K2 CB {self.k2.CB}, RB {self.k2.RB}; {self.proj} projection BN {self.BN} x "
                f"{self.tiles}")

    def kernels(self) -> tuple[str, ...]:
        """The device kernels a launch runs, by the names the profiler
        records (weights packed beforehand)."""
        proj = "gated_proj_kernel" if self.proj == "wgmma" else "gated_proj_mma_kernel"
        return ("expand_dw_kernel", "se_reduce_kernel", "se_expand_kernel", proj)


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, W: int, C: int, Cmid: int, k: int, sms: int = SMS) -> Plan:
    """The launch plan at batch B on a card of ``sms`` SMs (cached: the
    model's forward asks for it every call); raises when K2 has none."""
    p2 = k2.plan(H, W, C, Cmid, k, B, sms)
    if p2 is None:
        raise ValueError(f"fused_mbconv_se: no launch plan fits {k2.MAX_SMEM_BYTES} B at "
                         f"{(B, H, W, C)} -> {Cmid}, k {k}")
    return Plan(p2, *choose_plan(C, Cmid))


def kernel_plan(C: int, Cmid: int) -> tuple | None:
    """``choose_plan`` as the built library computes it (card only), to hold
    the mirror to it."""
    out = (ctypes.c_int * 4)()
    if build.library().dfd_fused_mbconv_plan(C, Cmid, out) != 0:
        return None
    proj, BN, tiles, smem = out
    return ("wgmma" if proj == 1 else "mma", BN, tiles, smem)


class Packed(NamedTuple):
    """The weights in the kernels' layouts (``pack``): wexp [ceil(Cmid/64)*64]
    [ceil(C/16)*8] 32-bit words of bf16 pairs (K2's), see = bf16(w_se_e)
    [Cse][Cmid] and wpt = bf16(w_proj^T) [C][ceil(Cmid/64)*64], zero past
    Cmid."""

    wexp: torch.Tensor
    see: torch.Tensor
    wpt: torch.Tensor


def pack(w_exp: torch.Tensor, w_se_e: torch.Tensor, w_proj: torch.Tensor) -> Packed:
    """Packs K3's f32 weights on their CUDA card (one kernel launch,
    ``pack_kernel``); MBConv does this once and keeps the result."""
    C, Cmid = w_exp.shape
    Cse, dev = w_se_e.shape[0], w_exp.device
    packed = Packed(
        torch.empty((_cdiv(Cmid, 64) * 64, _cdiv(C, 16) * 8), dtype=torch.int32, device=dev),
        torch.empty((Cse, Cmid), dtype=torch.bfloat16, device=dev),
        torch.empty((C, _cdiv(Cmid, K_TILE) * K_TILE), dtype=torch.bfloat16, device=dev),
    )
    with torch.cuda.device(dev):
        rc = build.library().dfd_fused_mbconv_pack(
            w_exp.data_ptr(), w_se_e.data_ptr(), w_proj.data_ptr(),
            *(t.data_ptr() for t in packed), C, Cmid, Cse,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "fused_mbconv_se pack")
    return packed


def fused_mbconv_se_plain(
    x: torch.Tensor,
    w_exp: torch.Tensor,
    b_exp: torch.Tensor,
    w_dw: torch.Tensor,
    b_dw: torch.Tensor,
    w_se_r: torch.Tensor,
    b_se_r: torch.Tensor,
    w_se_e: torch.Tensor,
    b_se_e: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor,
    *,
    kernel: int,
) -> torch.Tensor:
    """x [B,H,W,C] bf16; w_exp [C,Cmid], w_dw [k,k,Cmid], w_se_r [Cmid,Cse],
    w_se_e [Cse,Cmid], w_proj [Cmid,C] and the biases f32 -> [B,H,W,C] bf16.

    Expand and depthwise as ``expand_dw_silu_pool_plain`` (the depthwise map
    rounded to bf16, its mean taken over the f32 activation); then
    ``se = silu(mean @ bf16(w_se_r) + b_se_r)`` and
    ``gate = bf16(sigmoid(se @ bf16(w_se_e) + b_se_e))`` in f32; the gated
    map ``bf16(dw * gate)`` (a bf16 product); ``out = bf16(gated @
    bf16(w_proj) + b_proj + x)`` with f32 accumulation, rounded once."""
    dw, mean = expand_dw_silu_pool_plain(x, w_exp, b_exp, w_dw, b_dw, kernel=kernel)
    se = F.silu(mean @ w_se_r.to(torch.bfloat16).float() + b_se_r)
    gate = torch.sigmoid(se @ w_se_e.to(torch.bfloat16).float() + b_se_e).to(torch.bfloat16)
    gated = dw * gate[:, None, None, :]
    out = gated.float() @ w_proj.to(torch.bfloat16).float() + b_proj + x.float()
    return out.to(torch.bfloat16)


def _check(x, weights, k: int) -> None:
    if k not in (3, 5):
        raise ValueError(f"fused_mbconv_se: kernel must be 3 or 5, got {k}")
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            "fused_mbconv_se: x must be a contiguous NHWC bf16 tensor, got "
            f"shape {tuple(x.shape)} {x.dtype} strides {x.stride()}"
        )
    w_exp, w_proj = weights[0], weights[8]
    C = x.shape[-1]
    Cmid = w_exp.shape[-1] if w_exp.dim() == 2 else -1
    Cse = weights[4].shape[-1] if weights[4].dim() == 2 else -1
    if w_proj.dim() == 2 and w_proj.shape[1] != C:
        raise ValueError(
            f"fused_mbconv_se: the block's output has {w_proj.shape[1]} channels, its input "
            f"{C}: the kernel serves in == out blocks only (the residual adds x)"
        )
    names = ("w_exp", "b_exp", "w_dw", "b_dw", "w_se_r", "b_se_r", "w_se_e", "b_se_e",
             "w_proj", "b_proj")
    shapes = ((C, Cmid), (Cmid,), (k, k, Cmid), (Cmid,), (Cmid, Cse), (Cse,), (Cse, Cmid),
              (Cmid,), (Cmid, C), (C,))
    for name, t, shape in zip(names, weights, shapes):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"fused_mbconv_se: {name} must be contiguous f32 {shape}, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"fused_mbconv_se: {name} on {t.device}, x on {x.device}")


def fused_mbconv_se(
    x: torch.Tensor,
    w_exp: torch.Tensor,
    b_exp: torch.Tensor,
    w_dw: torch.Tensor,
    b_dw: torch.Tensor,
    w_se_r: torch.Tensor,
    b_se_r: torch.Tensor,
    w_se_e: torch.Tensor,
    b_se_e: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor,
    *,
    kernel: int,
    packed: Packed | None = None,
) -> torch.Tensor:
    """K3 (see ``fused_mbconv_se_plain`` for the contract). For a CUDA tensor
    it packs the weights (unless ``packed``, from ``pack``, already holds
    them), enqueues its four kernels on the current stream and counts one
    launch; for a CPU tensor it runs the plain version; on any other device
    it raises."""
    weights = (w_exp, b_exp, w_dw, b_dw, w_se_r, b_se_r, w_se_e, b_se_e, w_proj, b_proj)
    _check(x, weights, kernel)
    if x.device.type == "cpu":
        return fused_mbconv_se_plain(x, *weights, kernel=kernel)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv_se: unsupported device {x.device}")
    B, H, W, C = x.shape
    Cmid, Cse = w_exp.shape[1], w_se_r.shape[1]
    dev = x.device
    p = plan(B, H, W, C, Cmid, kernel, k2.sm_count(dev))
    if packed is None:
        packed = pack(w_exp, w_se_e, w_proj)
    out = torch.empty_like(x)
    scratch = (torch.empty((B, H, W, Cmid), dtype=torch.bfloat16, device=dev),
               torch.empty((B, Cmid), dtype=torch.float32, device=dev),
               torch.empty((-(-Cmid // 256), B, Cse), dtype=torch.float32, device=dev),
               torch.empty((B, Cmid), dtype=torch.bfloat16, device=dev))
    with torch.cuda.device(dev):
        rc = build.library().dfd_fused_mbconv_se(
            x.data_ptr(), packed.wexp.data_ptr(), b_exp.data_ptr(), w_dw.data_ptr(),
            b_dw.data_ptr(), w_se_r.data_ptr(), b_se_r.data_ptr(), packed.see.data_ptr(),
            b_se_e.data_ptr(), packed.wpt.data_ptr(), b_proj.data_ptr(),
            *(t.data_ptr() for t in scratch), out.data_ptr(),
            B, H, W, C, Cmid, Cse, kernel, p.k2.CB, p.k2.RB, int(p.proj == "wgmma"), p.BN,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(rc, "fused_mbconv_se")
    fused_mbconv_se.launches += 1
    return out


fused_mbconv_se.launches = 0
