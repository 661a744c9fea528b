"""K3: the whole stride-1, in == out MBConv+SE block, for inference.

Port of ``deepfakedetection_tpu/ops/pallas/fused_mbconv.py``
(``fused_mbconv_se``): expand 1x1 + SiLU -> depthwise k x k + SiLU -> SE
(pool, FC + SiLU, FC + sigmoid) -> gate -> project 1x1 + bias + residual, on
BN-folded weights. The CUDA kernels are ``csrc/fused_mbconv.cu``;
``fused_mbconv_se_plain`` is the same contract in plain PyTorch, with the
Pallas kernel's rounding points, which the wrapper runs for CPU tensors and
the tests and ``chip_smoke.py`` hold the kernels against. Layout is NHWC, as
in the JAX package, and the weights come in the JAX wrapper's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops.depthwise_se import MAX_SMEM_BYTES
from deepfakedetection_tpu_torch.ops.expand_dw import (
    expand_dw_silu_pool_plain,
    plan,
    sm_count,
    wpack_words,
)


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
) -> torch.Tensor:
    """K3 (see ``fused_mbconv_se_plain`` for the contract). For a CUDA tensor
    it enqueues the CUDA kernels on the current stream (K2's wexp packing and
    expand + depthwise, the two SE products, w_proj's packing, the gated
    projection) and counts one launch; for a CPU tensor it runs the plain
    version; on any other device it raises."""
    weights = (w_exp, b_exp, w_dw, b_dw, w_se_r, b_se_r, w_se_e, b_se_e, w_proj, b_proj)
    _check(x, weights, kernel)
    if x.device.type == "cpu":
        return fused_mbconv_se_plain(x, *weights, kernel=kernel)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mbconv_se: unsupported device {x.device}")
    B, H, W, C = x.shape
    Cmid, Cse = w_exp.shape[1], w_se_r.shape[1]
    dev = x.device
    p = plan(H, W, C, Cmid, kernel, B, sm_count(dev))
    if p is None:
        raise ValueError(f"fused_mbconv_se: no K2 launch plan fits {MAX_SMEM_BYTES} B at "
                         f"{tuple(x.shape)} -> {Cmid}, k {kernel}")
    dw = torch.empty((B, H, W, Cmid), dtype=torch.bfloat16, device=dev)
    pool = torch.empty((B, Cmid), dtype=torch.float32, device=dev)
    wpack = torch.empty(wpack_words(C, Cmid), dtype=torch.int32, device=dev)
    se_part = torch.empty((-(-Cmid // 256), B, Cse), dtype=torch.float32, device=dev)
    gate = torch.empty((B, Cmid), dtype=torch.bfloat16, device=dev)
    # w_proj as bf16 pairs in the mma B layout, Cmid padded to 32, C to 64
    pairs = torch.empty((-(-Cmid // 32) * 16, -(-C // 64) * 64), dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dfd_fused_mbconv_se(
            x.data_ptr(), *(t.data_ptr() for t in weights), dw.data_ptr(), pool.data_ptr(),
            wpack.data_ptr(), se_part.data_ptr(), gate.data_ptr(), pairs.data_ptr(), out.data_ptr(),
            B, H, W, C, Cmid, Cse, kernel, p.CB, p.RB, stream,
        )
    build.check(rc, "fused_mbconv_se")
    fused_mbconv_se.launches += 1
    return out


fused_mbconv_se.launches = 0
