"""The int8 depthwise convolution of the int8 eval path (``ops/quant.py``).

No Pallas kernel stands behind it: the JAX package computes its int8
depthwise conv in XLA (``deepfakedetection_tpu/ops/quant.py``, ``int8_conv``),
and PyTorch has no CUDA int8 convolution, so the port writes one by hand:
``csrc/int8_dw.cu``. ``int8_depthwise_plain`` is the same contract in plain
PyTorch (unfold, int32 products, a sum, then the same roundings), which the
wrapper runs for CPU tensors and the tests and ``chip_smoke.py`` hold the
kernel against.

Layout is the JAX package's: NHWC activations, [k, k, C] taps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.ops import build

Pads = tuple[tuple[int, int], tuple[int, int]]

# the kernel's activation codes
ACTS = {"none": 0, "silu": 1, "gelu_tanh": 2, "gelu_erf": 3}


def out_size(size: int, k: int, stride: int, pad: tuple[int, int]) -> int:
    return (size + pad[0] + pad[1] - k) // stride + 1


def int8_depthwise_acc_plain(xq: torch.Tensor, wq: torch.Tensor, *, stride: int,
                             pads: Pads) -> torch.Tensor:
    """The exact int32 sums of the taps: xq [B,H,W,C] int8 zero-padded by
    ``pads`` ((top, bottom), (left, right)), wq [k,k,C] int8 -> [B,Ho,Wo,C]
    int32."""
    k = wq.shape[0]
    (pt, pb), (pl, pr) = pads
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
    windows = xp.unfold(1, k, stride).unfold(2, k, stride)  # [B, Ho, Wo, C, k, k]
    taps = wq.permute(2, 0, 1).to(torch.int32)  # [C, k, k]
    return (windows.to(torch.int32) * taps).sum(dim=(-2, -1), dtype=torch.int32)


def epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, act: str,
             out_dtype: torch.dtype) -> torch.Tensor:
    """``act(acc * scale + bias)`` in f32, the product and the sum rounded
    apart, then one cast to ``out_dtype``."""
    y = acc.float() * scale
    y = y + bias
    if act == "silu":
        y = F.silu(y)
    elif act in ("gelu_tanh", "gelu_erf"):
        y = F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    return y.to(out_dtype)


def int8_depthwise_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, *, stride: int, pads: Pads, act: str = "none",
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """xq [B,H,W,C] int8, wq [k,k,C] int8, scale and bias [C] f32 ->
    [B,Ho,Wo,C] ``out_dtype`` = act(acc * scale + bias), acc the int32 sum of
    the k x k taps over the zero-padded input at ``stride``."""
    acc = int8_depthwise_acc_plain(xq, wq, stride=stride, pads=pads)
    return epilogue(acc, scale, bias, act, out_dtype)


def _check(xq, wq, scale, bias, stride: int, pads: Pads, act: str, out_dtype) -> None:
    if xq.dim() != 4 or xq.dtype != torch.int8 or not xq.is_contiguous():
        raise ValueError("int8_depthwise: xq must be a contiguous NHWC int8 tensor, got "
                         f"shape {tuple(xq.shape)} {xq.dtype} strides {xq.stride()}")
    k, C = wq.shape[0], xq.shape[-1]
    if k not in (3, 5) or tuple(wq.shape) != (k, k, C) or wq.dtype != torch.int8 \
            or not wq.is_contiguous():
        raise ValueError(f"int8_depthwise: wq must be contiguous int8 [k, k, {C}] with k 3 "
                         f"or 5, got {tuple(wq.shape)} {wq.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (C,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"int8_depthwise: {name} must be contiguous f32 [{C}], got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("wq", wq), ("scale", scale), ("bias", bias)):
        if t.device != xq.device:
            raise ValueError(f"int8_depthwise: {name} on {t.device}, xq on {xq.device}")
    if stride not in (1, 2) or min(min(p) for p in pads) < 0:
        raise ValueError(f"int8_depthwise: stride 1 or 2 and pads >= 0, got {stride} {pads}")
    if act not in ACTS or out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_depthwise: act in {tuple(ACTS)} and a bf16 or f32 output, "
                         f"got {act} {out_dtype}")


def int8_depthwise(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, *, stride: int, pads: Pads, act: str = "none",
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The int8 depthwise conv (see ``int8_depthwise_plain`` for the
    contract). Launches the CUDA kernel on the current stream for a CUDA
    tensor, runs the plain version for a CPU tensor, raises on any other
    device."""
    pads = tuple(map(tuple, pads))
    _check(xq, wq, scale, bias, stride, pads, act, out_dtype)
    if xq.device.type == "cpu":
        return int8_depthwise_plain(xq, wq, scale, bias, stride=stride, pads=pads, act=act,
                                    out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_depthwise: unsupported device {xq.device}")
    B, H, W, C = xq.shape
    k = wq.shape[0]
    (pt, pb), (pl, pr) = pads
    Ho, Wo = out_size(H, k, stride, (pt, pb)), out_size(W, k, stride, (pl, pr))
    if Ho < 1 or Wo < 1:
        raise ValueError(f"int8_depthwise: empty output for {tuple(xq.shape)} k {k} {pads}")
    y = torch.empty((B, Ho, Wo, C), dtype=out_dtype, device=xq.device)
    lib = build.library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = lib.dfd_int8_depthwise(
            xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, H, W, C, k, stride, pt, pb, pl, pr, ACTS[act], int(out_dtype == torch.float32),
            stream,
        )
    build.check(rc, "int8_depthwise")
    int8_depthwise.launches += 1
    return y


int8_depthwise.launches = 0
