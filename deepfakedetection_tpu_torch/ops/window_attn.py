"""K5 forward: multi-head attention over short token windows with a
per-head bias.

Port of the forward kernels of ``deepfakedetection_tpu/ops/pallas/
window_attn.py``: ``fused_window_attention_v2`` (the head-masked forward that
FasterViT's ``TokenAttention`` takes for N >= 32), ``fused_window_attention_v5``
(sliced heads) and ``fused_window_attention`` (the v1 [B, h, N, d] layout).
They compute one function; their differences fit it to the TPU's lanes. The
CUDA kernel is ``csrc/window_attn.cu``, one launch per call, reading q, k and
v through strides: ``window_attention`` takes the natural qkv [B, N, 3C]
layout (three views of one tensor, no copy), ``window_attention_heads`` the
v1 layout. Neither pads N: the kernel masks its own ragged edge.

``window_attention_plain`` is the same function in PyTorch ops with the same
rounding points (f32 scores, f32 softmax with a division, probabilities
rounded to the compute dtype, f32 accumulation, one cast). The wrappers run it
for CPU tensors; the tests and ``chip_smoke.py`` hold the kernel against it.
For a CUDA tensor a wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from deepfakedetection_tpu_torch.ops import build

MAX_TOKENS = 128  # N and d the kernel takes
MAX_HEAD_DIM = 128


def _softmax_av(q, k, v, bias, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """q, k, v [..., h, N, d]; bias [h, N, N] -> [..., h, N, d] in ``dtype``."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale + bias.float()
    e = (s - s.amax(dim=-1, keepdim=True)).exp()
    p = (e / e.sum(dim=-1, keepdim=True)).to(dtype)
    return (p.float() @ v.float()).to(dtype)


def window_attention_plain(
    qkv: torch.Tensor, bias: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """qkv [B, N, 3C] (features ordered [3, h, d]), bias [h, N, N] f32 ->
    [B, N, C] in qkv's dtype: per head, softmax((q k^T) * scale + bias) v."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4).unbind(0)
    return _softmax_av(q, k, v, bias, scale, qkv.dtype).transpose(1, 2).reshape(B, N, C)


def window_attention_heads_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, *, scale: float
) -> torch.Tensor:
    """The v1 layout: q, k, v [B, h, N, d], bias [h, N, N] f32 -> [B, h, N, d]."""
    return _softmax_av(q, k, v, bias, scale, q.dtype)


def _check_bias(name: str, bias: torch.Tensor, h: int, N: int, device: torch.device) -> None:
    if bias.shape != (h, N, N) or bias.dtype != torch.float32 or not bias.is_contiguous():
        raise ValueError(
            f"{name}: bias must be contiguous f32 {(h, N, N)}, got {tuple(bias.shape)} "
            f"{bias.dtype}"
        )
    if bias.device != device:
        raise ValueError(f"{name}: bias on {bias.device}, qkv on {device}")


def _check_sizes(name: str, N: int, d: int) -> None:
    if not (1 <= N <= MAX_TOKENS and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(
            f"{name}: the kernel takes 1 <= N <= {MAX_TOKENS} tokens and head_dim <= "
            f"{MAX_HEAD_DIM}, got N={N}, head_dim={d}"
        )


def _launch(name, q, k, v, bias, out, strides, B: int, N: int, heads: int, d: int,
            scale: float) -> None:
    """One kernel launch. ``strides`` holds the (batch, row, head) strides of
    q, k, v and out, in elements."""
    flat = [s for st in strides for s in st]
    vec = int(d % 8 == 0 and all(s % 8 == 0 for s in flat)
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dfd_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, N, heads, d, *flat, float(scale), vec, stream,
        )
    build.check(rc, name)


def window_attention(
    qkv: torch.Tensor, bias: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """K5 on the natural layout (see ``window_attention_plain``): qkv [B, N, 3C]
    bf16 with a unit stride along features. Launches the CUDA kernel on the
    current stream for a CUDA tensor, runs the plain version for a CPU tensor,
    raises on any other device."""
    name = "window_attention"
    if qkv.dim() != 3 or qkv.dtype != torch.bfloat16 or qkv.stride(2) != 1:
        raise ValueError(
            f"{name}: qkv must be bf16 [B, N, 3C] with a unit stride along features, got "
            f"{tuple(qkv.shape)} {qkv.dtype} strides {qkv.stride()}"
        )
    B, N, C3 = qkv.shape
    if C3 % 3 or (C3 // 3) % num_heads:
        raise ValueError(f"{name}: 3C={C3} is not 3 x a multiple of num_heads={num_heads}")
    C = C3 // 3
    d = C // num_heads
    _check_bias(name, bias, num_heads, N, qkv.device)
    _check_sizes(name, N, d)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, num_heads=num_heads, scale=scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    out = torch.empty(B, N, C, dtype=torch.bfloat16, device=qkv.device)
    src = (qkv.stride(0), qkv.stride(1), d)
    _launch(name, qkv, qkv[..., C:], qkv[..., 2 * C:], bias, out,
            (src, src, src, (N * C, C, d)), B, N, num_heads, d, scale)
    window_attention.launches += 1
    return out


def window_attention_heads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, *, scale: float
) -> torch.Tensor:
    """K5 on the v1 layout (see ``window_attention_heads_plain``): q, k, v
    [B, h, N, d] bf16 with a unit stride along d. Launches the CUDA kernel for
    CUDA tensors, runs the plain version for CPU tensors, raises otherwise."""
    name = "window_attention_heads"
    for t in (q, k, v):
        if t.dim() != 4 or t.dtype != torch.bfloat16 or t.stride(3) != 1 or t.shape != q.shape:
            raise ValueError(
                f"{name}: q, k, v must be bf16 [B, h, N, d] of one shape with a unit stride "
                f"along d, got {tuple(t.shape)} {t.dtype} strides {t.stride()}"
            )
        if t.device != q.device:
            raise ValueError(f"{name}: q, k, v on different devices")
    B, h, N, d = q.shape
    _check_bias(name, bias, h, N, q.device)
    _check_sizes(name, N, d)
    if q.device.type == "cpu":
        return window_attention_heads_plain(q, k, v, bias, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    out = torch.empty(B, h, N, d, dtype=torch.bfloat16, device=q.device)
    strides = tuple((t.stride(0), t.stride(2), t.stride(1)) for t in (q, k, v, out))
    _launch(name, q, k, v, bias, out, strides, B, N, h, d, scale)
    window_attention_heads.launches += 1
    return out


window_attention.launches = 0
window_attention_heads.launches = 0
