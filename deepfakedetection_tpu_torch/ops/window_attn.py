"""K5: multi-head attention over short token windows with a per-head bias,
forward and backward.

Port of the window-attention kernels of ``deepfakedetection_tpu/ops/pallas/
window_attn.py``. Forward: ``fused_window_attention_v2`` (the head-masked
forward that FasterViT's ``TokenAttention`` takes for N >= 32),
``fused_window_attention_v5`` (sliced heads) and ``fused_window_attention``
(the v1 [B, h, N, d] layout). Backward: ``fused_window_attention_v2_bwd``,
``fused_window_attention_v5_bwd`` and ``_headed_window_attention_bwd``, the
three backwards of ``window_attention_v2``'s custom_vjp. Each group computes
one function; their differences fit it to the TPU's lanes. The CUDA kernels
are ``csrc/window_attn.cu`` (forward) and ``csrc/window_attn_bwd.cu``
(backward, dqkv and dbias summed over windows, deterministically), one launch
per call, reading q, k and v through strides: ``window_attention`` takes the
natural qkv [B, N, 3C] layout (three views of one tensor, no copy),
``window_attention_heads`` the v1 layout. Neither pads N: the kernels mask
their own ragged edge.

``window_attention`` is differentiable: when autograd records and qkv or the
bias requires grad, it goes through ``WindowAttention``, whose forward is the
K5 forward and whose backward recomputes the probabilities from the saved
(qkv, bias), as the JAX custom_vjp does, in ``window_attention_bwd``.

``window_attention_plain`` and ``window_attention_bwd_plain`` are the same
functions in PyTorch ops with the same rounding points (f32 scores, f32
softmax with a division, probabilities and ds rounded to the compute dtype
before their products, f32 accumulation, one cast per output); in float64
every step stays float64, so the backward can be held against autograd. The
wrappers run them for CPU tensors; the tests and ``chip_smoke.py`` hold the
kernels against them. For a CUDA tensor a wrapper launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from deepfakedetection_tpu_torch.ops import build

MAX_TOKENS = 128  # N and d the kernels take
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232448  # shared memory one H100 block may use
# backward blocks per launch the window grouping aims at: four per SM of an
# H100's 132, so each block loops over several windows and its dbias partial
# covers them all
_BWD_TARGET_BLOCKS = 528


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type: float64 for float64 inputs, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _probs(q, k, bias, scale: float) -> torch.Tensor:
    """Softmax((q k^T) * scale + bias) over the keys, in the accumulation type."""
    acc = _acc(q.dtype)
    s = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * scale + bias.to(acc)
    e = (s - s.amax(dim=-1, keepdim=True)).exp()
    return e / e.sum(dim=-1, keepdim=True)


def _softmax_av(q, k, v, bias, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """q, k, v [..., h, N, d]; bias [h, N, N] -> [..., h, N, d] in ``dtype``."""
    acc = _acc(dtype)
    p = _probs(q, k, bias, scale).to(dtype)
    return (p.to(acc) @ v.to(acc)).to(dtype)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, h*d] -> [B, h, N, d] (a view)."""
    B, N, C = t.shape
    return t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[B, h, N, d] -> [B, N, h*d]."""
    B, h, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, h * d)


def window_attention_plain(
    qkv: torch.Tensor, bias: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """qkv [B, N, 3C] (features ordered [3, h, d]), bias [h, N, N] f32 ->
    [B, N, C] in qkv's dtype: per head, softmax((q k^T) * scale + bias) v."""
    C = qkv.shape[-1] // 3
    q, k, v = (_heads(qkv[..., i * C:(i + 1) * C], num_heads) for i in range(3))
    return _merge(_softmax_av(q, k, v, bias, scale, qkv.dtype))


def window_attention_bwd_plain(
    qkv: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor, *, num_heads: int, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``window_attention_plain`` at (qkv, bias) for the
    output gradient ``dout`` [B, N, C]: (dqkv [B, N, 3C] in qkv's dtype,
    dbias [h, N, N] in the bias's dtype, summed over windows). The
    probabilities are recomputed; the row term is rowsum(dp * p) with the
    unrounded p, as ``sliced_head_attention_bwd`` computes it."""
    dtype, acc = qkv.dtype, _acc(qkv.dtype)
    C = qkv.shape[-1] // 3
    q, k, v = (_heads(qkv[..., i * C:(i + 1) * C], num_heads).to(acc) for i in range(3))
    do = _heads(dout.to(dtype), num_heads).to(acc)
    p = _probs(q, k, bias, scale)
    dv = (p.to(dtype).to(acc).transpose(-1, -2) @ do).to(dtype)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds16 = ds.to(dtype).to(acc)
    dq = ((ds16 @ k) * scale).to(dtype)
    dk = ((ds16.transpose(-1, -2) @ q) * scale).to(dtype)
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1), ds.sum(dim=0).to(bias.dtype)


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


def _check_qkv(name: str, qkv: torch.Tensor, bias: torch.Tensor,
               num_heads: int) -> tuple[int, int, int, int]:
    """(B, N, C, d) of a bf16 [B, N, 3C] qkv with a unit feature stride and
    its [h, N, N] f32 bias; raises on anything else."""
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
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    return B, N, C, d


def _forward(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """The K5 forward without autograd: the kernel for a CUDA tensor, the
    plain version for a CPU one."""
    B, N, C, d = _check_qkv("window_attention", qkv, bias, num_heads)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, num_heads=num_heads, scale=scale)
    out = torch.empty(B, N, C, dtype=torch.bfloat16, device=qkv.device)
    src = (qkv.stride(0), qkv.stride(1), d)
    _launch("window_attention", qkv, qkv[..., C:], qkv[..., 2 * C:], bias, out,
            (src, src, src, (N * C, C, d)), B, N, num_heads, d, scale)
    window_attention.launches += 1
    return out


class WindowAttention(torch.autograd.Function):
    """K5 with its gradient, the counterpart of the JAX package's
    ``window_attention_v2`` custom_vjp: the forward saves only (qkv, bias),
    the backward recomputes the probabilities in ``window_attention_bwd``
    from them and the output gradient cast to contiguous bf16."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads: int, scale: float):
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _forward(qkv, bias, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(
            qkv, bias, dout.to(torch.bfloat16).contiguous(), num_heads=ctx.num_heads,
            scale=ctx.scale,
        )
        return (dqkv if ctx.needs_input_grad[0] else None,
                dbias if ctx.needs_input_grad[1] else None, None, None)


def window_attention(
    qkv: torch.Tensor, bias: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """K5 on the natural layout (see ``window_attention_plain``): qkv [B, N, 3C]
    bf16 with a unit stride along features. Launches the CUDA kernel on the
    current stream for a CUDA tensor, runs the plain version for a CPU tensor,
    raises on any other device. While autograd records and qkv or the bias
    requires grad it goes through ``WindowAttention``, so the gradient reaches
    both."""
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return WindowAttention.apply(qkv, bias, num_heads, scale)
    return _forward(qkv, bias, num_heads, scale)


def bwd_smem_bytes(N: int, d: int) -> int:
    """Shared memory of one backward block (``csrc/window_attn_bwd.cu``
    ``bwd_smem_bytes``): q, k, v and dout rows, bf16 p and ds, the f32 dbias
    accumulator."""
    Np, Dp = -(-N // 16) * 16, -(-d // 16) * 16
    return (4 * Np * (Dp + 8) + 2 * Np * (Np + 8)) * 2 + Np * Np * 4


def bwd_windows_per_block(B: int, heads: int) -> int:
    """Windows each backward block loops over: enough blocks for the card
    (``_BWD_TARGET_BLOCKS``) and no more, since each writes a dbias partial."""
    return max(1, B * heads // _BWD_TARGET_BLOCKS)


def window_attention_bwd(
    qkv: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor, *, num_heads: int, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 backward (see ``window_attention_bwd_plain``): qkv [B, N, 3C] bf16,
    bias [h, N, N] f32, dout [B, N, C] bf16, each with a unit stride along
    features -> (dqkv [B, N, 3C] bf16, dbias [h, N, N] f32). Launches the CUDA
    kernel (and its fixed-order dbias reduction) on the current stream for
    CUDA tensors, runs the plain version for CPU tensors, raises otherwise."""
    name = "window_attention_bwd"
    B, N, C, d = _check_qkv(name, qkv, bias, num_heads)
    if (dout.shape != (B, N, C) or dout.dtype != torch.bfloat16 or dout.stride(2) != 1
            or dout.device != qkv.device):
        raise ValueError(
            f"{name}: dout must be bf16 {(B, N, C)} with a unit stride along features on "
            f"{qkv.device}, got {tuple(dout.shape)} {dout.dtype} strides {dout.stride()} on "
            f"{dout.device}"
        )
    if bwd_smem_bytes(N, d) > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: N={N}, head_dim={d} needs {bwd_smem_bytes(N, d)} bytes of shared memory "
            f"a block, more than the {MAX_SMEM_BYTES} an H100 block has"
        )
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, bias, dout, num_heads=num_heads, scale=scale)
    per_block = bwd_windows_per_block(B, num_heads)
    dqkv = torch.empty(B, N, 3 * C, dtype=torch.bfloat16, device=qkv.device)
    dbias = torch.empty(num_heads, N, N, dtype=torch.float32, device=qkv.device)
    partial = torch.empty(-(-B // per_block), num_heads, N, N, dtype=torch.float32,
                          device=qkv.device)
    strides = (qkv.stride(0), qkv.stride(1), dout.stride(0), dout.stride(1))
    vec = int(d % 8 == 0 and all(s % 8 == 0 for s in strides)
              and all(t.data_ptr() % 16 == 0 for t in (qkv, dout, dqkv)))
    lib = build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.dfd_window_attention_bwd(
            qkv.data_ptr(), dout.data_ptr(), bias.data_ptr(), dqkv.data_ptr(),
            partial.data_ptr(), dbias.data_ptr(), B, N, num_heads, d, *strides, per_block,
            float(scale), vec, stream,
        )
    build.check(rc, name)
    window_attention_bwd.launches += 1
    return dqkv, dbias


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
window_attention_bwd.launches = 0
