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
are ``csrc/window_attn.cu`` (forward; its launch plan is ``fwd_plan``) and
``csrc/window_attn_bwd.cu`` (backward, dqkv and dbias summed over windows,
deterministically; its launch plan is ``bwd_plan``), one launch per call,
reading q, k and v through strides: ``window_attention`` takes the
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

import ctypes
import functools
from typing import NamedTuple

import torch

from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops.expand_dw import sm_count

MAX_TOKENS = 128  # N and d the kernels take
MAX_HEAD_DIM = 128
MAX_SMEM_BYTES = 232448  # shared memory one H100 block may use
H100_SMS = 132
FWD_MAX_GROUPS = 4  # the forward's most warp groups a block
FWD_MAX_SLOTS = 4  # the forward's deepest ring a group
_FWD_BARRIER_BYTES = 8 * FWD_MAX_GROUPS * FWD_MAX_SLOTS
BWD_MAX_SLOTS = 4  # the backward's deepest input ring
_BWD_BARRIER_BYTES = 128
# the forward's and the backward's device kernels, by the names the profiler records
FWD_KERNELS = ("window_attention_kernel",)
BWD_KERNELS = ("window_attention_bwd_kernel", "dbias_reduce_kernel")


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


def fwd_groups(N: int, d: int) -> int:
    """The forward's warp groups a block (``csrc/window_attn.cu``
    ``fwd_groups``): four at N <= 64 and head_dim <= 64, else two."""
    return 4 if N <= 64 and d <= 64 else 2


def fwd_smem_bytes(N: int, d: int, slots: int = 1) -> int:
    """Shared memory of one forward block (``csrc/window_attn.cu``
    ``fwd_smem_bytes``): each of its ``fwd_groups`` warp groups' ring of
    ``slots`` windows of q, k and v (one slot by default, the least plan)."""
    Np, Dp = -(-N // 16) * 16, -(-d // 16) * 16
    return _FWD_BARRIER_BYTES + fwd_groups(N, d) * slots * 3 * Np * (Dp + 8) * 2


class FwdPlan(NamedTuple):
    """The forward's launch plan (``csrc/window_attn.cu`` ``fwd_plan``)."""

    per_head: int  # blocks a head, each owning a contiguous range of its windows
    groups: int  # warp groups a block
    slots: int  # windows in each warp group's ring
    smem: int  # bytes of dynamic shared memory a block

    def blocks(self, heads: int) -> int:
        return heads * self.per_head

    def windows(self, B: int, part: int, group: int) -> range:
        """The windows a head's block ``part`` gives its warp group ``group``,
        in the order the group computes them (every ``groups``-th window of
        the block's contiguous range)."""
        first, end = part * B // self.per_head, (part + 1) * B // self.per_head
        return range(first + group, end, self.groups)


@functools.lru_cache(maxsize=256)
def fwd_plan(B: int, N: int, heads: int, d: int, sms: int = H100_SMS) -> FwdPlan | None:
    """The forward's plan on a card of ``sms`` SMs, as ``fwd_plan`` in
    ``csrc/window_attn.cu`` (which ``kernel_fwd_plan`` reads back on the
    card), or None when none fits a block's shared memory: ``fwd_groups``
    warp groups, each with the deepest ring of up to ``FWD_MAX_SLOTS``
    windows that fits; as many blocks a head as the SMs hold for all the
    heads, at most one a window."""
    for slots in range(FWD_MAX_SLOTS, 0, -1):
        smem = fwd_smem_bytes(N, d, slots)
        if smem <= MAX_SMEM_BYTES:
            return FwdPlan(max(1, min(B, sms // heads)), fwd_groups(N, d), slots, smem)
    return None


def kernel_fwd_plan(B: int, N: int, heads: int, d: int, sms: int) -> FwdPlan | None:
    """The plan the built kernel computes for the shape (card only), to hold
    ``fwd_plan`` to it."""
    plan = (ctypes.c_int * 4)()
    if build.library().dfd_window_attention_plan(B, N, heads, d, sms, plan) != 0:
        return None
    return FwdPlan(*plan)


def _launch(name, q, k, v, bias, out, strides, B: int, N: int, heads: int, d: int,
            scale: float) -> None:
    """One kernel launch. ``strides`` holds the (batch, row, head) strides of
    q, k, v and out, in elements. Raises when no plan fits (``fwd_plan``)."""
    sms = sm_count(q.device)
    if fwd_plan(B, N, heads, d, sms) is None:
        raise ValueError(
            f"{name}: N={N}, head_dim={d} needs {fwd_smem_bytes(N, d)} bytes of shared memory "
            f"a block, more than the {MAX_SMEM_BYTES} an H100 block has"
        )
    flat = [s for st in strides for s in st]
    vec = int(d % 8 == 0 and all(s % 8 == 0 for s in flat)
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dfd_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, N, heads, d, *flat, sms, float(scale), vec, stream,
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


def bwd_smem_bytes(N: int, d: int, slots: int = 1, buffers: int = 1) -> int:
    """Shared memory of one backward block (``csrc/window_attn_bwd.cu``
    ``bwd_smem_bytes``) with ``slots`` windows of q, k, v and dout in its
    input ring and ``buffers`` pairs of bf16 p and ds (the least plan by
    default), plus the f32 dbias accumulator at N > 64."""
    Np, Dp = -(-N // 16) * 16, -(-d // 16) * 16
    return (_BWD_BARRIER_BYTES + slots * 4 * Np * (Dp + 8) * 2 + buffers * 2 * Np * (Np + 8) * 2
            + (Np * (Np + 8) * 4 if Np > 64 else 0))


class BwdPlan(NamedTuple):
    """The backward's launch plan (``csrc/window_attn_bwd.cu`` ``bwd_plan``)."""

    per_head: int  # blocks a head, each owning a contiguous range of its windows
    slots: int  # windows in the input ring
    buffers: int  # p/ds buffers
    smem: int  # bytes of dynamic shared memory a block

    def blocks(self, heads: int) -> int:
        return heads * self.per_head

    def windows(self, B: int, part: int) -> range:
        """The windows, in the order it sums them, of a head's block ``part``."""
        return range(part * B // self.per_head, (part + 1) * B // self.per_head)


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, N: int, heads: int, d: int, sms: int = H100_SMS) -> BwdPlan | None:
    """The backward's plan on a card of ``sms`` SMs, as ``bwd_plan`` in
    ``csrc/window_attn_bwd.cu`` (which ``kernel_bwd_plan`` reads back on the
    card), or None when none fits a block's shared memory: the deepest input
    ring of up to ``BWD_MAX_SLOTS`` windows that fits with two p/ds buffers,
    else two slots and one buffer, else one and one; as many blocks a head as
    the SMs hold for all the heads, at most one a window."""
    fits = [(s, 2) for s in range(BWD_MAX_SLOTS, 1, -1)] + [(2, 1), (1, 1)]
    for slots, buffers in fits:
        smem = bwd_smem_bytes(N, d, slots, buffers)
        if smem <= MAX_SMEM_BYTES:
            return BwdPlan(max(1, min(B, sms // heads)), slots, buffers, smem)
    return None


def kernel_bwd_plan(B: int, N: int, heads: int, d: int, sms: int) -> BwdPlan | None:
    """The plan the built kernel computes for the shape (card only), to hold
    ``bwd_plan`` to it."""
    plan = (ctypes.c_int * 4)()
    if build.library().dfd_window_attention_bwd_plan(B, N, heads, d, sms, plan) != 0:
        return None
    return BwdPlan(*plan)



def window_attention_bwd(
    qkv: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor, *, num_heads: int, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 backward (see ``window_attention_bwd_plain``): qkv [B, N, 3C] bf16,
    bias [h, N, N] f32, dout [B, N, C] bf16, each with a unit stride along
    features -> (dqkv [B, N, 3C] bf16, dbias [h, N, N] f32). Launches the CUDA
    kernel (and its fixed-order dbias reduction) on the current stream for
    CUDA tensors, runs the plain version for CPU tensors, raises otherwise or
    when no plan fits (``bwd_plan``)."""
    name = "window_attention_bwd"
    B, N, C, d = _check_qkv(name, qkv, bias, num_heads)
    if (dout.shape != (B, N, C) or dout.dtype != torch.bfloat16 or dout.stride(2) != 1
            or dout.device != qkv.device):
        raise ValueError(
            f"{name}: dout must be bf16 {(B, N, C)} with a unit stride along features on "
            f"{qkv.device}, got {tuple(dout.shape)} {dout.dtype} strides {dout.stride()} on "
            f"{dout.device}"
        )
    if bwd_plan(B, N, num_heads, d) is None:
        raise ValueError(
            f"{name}: N={N}, head_dim={d} needs {bwd_smem_bytes(N, d)} bytes of shared memory "
            f"a block, more than the {MAX_SMEM_BYTES} an H100 block has"
        )
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, bias, dout, num_heads=num_heads, scale=scale)
    sms = sm_count(qkv.device)
    plan = bwd_plan(B, N, num_heads, d, sms)
    dqkv = torch.empty(B, N, 3 * C, dtype=torch.bfloat16, device=qkv.device)
    dbias = torch.empty(num_heads, N, N, dtype=torch.float32, device=qkv.device)
    partial = torch.empty(plan.blocks(num_heads), N, N, dtype=torch.float32, device=qkv.device)
    strides = (qkv.stride(0), qkv.stride(1), dout.stride(0), dout.stride(1))
    vec = int(d % 8 == 0 and all(s % 8 == 0 for s in strides)
              and all(t.data_ptr() % 16 == 0 for t in (qkv, dout, dqkv)))
    lib = build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.dfd_window_attention_bwd(
            qkv.data_ptr(), dout.data_ptr(), bias.data_ptr(), dqkv.data_ptr(),
            partial.data_ptr(), partial.shape[0], dbias.data_ptr(), B, N, num_heads, d,
            *strides, sms, float(scale), vec, stream,
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
