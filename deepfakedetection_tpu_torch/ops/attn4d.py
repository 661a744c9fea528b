"""K7: EfficientFormerV2's talking-head attention (Attention4D), inference.

Port of ``deepfakedetection_tpu/ops/pallas/attn4d.py`` (``fused_attn4d``
and its unpadded wrapper ``attn4d_pallas``). Per image and output head g:
``p = softmax_m(sum_h th1[h, g] * (q_h k_h^T * scale + bias[h]) + th1_b[g])``,
then ``out_g = (sum_h th2[h, g] * p_h + th2_b[g]).to(bf16) @ v_g`` with f32
accumulation. The talking-head tables are in the flax orientation
``[h_in, g_out]``. The CUDA kernel is ``csrc/attn4d.cu``: one launch per call,
persistent blocks that each own whole images, no padding of N (it masks the
ragged edge itself), q, k and v read through (batch, row) strides. Its launch
plan is ``plan`` here, the mirror of the kernel's, which ``kernel_plan``
reads back on the card; the C entry takes the card's SM count.

``attn4d_plain`` is the same function in PyTorch ops at the same rounding
points (f32 scores, mixes and softmax with a division, p2 rounded to the
compute dtype before its product with v, f32 accumulation, one cast of the
output); float32 inputs stay float32 throughout and float64 inputs float64.
The wrapper runs it for CPU tensors; the tests and ``chip_smoke.py`` hold the
kernel against it. For a CUDA tensor ``attn4d`` launches the kernel or
raises. Like the TPU kernel it has no backward. The wrapper calls the
operator ``torch.ops.dfd.attn4d`` (``build.define_op``), which takes q, k
and v as the strided views they are.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops.expand_dw import sm_count
from deepfakedetection_tpu_torch.ops.window_attn import (
    H100_SMS,
    MAX_SMEM_BYTES,
    _acc,
    _heads,
    _merge,
)

MAX_TOKENS = 128  # N the kernel takes
MAX_HEADS = 8
MAX_SLOTS = 8  # the v ring's deepest (csrc/attn4d.cu kMaxSlots)
HEADER_BYTES = 1024  # barriers and tables ahead of the operands (kHeader)


class Plan(NamedTuple):
    """The kernel's launch plan (``csrc/attn4d.cu`` ``plan``)."""

    blocks: int  # persistent blocks
    images: int  # images a block, at most
    tiles: int  # 16-row query tiles a row group
    slots: int  # v ring slots
    smem: int  # bytes of dynamic shared memory a block


def layout_bytes(N: int, heads: int, d: int, dv: int, tiles: int) -> tuple[int, int]:
    """(bytes ahead of the v ring, bytes of one ring slot) of a block's
    shared memory (``csrc/attn4d.cu`` ``Layout``): the header, q of a row
    group's rows < N, k of the image's rows, the f32 scores of every head
    over the group's rows, one zero row of v; each slot one head of v's N
    rows."""
    Np = -(-N // 16) * 16
    rows = min(16 * tiles, N)
    ldq = heads * d + 8
    lds = max(-(-N // 4) * 4, Np // 2)
    lds += 4 if lds % 8 == 0 else 0
    ldv = dv + (8 if (dv // 8) % 2 == 0 else 16)
    return HEADER_BYTES + (rows + N) * ldq * 2 + heads * rows * lds * 4 + ldv * 2, N * ldv * 2


@functools.lru_cache(maxsize=256)
def plan(B: int, N: int, heads: int, d: int, dv: int, sms: int = H100_SMS) -> Plan | None:
    """The plan on a card of ``sms`` SMs, as ``plan`` in ``csrc/attn4d.cu``
    (which ``kernel_plan`` reads back on the card), or None when none fits a
    block's shared memory: the most query tiles a row group (all of them
    when they fit) that leave room for a v ring of two slots, else one tile
    and one slot; the deepest ring of up to ``MAX_SLOTS`` that fits; as many
    blocks as the SMs hold with every block taking the same number of
    images, give or take one."""
    for tiles in range(-(-N // 16), 0, -1):
        base, slot = layout_bytes(N, heads, d, dv, tiles)
        slots = min((MAX_SMEM_BYTES - base) // slot, MAX_SLOTS) if base <= MAX_SMEM_BYTES else 0
        if slots >= 2 or (tiles == 1 and slots == 1):
            images = -(-B // min(B, sms))
            return Plan(-(-B // images), images, tiles, slots, base + slots * slot)
    return None


def kernel_plan(B: int, N: int, heads: int, d: int, dv: int, sms: int) -> Plan | None:
    """The plan the built kernel computes for the shape (card only), to hold
    ``plan`` to it."""
    out = (ctypes.c_int * 5)()
    if build.library().dfd_attn4d_plan(B, N, heads, d, dv, sms, out) != 0:
        return None
    return Plan(*out)


def _mix(t: torch.Tensor, table: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """sum_h table[h, g] * t[:, h] + bias[g]: t [B, h, N, M] -> [B, g, N, M]."""
    return torch.einsum("bhnm,hg->bgnm", t, table) + bias[None, :, None, None]


def attn4d_plain(q, k, v, bias, th1, th1_b, th2, th2_b, *, num_heads: int,
                 scale: float, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """q, k [B, N, h*d]; v [B, N, h*dv]; bias [h, N, N]; th1, th2 [h, h]
    (flax [h_in, g_out]); th1_b, th2_b [h] -> [B, N, h*dv] in ``out_dtype``
    (q's dtype by default; float32 keeps the f32 accumulation unrounded, as
    the JAX model's XLA branch does)."""
    dtype, acc = q.dtype, _acc(q.dtype)
    qh, kh, vh = (_heads(t, num_heads).to(acc) for t in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * scale + bias.to(acc)
    s = _mix(s, th1.to(acc), th1_b.to(acc))
    e = (s - s.amax(dim=-1, keepdim=True)).exp()
    p = e / e.sum(dim=-1, keepdim=True)
    p2 = _mix(p, th2.to(acc), th2_b.to(acc)).to(dtype)
    return _merge((p2.to(acc) @ vh).to(out_dtype or dtype))


def _check(q, k, v, bias, th1, th1_b, th2, th2_b, num_heads: int) -> tuple[int, ...]:
    """(B, N, d, dv) of inputs the kernel takes; raises on anything else."""
    name = "attn4d"
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.dim() != 3 or t.dtype != torch.bfloat16 or t.stride(2) != 1:
            raise ValueError(
                f"{name}: {what} must be bf16 [B, N, C] with a unit stride along features, got "
                f"{tuple(t.shape)} {t.dtype} strides {t.stride()}"
            )
    B, N, Cq = q.shape
    h = num_heads
    if k.shape != q.shape or v.shape[:2] != (B, N) or Cq % h or v.shape[2] % h:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not split into {h} heads of one [B, N]")
    d, dv = Cq // h, v.shape[2] // h
    if not (1 <= N <= MAX_TOKENS and 1 <= h <= MAX_HEADS and d % 16 == 0 and dv % 8 == 0):
        raise ValueError(
            f"{name}: the kernel takes N <= {MAX_TOKENS}, heads <= {MAX_HEADS}, head_dim % 16 "
            f"== 0 and value dim % 8 == 0, got N={N}, heads={h}, d={d}, dv={dv}"
        )
    for t, what, shape in ((bias, "bias", (h, N, N)), (th1, "th1", (h, h)), (th2, "th2", (h, h)),
                           (th1_b, "th1_b", (h,)), (th2_b, "th2_b", (h,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous f32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if any(t.device != q.device for t in (k, v, bias, th1, th1_b, th2, th2_b)):
        raise ValueError(f"{name}: inputs on different devices")
    return B, N, d, dv


def _launch_plan(q: torch.Tensor, B: int, N: int, num_heads: int, d: int, dv: int) -> int:
    """The card's SM count, after checking that a plan fits there."""
    sms = sm_count(q.device)
    if plan(B, N, num_heads, d, dv, sms) is None:
        raise ValueError(f"attn4d: no plan fits a block's {MAX_SMEM_BYTES} bytes of shared memory "
                         f"at N={N}, heads={num_heads}, d={d}, dv={dv}")
    return sms


def _cuda(q, k, v, bias, th1, th1_b, th2, th2_b, num_heads: int, scale: float):
    """The operator's CUDA implementation: one launch of the kernel on the
    current stream, counted; raises when autograd would need a gradient."""
    args = (q, k, v, bias, th1, th1_b, th2, th2_b)
    B, N, d, dv = _check(*args, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise ValueError("attn4d: the kernel is inference-only (no backward); run it under "
                         "torch.no_grad()")
    sms = _launch_plan(q, B, N, num_heads, d, dv)
    out = torch.empty(B, N, num_heads * dv, dtype=torch.bfloat16, device=q.device)
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    vec = int(all(s % 8 == 0 for s in strides) and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dfd_attn4d(*(t.data_ptr() for t in args), out.data_ptr(), B, N, num_heads, d,
                            dv, *strides, sms, float(scale), vec, stream)
    build.check(rc, "attn4d")
    attn4d.launches += 1
    return out


def _cpu(q, k, v, bias, th1, th1_b, th2, th2_b, num_heads: int, scale: float):
    _check(q, k, v, bias, th1, th1_b, th2, th2_b, num_heads)
    return attn4d_plain(q, k, v, bias, th1, th1_b, th2, th2_b, num_heads=num_heads, scale=scale)


def _fake(q, k, v, bias, th1, th1_b, th2, th2_b, num_heads: int, scale: float):
    """The output's shape for tracers, after the checks the launch makes."""
    B, N, d, dv = _check(q, k, v, bias, th1, th1_b, th2, th2_b, num_heads)
    if q.device.type == "cuda":
        _launch_plan(q, B, N, num_heads, d, dv)
    return q.new_empty((B, N, num_heads * dv))


_op = build.define_op(
    "attn4d(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor th1, Tensor th1_b, Tensor th2, "
    "Tensor th2_b, int num_heads, float scale) -> Tensor",
    cuda=_cuda, cpu=_cpu, fake=_fake,
)


def attn4d(q, k, v, bias, th1, th1_b, th2, th2_b, *, num_heads: int,
           scale: float) -> torch.Tensor:
    """K7 (see ``attn4d_plain``) on bf16 q, k, v with a unit stride along
    features and f32 tables, through the operator ``torch.ops.dfd.attn4d``:
    it launches the CUDA kernel on the current stream for CUDA tensors and
    runs the plain version for CPU tensors; any other device raises here,
    and the card raises when autograd would need a gradient (the kernel has
    none)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attn4d: unsupported device {q.device}")
    return _op(q, k, v, bias, th1, th1_b, th2, th2_b, num_heads, scale)


attn4d.launches = 0
