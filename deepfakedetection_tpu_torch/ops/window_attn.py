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
deterministically; its launch plan is ``bwd_plan``) for N <= ``MAX_TOKENS``,
and ``csrc/window_attn_long.cu`` (forward and backward, plans
``long_fwd_plan`` and ``long_bwd_plan``; only tiles in shared memory, so any
N) past ``MAX_TOKENS``, one wrapper call per pass, reading q, k and v through
strides: ``window_attention`` takes the natural qkv [B, N, 3C] layout (three
views of one tensor, no copy), ``window_attention_heads`` the v1 layout.
Neither pads N: the kernels mask their own ragged edge. A launch of the long
kernels counts on ``window_attention_long.launches`` and
``window_attention_long_bwd.launches``, not on the callers' counters.

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
raises. The forward goes through the operators ``torch.ops.dfd.window_attention``
and ``torch.ops.dfd.window_attention_heads`` (``build.define_op``), which
take q, k and v as the strided views they are; the backward is not an
operator yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops.expand_dw import sm_count

MAX_TOKENS = 128  # N the short kernels take; the long kernels take the rest
LONG_INT_TOKENS = 46340  # N the long kernels index with ints (N^2 < 2^31)
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
LONG_FWD_KERNELS = ("window_attention_long_kernel",)
LONG_BWD_KERNELS = ("window_attention_long_rows_kernel", "window_attention_long_cols_kernel",
                    "long_dbias_reduce_kernel")


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
    if not (1 <= N <= LONG_INT_TOKENS and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(
            f"{name}: the kernels take 1 <= N <= {LONG_INT_TOKENS} tokens and 1 <= head_dim <= "
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


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


LONG_ROWS = 64  # rows of a long kernel's query (key) group and of a step's tile
LONG_MAX_STAGES = 4  # the long kernels' deepest ring
SM_SMEM_BYTES = 233472  # shared memory of an H100 SM, for all its blocks
_BLOCK_RESERVE = 1024  # shared memory the card keeps for each block
_LONG_BAR_BYTES = 128  # a long kernel's mbarriers
_LONG_STATS = 4  # the row statistics the long backward keeps a row


def long_tile_bytes(d: int) -> int:
    """Bytes of one of the long kernels' [64][Dp + 8] bf16 tiles
    (``csrc/window_attn_long.cu`` ``tile_bytes``)."""
    return LONG_ROWS * (_pad16(d) + 8) * 2


def long_groups(N: int) -> int:
    """The groups of at most four 16-row tiles a window's rows are split into
    (``long_groups``)."""
    tiles = -(-N // 16)
    return -(-tiles // 4)


class Ring(NamedTuple):
    """A long kernel's ring (``csrc/window_attn_long.cu`` ``ring_plan``)."""

    stages: int  # shared-memory stages of the per-step tiles
    buffers: int  # item buffers: with two, the next item's rows load under this one
    per_sm: int  # blocks an SM
    smem: int  # bytes of dynamic shared memory a block


def long_ring(item: int, stage: int) -> Ring | None:
    """The ring of a kernel that keeps ``item`` bytes an item buffer and
    ``stage`` bytes a step, as ``ring_plan``: two blocks an SM where any ring
    fits them, two item buffers before one, then the most stages (2 to 4),
    or None."""
    for per_sm in (2, 1):
        for buffers in (2, 1):
            for stages in range(LONG_MAX_STAGES, 1, -1):
                smem = _LONG_BAR_BYTES + buffers * item + stages * stage
                if smem <= MAX_SMEM_BYTES and per_sm * (smem + _BLOCK_RESERVE) <= SM_SMEM_BYTES:
                    return Ring(stages, buffers, per_sm, smem)
    return None


def _long_sizes(B: int, N: int, heads: int, d: int) -> bool:
    return B >= 1 and heads >= 1 and 1 <= d <= MAX_HEAD_DIM and 1 <= N <= LONG_INT_TOKENS


def _group_tiles(N: int, groups: int, gi: int) -> range:
    kt = -(-N // 16)
    return range(gi * kt // groups, (gi + 1) * kt // groups)


class LongFwdPlan(NamedTuple):
    """The long forward's launch plan (``csrc/window_attn_long.cu``
    ``dfd_window_attention_long_plan``): persistent blocks over the items
    (window, head, query group), an even contiguous range each."""

    blocks: int
    groups: int  # query groups a window
    stages: int
    buffers: int
    smem: int

    def tiles(self, block: int, B: int, N: int, heads: int) -> list[tuple[int, int, int]]:
        """The (window, head, 16-row query tile) block ``block`` computes, in
        its order."""
        items = B * heads * self.groups
        out = []
        for it in range(block * items // self.blocks, (block + 1) * items // self.blocks):
            b, h = divmod(it // self.groups, heads)
            out += [(b, h, t) for t in _group_tiles(N, self.groups, it % self.groups)]
        return out


@functools.lru_cache(maxsize=256)
def long_fwd_plan(B: int, N: int, heads: int, d: int, sms: int = H100_SMS) -> LongFwdPlan | None:
    """The long forward's plan on a card of ``sms`` SMs, as the kernel's
    (``kernel_long_fwd_plan`` reads it back), or None when the shape is out of
    its range: ``long_ring`` of a q tile an item and k and v tiles a step, as
    many blocks as the ring's blocks an SM fill, at most one an item."""
    if not _long_sizes(B, N, heads, d):
        return None
    groups, nk = long_groups(N), -(-N // LONG_ROWS)
    items = B * heads * groups
    ring = long_ring(long_tile_bytes(d), 2 * long_tile_bytes(d))
    if ring is None or items * nk > 2**31 - 1:
        return None
    return LongFwdPlan(min(items, ring.per_sm * sms), groups, ring.stages, ring.buffers,
                       ring.smem)


class LongBwdPlan(NamedTuple):
    """The long backward's launch plan (``dfd_window_attention_long_bwd_plan``):
    the row and the column kernel each run heads x groups x parts blocks,
    block (head, group, part) owning the part's contiguous range of the
    windows."""

    parts: int  # blocks a (head, group)
    groups: int  # query (key) groups a window
    rows_stages: int
    rows_buffers: int
    rows_smem: int
    cols_stages: int
    cols_buffers: int
    cols_smem: int

    def blocks(self, heads: int) -> int:
        return heads * self.groups * self.parts

    def windows(self, B: int, part: int) -> range:
        """The windows, in the order it sums them, of a (head, group)'s part."""
        return range(part * B // self.parts, (part + 1) * B // self.parts)

    def tiles(self, block: int, B: int, N: int, heads: int) -> list[tuple[int, int, int]]:
        """The (window, head, 16-row tile) block ``block`` computes: query
        tiles in the row kernel, key tiles in the column kernel."""
        hg, part = divmod(block, self.parts)
        h, gi = divmod(hg, self.groups)
        return [(b, h, t) for b in self.windows(B, part)
                for t in _group_tiles(N, self.groups, gi)]


@functools.lru_cache(maxsize=256)
def long_bwd_plan(B: int, N: int, heads: int, d: int, sms: int = H100_SMS) -> LongBwdPlan | None:
    """The long backward's plan on a card of ``sms`` SMs, as the kernel's, or
    None when the shape is out of range: the row kernel's ring (q and do an
    item, k and v a step, two walks a window), the column kernel's (k and v
    an item; q, do and the row statistics a step), and as many parts as the
    fewer blocks an SM of the two fill for all heads and groups, at most one
    a window."""
    if not _long_sizes(B, N, heads, d):
        return None
    groups, nk, tile = long_groups(N), -(-N // LONG_ROWS), long_tile_bytes(d)
    rows = long_ring(2 * tile, 2 * tile)
    cols = long_ring(2 * tile, 2 * tile + _LONG_STATS * LONG_ROWS * 4)
    if rows is None or cols is None or max(heads * groups * B, B * 2 * nk) > 2**31 - 1:
        return None
    parts = max(1, min(B, min(rows.per_sm, cols.per_sm) * sms // (heads * groups)))
    return LongBwdPlan(parts, groups, *rows[:2], rows.smem, *cols[:2], cols.smem)


def long_stats_len(B: int, N: int, heads: int) -> int:
    """f32 elements of the long backward's row statistics, [B, h, 4, Np]
    with Np = N padded to 64."""
    return B * heads * _LONG_STATS * -(-N // LONG_ROWS) * LONG_ROWS


def kernel_long_fwd_plan(B: int, N: int, heads: int, d: int, sms: int) -> LongFwdPlan | None:
    """The plan the built long forward computes (card only)."""
    plan = (ctypes.c_int * 5)()
    if build.library().dfd_window_attention_long_plan(B, N, heads, d, sms, plan) != 0:
        return None
    return LongFwdPlan(*plan)


def kernel_long_bwd_plan(B: int, N: int, heads: int, d: int, sms: int) -> LongBwdPlan | None:
    """The plan the built long backward computes (card only)."""
    plan = (ctypes.c_int * 8)()
    if build.library().dfd_window_attention_long_bwd_plan(B, N, heads, d, sms, plan) != 0:
        return None
    return LongBwdPlan(*plan)


def _fwd_sms(name: str, device: torch.device, B: int, N: int, heads: int, d: int) -> int:
    """The card's SM count, after checking that a forward plan fits there."""
    sms = sm_count(device)
    if N > MAX_TOKENS:
        if long_fwd_plan(B, N, heads, d, sms) is None:
            raise ValueError(f"{name}: no long-kernel plan for B={B}, N={N}, heads={heads}, "
                             f"head_dim={d} (N past {LONG_INT_TOKENS} or too many items)")
    elif fwd_plan(B, N, heads, d, sms) is None:
        raise ValueError(
            f"{name}: N={N}, head_dim={d} needs {fwd_smem_bytes(N, d)} bytes of shared memory "
            f"a block, more than the {MAX_SMEM_BYTES} an H100 block has"
        )
    return sms


def _launch(name, q, k, v, bias, out, strides, B: int, N: int, heads: int, d: int,
            scale: float) -> bool:
    """One kernel launch: the long forward at N > ``MAX_TOKENS`` (counted
    there), else the short one (the caller counts it; returns True).
    ``strides`` holds the (batch, row, head) strides of q, k, v and out, in
    elements. Raises when no plan fits."""
    sms = _fwd_sms(name, q.device, B, N, heads, d)
    flat = [s for st in strides for s in st]
    vec = int(d % 8 == 0 and all(s % 8 == 0 for s in flat)
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    if N > MAX_TOKENS:
        window_attention_long(q, k, v, bias, out, flat, B, N, heads, d, sms, scale, vec)
        return False
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dfd_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, N, heads, d, *flat, sms, float(scale), vec, stream,
        )
    build.check(rc, name)
    return True


def window_attention_long(q, k, v, bias, out, flat_strides, B: int, N: int, heads: int, d: int,
                          sms: int, scale: float, vec: int) -> None:
    """One launch of the long forward kernel (``csrc/window_attn_long.cu``)
    on the current stream, counted: q, k, v and out as the short kernel's,
    ``flat_strides`` their (batch, row, head) strides in elements, ``sms``
    the card's SMs."""
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.dfd_window_attention_long(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, N, heads, d, *flat_strides, sms, float(scale), vec, stream,
        )
    build.check(rc, "window_attention_long")
    window_attention_long.launches += 1


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
    _check_sizes(name, N, d)
    _check_bias(name, bias, num_heads, N, qkv.device)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    return B, N, C, d


def _qkv_cuda(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
              scale: float) -> torch.Tensor:
    """``dfd::window_attention``'s CUDA implementation: one launch of the
    kernel on q, k and v as three views of qkv, counted."""
    B, N, C, d = _check_qkv("window_attention", qkv, bias, num_heads)
    out = torch.empty(B, N, C, dtype=torch.bfloat16, device=qkv.device)
    src = (qkv.stride(0), qkv.stride(1), d)
    if _launch("window_attention", qkv, qkv[..., C:], qkv[..., 2 * C:], bias, out,
               (src, src, src, (N * C, C, d)), B, N, num_heads, d, scale):
        window_attention.launches += 1
    return out


def _qkv_cpu(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
             scale: float) -> torch.Tensor:
    _check_qkv("window_attention", qkv, bias, num_heads)
    return window_attention_plain(qkv, bias, num_heads=num_heads, scale=scale)


def _qkv_fake(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
              scale: float) -> torch.Tensor:
    """The output's shape for tracers, after the checks the launch makes."""
    B, N, C, d = _check_qkv("window_attention", qkv, bias, num_heads)
    if qkv.device.type == "cuda":
        _fwd_sms("window_attention", qkv.device, B, N, num_heads, d)
    return qkv.new_empty((B, N, C))


_forward = build.define_op(
    "window_attention(Tensor qkv, Tensor bias, int num_heads, float scale) -> Tensor",
    cuda=_qkv_cuda, cpu=_qkv_cpu, fake=_qkv_fake,
)
"""The K5 forward without autograd, ``torch.ops.dfd.window_attention``: the
kernel for a CUDA tensor, the plain version for a CPU one."""


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
    CUDA tensors, the long ones at N > ``MAX_TOKENS`` (counted on
    ``window_attention_long_bwd.launches``), runs the plain version for CPU
    tensors, raises otherwise or when no plan fits (``bwd_plan``,
    ``long_bwd_plan``)."""
    name = "window_attention_bwd"
    B, N, C, d = _check_qkv(name, qkv, bias, num_heads)
    if (dout.shape != (B, N, C) or dout.dtype != torch.bfloat16 or dout.stride(2) != 1
            or dout.device != qkv.device):
        raise ValueError(
            f"{name}: dout must be bf16 {(B, N, C)} with a unit stride along features on "
            f"{qkv.device}, got {tuple(dout.shape)} {dout.dtype} strides {dout.stride()} on "
            f"{dout.device}"
        )
    long = N > MAX_TOKENS
    if long:
        if long_bwd_plan(B, N, num_heads, d) is None:
            raise ValueError(f"{name}: no long-kernel plan for B={B}, N={N}, heads={num_heads}, "
                             f"head_dim={d} (N past {LONG_INT_TOKENS} or too many windows)")
    elif bwd_plan(B, N, num_heads, d) is None:
        raise ValueError(
            f"{name}: N={N}, head_dim={d} needs {bwd_smem_bytes(N, d)} bytes of shared memory "
            f"a block, more than the {MAX_SMEM_BYTES} an H100 block has"
        )
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, bias, dout, num_heads=num_heads, scale=scale)
    sms = sm_count(qkv.device)
    dqkv = torch.empty(B, N, 3 * C, dtype=torch.bfloat16, device=qkv.device)
    dbias = torch.empty(num_heads, N, N, dtype=torch.float32, device=qkv.device)
    strides = (qkv.stride(0), qkv.stride(1), dout.stride(0), dout.stride(1))
    vec = int(d % 8 == 0 and all(s % 8 == 0 for s in strides)
              and all(t.data_ptr() % 16 == 0 for t in (qkv, dout, dqkv)))
    if long:
        window_attention_long_bwd(qkv, dout, bias, dqkv, dbias, strides, sms, scale, vec,
                                  num_heads)
        return dqkv, dbias
    plan = bwd_plan(B, N, num_heads, d, sms)
    partial = torch.empty(plan.blocks(num_heads), N, N, dtype=torch.float32, device=qkv.device)
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


def window_attention_long_bwd(qkv, dout, bias, dqkv, dbias, strides, sms: int, scale: float,
                              vec: int, num_heads: int) -> None:
    """One call of the long backward (``csrc/window_attn_long.cu``: its row
    and column kernels and the dbias sum) on the current stream, counted;
    called by ``window_attention_bwd`` at N > ``MAX_TOKENS`` with its checked
    inputs, its outputs, and the (qkv, dout) batch and row strides. Allocates
    the scratch: the partial dbias planes and the row statistics."""
    B, N, C3 = qkv.shape
    plan = long_bwd_plan(B, N, num_heads, C3 // 3 // num_heads, sms)
    partial = torch.empty(num_heads * plan.parts, N, N, dtype=torch.float32, device=qkv.device)
    stats = torch.empty(long_stats_len(B, N, num_heads), dtype=torch.float32, device=qkv.device)
    lib = build.library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.dfd_window_attention_long_bwd(
            qkv.data_ptr(), dout.data_ptr(), bias.data_ptr(), dqkv.data_ptr(),
            partial.data_ptr(), partial.shape[0], dbias.data_ptr(), stats.data_ptr(),
            stats.numel(), B, N, num_heads, C3 // 3 // num_heads, *strides, sms, float(scale),
            vec, stream,
        )
    build.check(rc, "window_attention_long_bwd")
    window_attention_long_bwd.launches += 1


def _check_heads(name: str, q, k, v, bias) -> tuple[int, int, int, int]:
    """(B, h, N, d) of bf16 [B, h, N, d] q, k, v with a unit stride along d
    and their [h, N, N] f32 bias; raises on anything else."""
    for t in (q, k, v):
        if t.dim() != 4 or t.dtype != torch.bfloat16 or t.stride(3) != 1 or t.shape != q.shape:
            raise ValueError(
                f"{name}: q, k, v must be bf16 [B, h, N, d] of one shape with a unit stride "
                f"along d, got {tuple(t.shape)} {t.dtype} strides {t.stride()}"
            )
        if t.device != q.device:
            raise ValueError(f"{name}: q, k, v on different devices")
    B, h, N, d = q.shape
    _check_sizes(name, N, d)
    _check_bias(name, bias, h, N, q.device)
    return B, h, N, d


def _heads_cuda(q, k, v, bias, scale: float) -> torch.Tensor:
    """``dfd::window_attention_heads``'s CUDA implementation: one launch,
    counted."""
    name = "window_attention_heads"
    B, h, N, d = _check_heads(name, q, k, v, bias)
    out = torch.empty(B, h, N, d, dtype=torch.bfloat16, device=q.device)
    strides = tuple((t.stride(0), t.stride(2), t.stride(1)) for t in (q, k, v, out))
    if _launch(name, q, k, v, bias, out, strides, B, N, h, d, scale):
        window_attention_heads.launches += 1
    return out


def _heads_cpu(q, k, v, bias, scale: float) -> torch.Tensor:
    _check_heads("window_attention_heads", q, k, v, bias)
    return window_attention_heads_plain(q, k, v, bias, scale=scale)


def _heads_fake(q, k, v, bias, scale: float) -> torch.Tensor:
    """The output's shape for tracers, after the checks the launch makes."""
    name = "window_attention_heads"
    B, h, N, d = _check_heads(name, q, k, v, bias)
    if q.device.type == "cuda":
        _fwd_sms(name, q.device, B, N, h, d)
    return q.new_empty((B, h, N, d))


_heads_op = build.define_op(
    "window_attention_heads(Tensor q, Tensor k, Tensor v, Tensor bias, float scale) -> Tensor",
    cuda=_heads_cuda, cpu=_heads_cpu, fake=_heads_fake,
)


def window_attention_heads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, *, scale: float
) -> torch.Tensor:
    """K5 on the v1 layout (see ``window_attention_heads_plain``): q, k, v
    [B, h, N, d] bf16 with a unit stride along d, through the operator
    ``torch.ops.dfd.window_attention_heads``: it launches the CUDA kernel for
    CUDA tensors and runs the plain version for CPU tensors; any other device
    raises here."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention_heads: unsupported device {q.device}")
    return _heads_op(q, k, v, bias, scale=scale)


window_attention.launches = 0
window_attention_heads.launches = 0
window_attention_bwd.launches = 0
window_attention_long.launches = 0
window_attention_long_bwd.launches = 0
