"""K6: FasterViT's fused attention sub-block (qkv Linear -> multi-head
attention with a per-head bias -> proj Linear), forward and backward.

Port of ``deepfakedetection_tpu/ops/pallas/attn_block.py`` (``_fwd_call``,
``_bwd_call`` and their custom_vjp ``attn_subblock``) together with its
wrapper ``window_attn_subblock`` (``deepfakedetection_tpu/ops/attention.py``).
The CUDA kernels are ``csrc/attn_block.cu`` (forward: a cluster of two
blocks of several whole windows each, the weights streamed by TMA multicast
through a ring of shared-memory tiles into ``wgmma`` products, qkv and the
probabilities kept on chip, ctx through a scratch into a ``wgmma``
projection; its launch plan is ``fwd_plan``) and
``csrc/attn_block_bwd.cu`` (backward: the same recompute for one head group
of several windows a block, the attention backward on chip, and
``csrc/gemm_tma.cuh``'s TMA-ring ``wgmma`` GEMM for dctx, dx and the weight
gradients, the weights read in their stored layout; every cross-block sum in
a fixed order; its launch plan is ``bwd_plan``). Neither pads N: the kernels mask their own
ragged edge, where the JAX wrapper pads rows to 16 and puts -1e9 on the
padded keys.

Layouts are the port's: x [B, N, C] (windows, tokens, channels); ``wqkv``
[3C, C] and ``wproj`` [C, C] as ``nn.Linear`` stores them ([out, in], qkv
features ordered [3, h, d]); ``bqkv`` [3C], ``bproj`` [C]; ``bias`` [h, N, N]
f32. The weights come as f32 parameters (or their cached bf16 casts at eval)
and are rounded to bf16 inside; the biases join each product in f32 before
its one rounding, as the JAX kernel adds its f32 biases.

``attn_subblock_plain`` and ``attn_subblock_bwd_plain`` are the same
functions in PyTorch ops with the same rounding points (the attention's are
``window_attention_plain``'s and ``window_attention_bwd_plain``'s); in
float64 every step stays float64, so the backward can be held against
autograd. The wrappers run them for CPU tensors; the tests and
``chip_smoke.py`` hold the kernels against them. For a CUDA tensor a wrapper
launches the kernel or raises. The forward goes through the operator
``torch.ops.dfd.attn_subblock`` (``build.define_op``); the backward is not an
operator yet.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import torch

from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops.window_attn import (
    MAX_SMEM_BYTES,
    _acc,
    window_attention_bwd_plain,
    window_attention_plain,
)

MAX_TOKENS = 128  # N and head_dim the kernels take
MAX_HEAD_DIM = 128
_SMS = 132  # an H100 SXM's streaming multiprocessors
_GEMM_TILE = 128  # csrc/gemm_tma.cuh's output tile


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [..., in] times w [out, in] rounded to ``dtype``, summed in the
    accumulation type, plus b there, rounded once to ``dtype``."""
    acc = _acc(dtype)
    return (x.to(acc) @ w.to(dtype).to(acc).t() + b.to(acc)).to(dtype)


def attn_subblock_plain(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, bias: torch.Tensor,
    wproj: torch.Tensor, bproj: torch.Tensor, *, num_heads: int, scale: float,
) -> torch.Tensor:
    """x [B, N, C] -> [B, N, C] in x's dtype: qkv = x Wqkv^T + bqkv (one
    rounding), per head softmax((q k^T) * scale + bias) v (one rounding of
    the probabilities and of ctx), out = ctx Wproj^T + bproj (one rounding)."""
    qkv = _dense(x, wqkv, bqkv, x.dtype)
    ctx = window_attention_plain(qkv, bias, num_heads=num_heads, scale=scale)
    return _dense(ctx, wproj, bproj, x.dtype)


def attn_subblock_bwd_plain(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, bias: torch.Tensor,
    wproj: torch.Tensor, dout: torch.Tensor, *, num_heads: int, scale: float,
) -> tuple[torch.Tensor, ...]:
    """The gradients of ``attn_subblock_plain`` for the output gradient
    ``dout``, as ``_bwd_kernel`` computes them: (dx in x's dtype, dWqkv,
    dbqkv, dbias, dWproj, dbproj in the accumulation type, summed over every
    window). ctx and the probabilities are recomputed; dctx = dout Wproj
    and dx = dqkv Wqkv are rounded once to x's dtype, dqkv is the attention
    backward's (``window_attention_bwd_plain``)."""
    dtype, acc = x.dtype, _acc(x.dtype)
    C = x.shape[-1]
    qkv = _dense(x, wqkv, bqkv, dtype)
    ctx = window_attention_plain(qkv, bias, num_heads=num_heads, scale=scale)
    do = dout.to(dtype).to(acc).reshape(-1, C)
    dctx = (do @ wproj.to(dtype).to(acc)).to(dtype).reshape(x.shape)
    dqkv, dbias = window_attention_bwd_plain(qkv, bias, dctx, num_heads=num_heads, scale=scale)
    g = dqkv.to(acc).reshape(-1, 3 * C)
    dx = (g @ wqkv.to(dtype).to(acc)).to(dtype).reshape(x.shape)
    return (dx, g.t() @ x.to(acc).reshape(-1, C), g.sum(0), dbias,
            do.t() @ ctx.to(acc).reshape(-1, C), do.sum(0))


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


_CLUSTER = 2  # forward blocks that share each weight tile (TMA multicast)
_MAX_ROWS = 128  # a forward block's rows: two warpgroups of 64
_RING_ROW_BYTES = 128  # one ring row: 64 bf16 input columns
_ALIGN = 1024  # the ring's alignment, the 128-byte swizzle's period
_MAX_STAGES = 8
_UNITS = (192, 144, 128, 64, 48, 32)  # the forward's wgmma widths, widest first


def _slots(Mx: int) -> int:
    """Units of weight rows a ring stage holds: one when a block's Mx rows make
    two 64-row warpgroup tiles, else two (one a warpgroup)."""
    return 1 if Mx > 64 else 2


def _x_smem_bytes(Mx: int, Cp: int) -> int:
    """x staged for ``wgmma``: Mx packed rows in 64-column blocks of pad8(Mx)
    128-byte rows, then room for the rest of the last warpgroup tile."""
    Mr = -(-Mx // 8) * 8
    return (-(-Cp // 64) * Mr + 64 * (3 - _slots(Mx)) - Mr) * _RING_ROW_BYTES


def fwd_smem_bytes(N: int, Cp: int, Dp: int, G: int, HG: int, NT: int, KB: int,
                   stages: int, staged: int) -> int:
    """Shared memory of one forward block (``csrc/attn_block.cu``
    ``fwd_smem_bytes``) for G windows of N tokens, heads in groups of HG and a
    ring of ``stages`` stages, each KB tiles of NT weight rows by 64 columns
    (two such chunks a tile when the block's G N rows make one warpgroup row
    group): alignment slack, the ring and its barriers, x (its G N rows
    packed, in 64-column blocks of pad8(G N) 128-byte rows, then room for the
    rest of the last 64-row warpgroup tile), one head group's q, k and v
    (G pad16(N) rows), its f32 qkv bias and, when ``staged``, its f32 bias
    tables."""
    return (_ALIGN + stages * KB * _slots(G * N) * NT * _RING_ROW_BYTES + 2 * stages * 8
            + _x_smem_bytes(G * N, Cp) + HG * 3 * G * _pad16(N) * (Dp + 8) * 2
            + -(-3 * HG * Dp // 4) * 16 + (-(-HG * N * N // 4) * 16 if staged else 0))


def _rows_per_weight_read(G: int, N: int) -> int:
    """Rows each weight tile read from L2 is multiplied against: a cluster's
    blocks' wgmma rows (64 a warpgroup row group, a block's G windows' N
    token rows packed in them)."""
    return _CLUSTER * 64 * -(-G * N // 64)


class FwdPlan(NamedTuple):
    """The forward's launch plan (``csrc/attn_block.cu`` ``fwd_plan``)."""

    windows: int  # G, whole windows a block
    heads: int  # HG, heads whose q, k, v a block holds at once
    chunk: int  # NT, weight rows (output features) a wgmma takes
    kblocks: int  # KB, 64-column weight tiles a ring stage holds
    stages: int  # the weight ring's depth
    staged: int  # 1: each head group's bias tables staged in shared memory
    smem: int  # shared memory of a block, bytes
    blocks: int  # blocks launched: the window groups, rounded up to clusters

    def rows_per_weight_read(self, N: int) -> int:
        return _rows_per_weight_read(self.windows, N)


@functools.cache
def fwd_plan(B: int, N: int, C: int, heads: int) -> FwdPlan | None:
    """The forward's plan, as ``fwd_plan`` in ``csrc/attn_block.cu`` (which
    ``kernel_plan`` reads back on the card), or None when no plan fits a
    block's shared memory: G the most windows whose N-token rows fit 128, but
    no more than a cluster needs for 128 rows at a 16-row stride a window or
    the card for about two blocks a SM; then the first that fits, with a ring
    of four stages, else three, else two: NT the widest of 192, 144, 128, 64
    and 48 that cuts the group's 3 HG Dp product columns into whole units, an
    even count where a stage holds two (32 last, wasting), HG from the least
    that gives each of the 8 consumer warps an attention item down to 1, the
    bias tables staged in shared memory, else read from L2, KB 2 where that
    leaves four stages or more, else 1, and as many stages as fit, up to 8."""
    Cp, Dp = _pad16(C), _pad16(C // heads)
    kt = _pad16(N) // 16
    G = min(_MAX_ROWS // N, max(-(-64 // _pad16(N)), -(-B // (2 * _SMS))), B)
    for G in range(G, 0, -1):
        target = min(-(-8 // (G * kt)), heads)
        for need, NT in itertools.product((4, 3, 2), _UNITS):
            for HG in range(target, 0, -1):
                if not _whole_units(G * N, HG, Dp, NT):
                    continue
                for staged, KB in itertools.product((1, 0), (2, 1)):
                    least = max(need, 4) if KB == 2 else need
                    for stages in range(_MAX_STAGES, least - 1, -1):
                        smem = fwd_smem_bytes(N, Cp, Dp, G, HG, NT, KB, stages, staged)
                        if smem <= MAX_SMEM_BYTES:
                            return FwdPlan(G, HG, NT, KB, stages, staged, smem, _blocks(B, G))
    return None


def _whole_units(Mx: int, HG: int, Dp: int, NT: int) -> bool:
    """Whether NT-row units cut a head group's 3 HG Dp product columns
    whole, an even count where a stage holds two (NT 32 may waste, as the
    last resort)."""
    units, rest = divmod(3 * HG * Dp, NT)
    return NT == 32 or not (rest or (_slots(Mx) == 2 and units % 2))


def _blocks(B: int, G: int) -> int:
    """Blocks over B windows in groups of G, rounded up to whole clusters."""
    return -(-(-(-B // G)) // _CLUSTER) * _CLUSTER


def kernel_plan(B: int, N: int, C: int, heads: int) -> FwdPlan | None:
    """The plan the built kernel computes for the shape (card only), to hold
    ``fwd_plan`` to it."""
    import ctypes

    plan = (ctypes.c_int * 8)()
    if build.library().dfd_attn_subblock_plan(B, N, C, heads, plan) != 0:
        return None
    return FwdPlan(*plan)


def bwd_smem_bytes(N: int, Cp: int, Dp: int, G: int, HG: int, NT: int, stages: int,
                   staged: int) -> int:
    """Shared memory of one backward window block (``csrc/attn_block_bwd.cuh``
    ``bwd_smem_bytes``) for G windows of N tokens and one group of HG heads:
    alignment slack; the weight ring (one 64-column tile of each slot's NT
    rows a stage) and x, or what takes their place after the products, the
    larger: bf16 p and ds of each (window, head), the group's dctx columns
    and, when ``staged``, its f32 bias tables; the group's q, k and v; its
    f32 qkv bias; the barriers."""
    Np = _pad16(N)
    ring_x = stages * _slots(G * N) * NT * _RING_ROW_BYTES + _x_smem_bytes(G * N, Cp)
    after = (G * HG * 2 * Np * (Np + 8) * 2 + HG * G * Np * (Dp + 8) * 2
             + (-(-HG * N * N // 4) * 16 if staged else 0))
    return (_ALIGN + max(ring_x, after) + HG * 3 * G * Np * (Dp + 8) * 2
            + -(-3 * HG * Dp // 4) * 16 + 2 * stages * 8)


class BwdPlan(NamedTuple):
    """The backward window kernel's launch plan (``csrc/attn_block_bwd.cu``
    ``bwd_plan``)."""

    windows: int  # G, whole windows a block
    heads: int  # HG, the heads of a block (its head group)
    chunk: int  # NT, weight rows (output features) a wgmma takes
    stages: int  # the weight ring's depth, one 64-column tile a stage
    staged: int  # 1: the head group's bias tables staged in shared memory
    smem: int  # shared memory of a block, bytes
    blocks: int  # window blocks: the window groups, rounded up to clusters
    head_groups: int  # the grid's second dimension

    def rows_per_weight_read(self, N: int) -> int:
        return _rows_per_weight_read(self.windows, N)


@functools.cache
def bwd_plan(B: int, N: int, C: int, heads: int) -> BwdPlan | None:
    """The backward's plan, as ``bwd_plan`` in ``csrc/attn_block_bwd.cu``
    (which ``kernel_bwd_plan`` reads back on the card), or None when no plan
    fits a block's shared memory: G the most windows whose rows fill one 64-row
    warpgroup tile at a 16-row stride a window, at most 128 / N and B; HG's
    target the least that gives each of the 8 consumer warps a row-pass item
    (G HG kt >= 8), at most the heads; then the first that fits, with a ring
    of three stages, else two: HG from the target down to 1, NT the widest of
    192, 144, 128, 64 and 48 that cuts the group's 3 HG Dp columns into whole
    units (32 last, wasting), the bias tables staged, else read from L2, and
    as many stages as fit, up to 8; else the same with one window fewer."""
    Cp, Dp = _pad16(C), _pad16(C // heads)
    kt = _pad16(N) // 16
    for G in range(min(-(-64 // _pad16(N)), _MAX_ROWS // N, B), 0, -1):
        target = min(-(-8 // (G * kt)), heads)
        for need, HG, NT in itertools.product((3, 2), range(target, 0, -1), _UNITS):
            if not _whole_units(G * N, HG, Dp, NT):
                continue
            for staged, stages in itertools.product((1, 0), range(_MAX_STAGES, need - 1, -1)):
                smem = bwd_smem_bytes(N, Cp, Dp, G, HG, NT, stages, staged)
                if smem <= MAX_SMEM_BYTES:
                    return BwdPlan(G, HG, NT, stages, staged, smem, _blocks(B, G), -(-heads // HG))
    return None


def kernel_bwd_plan(B: int, N: int, C: int, heads: int) -> BwdPlan | None:
    """The backward plan the built kernel computes for the shape (card only),
    to hold ``bwd_plan`` to it."""
    import ctypes

    plan = (ctypes.c_int * 8)()
    if build.library().dfd_attn_subblock_bwd_plan(B, N, C, heads, plan) != 0:
        return None
    return BwdPlan(*plan)


def wgrad_splits(M: int, C: int, heads: int) -> int:
    """Row chunks of the two weight-gradient products (dqkv^T x and dout^T
    ctx over M rows): about one 128 x 128 output tile a SM, chunks of at least
    512 rows."""
    n_tiles = -(-C // _GEMM_TILE)
    tiles = -(-3 * heads * _pad16(C // heads) // _GEMM_TILE) * n_tiles + n_tiles * n_tiles
    return max(1, min(-(-M // 512), -(-_SMS // tiles)))


def _check(name: str, x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
           bias: torch.Tensor, wproj: torch.Tensor, num_heads: int, smem: int) -> tuple[int, ...]:
    """(B, N, C, d) of a bf16 x [B, N, C] with its weights and bias; raises
    on anything the kernels do not take."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: x must be bf16 [B, N, C], got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    if C % num_heads:
        raise ValueError(f"{name}: C={C} is not a multiple of num_heads={num_heads}")
    d = C // num_heads
    for label, t, shape in (("wqkv", wqkv, (3 * C, C)), ("bqkv", bqkv, (3 * C,)),
                            ("wproj", wproj, (C, C))):
        if t.shape != shape or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: {label} must be f32 or bf16 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if bias.shape != (num_heads, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be f32 {(num_heads, N, N)}, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if any(t.device != x.device for t in (wqkv, bqkv, bias, wproj)):
        raise ValueError(f"{name}: x, the weights and the bias must share one device")
    if not (1 <= N <= MAX_TOKENS and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"{name}: the kernel takes 1 <= N <= {MAX_TOKENS} tokens and "
                         f"head_dim <= {MAX_HEAD_DIM}, got N={N}, head_dim={d}")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: N={N}, C={C}, head_dim={d} needs {smem} bytes of shared "
                         f"memory a block, more than the {MAX_SMEM_BYTES} an H100 block has")
    return B, N, C, d


def _qkv_operands(wqkv: torch.Tensor, bqkv: torch.Tensor, h: int, d: int,
                  C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Wqkv in bf16 laid out [3, h, Dp, Cp] and bqkv in f32 [3, h, Dp], zero
    past d and C: the Linear's own tensors when d and C are multiples of 16."""
    Dp, Cp = _pad16(d), _pad16(C)
    w, b = wqkv.to(torch.bfloat16), bqkv.float()
    if (Dp, Cp) == (d, C):
        return w.contiguous(), b.contiguous()
    wp = w.new_zeros(3, h, Dp, Cp)
    wp[:, :, :d, :C] = w.view(3, h, d, C)
    bp = b.new_zeros(3, h, Dp)
    bp[:, :, :d] = b.view(3, h, d)
    return wp, bp


def _proj_operand(wproj: torch.Tensor, C: int) -> torch.Tensor:
    """Wproj in bf16 [Cp, Cp], zero past C."""
    w, Cp = wproj.to(torch.bfloat16), _pad16(C)
    if Cp == C:
        return w.contiguous()
    wp = w.new_zeros(Cp, Cp)
    wp[:C, :C] = w
    return wp


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _tma_rows(t: torch.Tensor, C: int) -> tuple[torch.Tensor, int]:
    """A contiguous [..., C] bf16 tensor as TMA reads it, with its row stride:
    itself where C % 8 == 0 and it is 16-byte aligned, else a copy with rows
    padded to a multiple of 16 (odd sizes only; FasterViT's C are
    multiples of 16)."""
    if C % 8 == 0 and _aligned(t):
        return t, C
    Cp = _pad16(C)
    return torch.nn.functional.pad(t, (0, Cp - C)), Cp


def _forward_check(x, wqkv, bqkv, bias, wproj, bproj, num_heads: int) -> tuple[int, ...]:
    """(B, N, C, d) of the forward's inputs; raises on anything the kernel
    does not take."""
    name = "attn_subblock"
    # plain ints for the cached plan search (a tracer's sizes are symbols)
    B, N, C = map(int, x.shape) if x.dim() == 3 else (0, 0, 0)
    h = max(num_heads, 1)
    plan = fwd_plan(max(B, 1), N, C, h) if 1 <= N <= MAX_TOKENS else None
    # a shape no plan fits reports the least any plan needs
    smem = plan.smem if plan else fwd_smem_bytes(N, _pad16(C), _pad16(C // h), 1, 1, 32, 1, 2, 0)
    B, N, C, d = _check(name, x, wqkv, bqkv, bias, wproj, num_heads, smem)
    if bproj.shape != (C,) or bproj.device != x.device:
        raise ValueError(f"{name}: bproj must be [{C}] on {x.device}, got {tuple(bproj.shape)}")
    return B, N, C, d


def _fwd_cuda(x, wqkv, bqkv, bias, wproj, bproj, num_heads: int, scale: float) -> torch.Tensor:
    """``dfd::attn_subblock``'s CUDA implementation: the operands in the
    kernel's layouts, then one launch (two kernels) on the current stream,
    counted."""
    B, N, C, d = _forward_check(x, wqkv, bqkv, bias, wproj, bproj, num_heads)
    x, bias = x.contiguous(), bias.contiguous()
    wq, bq = _qkv_operands(wqkv, bqkv, num_heads, d, C)
    wp, bp = _proj_operand(wproj, C), bproj.float().contiguous()
    # the weights are read by TMA, which needs 16-byte aligned rows and bases
    wq, wp = (w if _aligned(w) else w.clone() for w in (wq, wp))
    out = torch.empty(B, N, C, dtype=torch.bfloat16, device=x.device)
    ctx = torch.empty(B * N, _pad16(C), dtype=torch.bfloat16, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dfd_attn_subblock(
            x.data_ptr(), wq.data_ptr(), bq.data_ptr(), bias.data_ptr(), wp.data_ptr(),
            bp.data_ptr(), out.data_ptr(), ctx.data_ptr(), B, N, C, num_heads, float(scale),
            int(C % 8 == 0 and _aligned(x)), stream,
        )
    build.check(rc, "attn_subblock")
    attn_subblock.launches += 1
    return out


def _fwd_cpu(x, wqkv, bqkv, bias, wproj, bproj, num_heads: int, scale: float) -> torch.Tensor:
    _forward_check(x, wqkv, bqkv, bias, wproj, bproj, num_heads)
    return attn_subblock_plain(x, wqkv, bqkv, bias, wproj, bproj, num_heads=num_heads,
                               scale=scale)


def _fwd_fake(x, wqkv, bqkv, bias, wproj, bproj, num_heads: int, scale: float) -> torch.Tensor:
    """The output's shape for tracers, after the checks the launch makes."""
    B, N, C, _ = _forward_check(x, wqkv, bqkv, bias, wproj, bproj, num_heads)
    return x.new_empty((B, N, C))


_forward = build.define_op(
    "attn_subblock(Tensor x, Tensor wqkv, Tensor bqkv, Tensor bias, Tensor wproj, "
    "Tensor bproj, int num_heads, float scale) -> Tensor",
    cuda=_fwd_cuda, cpu=_fwd_cpu, fake=_fwd_fake,
)
"""The K6 forward without autograd, ``torch.ops.dfd.attn_subblock``: the
kernel for a CUDA tensor, the plain version for a CPU one."""


def attn_subblock_bwd(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, bias: torch.Tensor,
    wproj: torch.Tensor, dout: torch.Tensor, *, num_heads: int, scale: float,
    need_dx: bool = True,
) -> tuple[torch.Tensor | None, ...]:
    """K6 backward (see ``attn_subblock_bwd_plain``): (dx bf16 or None when
    not ``need_dx``, dWqkv [3C, C], dbqkv [3C], dbias [h, N, N], dWproj
    [C, C], dbproj [C], all f32). Launches the CUDA kernels on the current
    stream for CUDA tensors (dx's product skipped without ``need_dx``), runs
    the plain version for CPU tensors, raises otherwise."""
    name = "attn_subblock_bwd"
    B, N, C = x.shape if x.dim() == 3 else (0, 0, 0)
    h = max(num_heads, 1)
    plan = bwd_plan(max(B, 1), N, C, h) if 1 <= N <= MAX_TOKENS and C >= h else None
    # a shape no plan fits reports the least any plan needs
    smem = plan.smem if plan else bwd_smem_bytes(N, _pad16(C), _pad16(C // h), 1, 1, 32, 2, 0)
    B, N, C, d = _check(name, x, wqkv, bqkv, bias, wproj, num_heads, smem)
    if dout.shape != (B, N, C) or dout.dtype != torch.bfloat16 or dout.device != x.device:
        raise ValueError(f"{name}: dout must be bf16 {(B, N, C)} on {x.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    if x.device.type == "cpu":
        grads = attn_subblock_bwd_plain(x, wqkv, bqkv, bias, wproj, dout, num_heads=num_heads,
                                        scale=scale)
        return (grads[0] if need_dx else None, *grads[1:])
    bias = bias.contiguous()
    (x, ldx), (dout, ldo) = _tma_rows(x.contiguous(), C), _tma_rows(dout.contiguous(), C)
    wq, bq = _qkv_operands(wqkv, bqkv, num_heads, d, C)
    wp = _proj_operand(wproj, C)
    # the weights are read by TMA, which needs 16-byte aligned rows and bases
    wq, wp = (w if _aligned(w) else w.clone() for w in (wq, wp))
    dev = x.device
    Cp, Dp, M = _pad16(C), _pad16(d), B * N
    splits = wgrad_splits(M, C, num_heads)
    plane = 4 * C * C + 4 * C  # dWqkv, dbqkv, dWproj, dbproj
    # the kernels' scratch, one allocation: dctx and ctx [M, Cp] bf16, dqkv
    # [M, 3 h Dp] bf16 (wqkv's padded row layout), the windows' dbias
    # partials [B, h, N, N] and the row chunks' weight-gradient partials
    # [splits, plane] f32 (none with one chunk)
    sizes = (M * Cp * 2, M * Cp * 2, M * 3 * num_heads * Dp * 2, B * num_heads * N * N * 4,
             splits * plane * 4 if splits > 1 else 0)
    offsets = list(itertools.accumulate((-(-n // 256) * 256 for n in sizes), initial=0))
    scratch = torch.empty(offsets[-1], dtype=torch.uint8, device=dev)
    if Dp != d:  # dqkv's padding columns must be zero for dx
        scratch[offsets[2]:offsets[3]].zero_()
    dctx, ctx, dqkv, dbias_part, wpart = (scratch.data_ptr() + o for o in offsets[:5])
    out = torch.empty(plane + num_heads * N * N, dtype=torch.float32, device=dev)
    dx = torch.empty(B, N, C, dtype=torch.bfloat16, device=dev) if need_dx else None
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dfd_attn_subblock_bwd(
            x.data_ptr(), ldx, wq.data_ptr(), bq.data_ptr(), bias.data_ptr(), wp.data_ptr(),
            dout.data_ptr(), ldo, dctx, ctx, dqkv, dbias_part, wpart,
            None if dx is None else dx.data_ptr(), out.data_ptr() + plane * 4, out.data_ptr(), B,
            N, C, num_heads, splits, float(scale), stream,
        )
    build.check(rc, name)
    attn_subblock_bwd.launches += 1
    q, p = 3 * C * C, 3 * C * C + 3 * C
    return (dx, out[:q].view(3 * C, C), out[q:p], out[plane:].view(num_heads, N, N),
            out[p:p + C * C].view(C, C), out[p + C * C:plane])


class AttnSubblock(torch.autograd.Function):
    """K6 with its gradient, the counterpart of the JAX package's
    ``attn_subblock`` custom_vjp: the forward saves (x, wqkv, bqkv, bias,
    wproj), the backward recomputes qkv, the probabilities and ctx from them
    in ``attn_subblock_bwd``. The weight and bias gradients come back in the
    parameters' own dtype (f32 for the Linears' parameters), never rounded to
    bf16."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, bias, wproj, bproj, num_heads: int, scale: float):
        ctx.save_for_backward(x, wqkv, bqkv, bias, wproj)
        ctx.num_heads, ctx.scale, ctx.bproj_dtype = num_heads, scale, bproj.dtype
        return _forward(x, wqkv, bqkv, bias, wproj, bproj, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        x, wqkv, bqkv, bias, wproj = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = attn_subblock_bwd(x, wqkv, bqkv, bias, wproj,
                                  dout.to(torch.bfloat16).contiguous(), num_heads=ctx.num_heads,
                                  scale=ctx.scale, need_dx=need[0])
        dtypes = (x.dtype, wqkv.dtype, bqkv.dtype, bias.dtype, wproj.dtype, ctx.bproj_dtype)
        return (*(g.to(t) if n and g is not None else None
                  for g, t, n in zip(grads, dtypes, need)), None, None)


def attn_subblock(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, bias: torch.Tensor,
    wproj: torch.Tensor, bproj: torch.Tensor, *, num_heads: int, scale: float,
) -> torch.Tensor:
    """K6 (see ``attn_subblock_plain``): x [B, N, C] bf16, the Linears'
    weights and biases in f32 (or bf16 weights), bias [h, N, N] f32 ->
    [B, N, C] bf16. Launches the CUDA kernel on the current stream for a CUDA
    tensor, runs the plain version for a CPU tensor, raises on any other
    device. While autograd records and any input requires grad it goes
    through ``AttnSubblock``, so the gradient reaches each."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wqkv, bqkv, bias, wproj,
                                                                 bproj)):
        return AttnSubblock.apply(x, wqkv, bqkv, bias, wproj, bproj, num_heads, scale)
    return _forward(x, wqkv, bqkv, bias, wproj, bproj, num_heads, scale)


attn_subblock.launches = 0
attn_subblock_bwd.launches = 0
