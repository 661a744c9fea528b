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
``csrc/attn_block_bwd.cu`` (backward: the per-window recompute and attention
backward, hand-written GEMMs for dctx, dx and the weight gradients, every
cross-block sum in a fixed order). Neither pads N: the kernels mask their own
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
launches the kernel or raises.
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
_SM_SMEM_BYTES = 233472  # shared memory of one H100 SM
_WGRAD_TILE = 64  # the weight-gradient kernel's output tile
# weight-gradient blocks per launch the row split aims at: four per SM
_WGRAD_TARGET_BLOCKS = 4 * _SMS


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
    Mx = G * N
    slots, groups, Mr = (1, 2, -(-Mx // 8) * 8) if Mx > 64 else (2, 1, -(-Mx // 8) * 8)
    x_bytes = (-(-Cp // 64) * Mr + 64 * groups - Mr) * _RING_ROW_BYTES
    return (_ALIGN + stages * KB * slots * NT * _RING_ROW_BYTES + 2 * stages * 8
            + x_bytes + HG * 3 * G * _pad16(N) * (Dp + 8) * 2 + -(-3 * HG * Dp // 4) * 16
            + (-(-HG * N * N // 4) * 16 if staged else 0))


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
        """Rows each weight tile read from L2 is multiplied against: a
        cluster's blocks' wgmma rows (64 a warpgroup row group, the windows'
        G N token rows packed in them)."""
        return _CLUSTER * 64 * -(-self.windows * N // 64)


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
                units, rest = divmod(3 * HG * Dp, NT)  # NT 32 may waste, as the last resort
                if NT != 32 and (rest or (G * N <= 64 and units % 2)):
                    continue  # whole units, and an even count where a stage holds two
                for staged, KB in itertools.product((1, 0), (2, 1)):
                    least = max(need, 4) if KB == 2 else need
                    for stages in range(_MAX_STAGES, least - 1, -1):
                        smem = fwd_smem_bytes(N, Cp, Dp, G, HG, NT, KB, stages, staged)
                        if smem <= MAX_SMEM_BYTES:
                            blocks = -(-(-(-B // G)) // _CLUSTER) * _CLUSTER
                            return FwdPlan(G, HG, NT, KB, stages, staged, smem, blocks)
    return None


def kernel_plan(B: int, N: int, C: int, heads: int) -> FwdPlan | None:
    """The plan the built kernel computes for the shape (card only), to hold
    ``fwd_plan`` to it."""
    import ctypes

    plan = (ctypes.c_int * 8)()
    if build.library().dfd_attn_subblock_plan(B, N, C, heads, plan) != 0:
        return None
    return FwdPlan(*plan)


def bwd_smem_bytes(N: int, C: int, d: int) -> int:
    """Shared memory of one backward window block (``csrc/attn_block_bwd.cu``
    ``bwd_smem_bytes``): the window's x, one head's q, k, v and dctx, bf16 p
    and ds."""
    Np, Cp, Dp = _pad16(N), _pad16(C), _pad16(d)
    return (Np * (Cp + 8) + 4 * Np * (Dp + 8) + 2 * Np * (Np + 8)) * 2


def bwd_windows_per_block(B: int, N: int, C: int, d: int) -> int:
    """Windows each backward window block loops over: as many as spread the
    B windows over one wave of the card's blocks (as many a SM as its shared
    memory holds), since each block writes a dbias partial."""
    per_sm = max(1, _SM_SMEM_BYTES // (bwd_smem_bytes(N, C, d) + 1024))
    return -(-B // (_SMS * per_sm))


def wgrad_splits(M: int, F: int, K: int) -> int:
    """Row chunks of the weight-gradient product G^T X (G [M, F], X [M, K]):
    enough 64x64-tile blocks for the card and chunks of at least 512 rows."""
    tiles = -(-F // _WGRAD_TILE) * -(-K // _WGRAD_TILE)
    return max(1, min(-(-M // 512), _WGRAD_TARGET_BLOCKS // tiles))


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


def _forward(x, wqkv, bqkv, bias, wproj, bproj, num_heads: int, scale: float) -> torch.Tensor:
    """The K6 forward without autograd: the kernel for a CUDA tensor, the
    plain version for a CPU one."""
    name = "attn_subblock"
    B, N, C = x.shape if x.dim() == 3 else (0, 0, 0)
    h = max(num_heads, 1)
    plan = fwd_plan(max(B, 1), N, C, h) if 1 <= N <= MAX_TOKENS else None
    # a shape no plan fits reports the least any plan needs
    smem = plan.smem if plan else fwd_smem_bytes(N, _pad16(C), _pad16(C // h), 1, 1, 32, 1, 2, 0)
    B, N, C, d = _check(name, x, wqkv, bqkv, bias, wproj, num_heads, smem)
    if bproj.shape != (C,) or bproj.device != x.device:
        raise ValueError(f"{name}: bproj must be [{C}] on {x.device}, got {tuple(bproj.shape)}")
    if x.device.type == "cpu":
        return attn_subblock_plain(x, wqkv, bqkv, bias, wproj, bproj, num_heads=num_heads,
                                   scale=scale)
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
    build.check(rc, name)
    attn_subblock.launches += 1
    return out


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
    N, C = x.shape[1], x.shape[2]
    B, N, C, d = _check(name, x, wqkv, bqkv, bias, wproj, num_heads,
                        bwd_smem_bytes(N, C, C // max(num_heads, 1)))
    if dout.shape != (B, N, C) or dout.dtype != torch.bfloat16 or dout.device != x.device:
        raise ValueError(f"{name}: dout must be bf16 {(B, N, C)} on {x.device}, got "
                         f"{tuple(dout.shape)} {dout.dtype} on {dout.device}")
    if x.device.type == "cpu":
        grads = attn_subblock_bwd_plain(x, wqkv, bqkv, bias, wproj, dout, num_heads=num_heads,
                                        scale=scale)
        return (grads[0] if need_dx else None, *grads[1:])
    x, bias, dout = x.contiguous(), bias.contiguous(), dout.contiguous()
    wq, bq = _qkv_operands(wqkv, bqkv, num_heads, d, C)
    wprojT = wproj.to(torch.bfloat16).t().contiguous()
    wqkvT = wqkv.to(torch.bfloat16).t().contiguous()
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    per_block = bwd_windows_per_block(B, N, C, d)
    s_qkv, s_proj = wgrad_splits(B * N, 3 * C, C), wgrad_splits(B * N, C, C)
    dctx = torch.empty(B, N, C, dtype=bf16, device=dev)
    ctx = torch.empty(B, N, C, dtype=bf16, device=dev)
    dqkv = torch.empty(B, N, 3 * C, dtype=bf16, device=dev)
    dbias_part = torch.empty(-(-B // per_block), num_heads, N, N, dtype=f32, device=dev)
    gqkv = torch.empty(3 * C * C + 3 * C, dtype=f32, device=dev)
    gproj = torch.empty(C * C + C, dtype=f32, device=dev)
    part_qkv = torch.empty(s_qkv if s_qkv > 1 else 0, gqkv.numel(), dtype=f32, device=dev)
    part_proj = torch.empty(s_proj if s_proj > 1 else 0, gproj.numel(), dtype=f32, device=dev)
    dbias = torch.empty(num_heads, N, N, dtype=f32, device=dev)
    dx = torch.empty(B, N, C, dtype=bf16, device=dev) if need_dx else None
    vec = int(C % 8 == 0 and _aligned(x, dout, dctx, ctx, dqkv))
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dfd_attn_subblock_bwd(
            x.data_ptr(), wq.data_ptr(), bq.data_ptr(), bias.data_ptr(), wprojT.data_ptr(),
            wqkvT.data_ptr(), dout.data_ptr(), dctx.data_ptr(), ctx.data_ptr(), dqkv.data_ptr(),
            dbias_part.data_ptr(), part_qkv.data_ptr(), part_proj.data_ptr(),
            None if dx is None else dx.data_ptr(), dbias.data_ptr(), gqkv.data_ptr(),
            gproj.data_ptr(), B, N, C, num_heads, per_block, s_qkv, s_proj, float(scale), vec,
            stream,
        )
    build.check(rc, name)
    attn_subblock_bwd.launches += 1
    return (dx, gqkv[:3 * C * C].view(3 * C, C), gqkv[3 * C * C:], dbias,
            gproj[:C * C].view(C, C), gproj[C * C:])


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
