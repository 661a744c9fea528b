"""K2: fused MBConv expand 1x1 -> depthwise k x k (+ SiLUs, + SE mean).

Port of ``deepfakedetection_tpu/ops/pallas/expand_dw.py``
(``expand_dw_silu_pool``). The CUDA kernel is ``csrc/expand_dw.cu``;
``expand_dw_silu_pool_plain`` is the same contract in plain PyTorch, with the
same rounding points, which the wrapper runs for CPU tensors and the tests
and ``chip_smoke.py`` hold the kernel against. Layout is NHWC, as in the JAX
package. ``plan`` mirrors the kernel's launch plan (``choose_plan`` in
``csrc/expand_dw.cu``: channels an item, row bands, the persistent grid);
``chip_smoke.py`` holds the two equal on the card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops.depthwise_se import MAX_SMEM_BYTES, _align16


# Mirrors the constants of csrc/expand_dw.cu.
TW = 7  # output columns of one tap item
WARPS = 7
THREADS = 32 * WARPS
# Shared memory under which two blocks share one SM (228 KB, 1 KB each reserved)
TWO_BLOCKS_PER_SM = 113 * 1024
SMS = 132  # the H100 SXM's SMs, for plans made without a card


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _conflict_free(words: int) -> int:
    return words + (12 - words % 8) % 8


class Layout(NamedTuple):
    """``layout`` in csrc/expand_dw.cu: Cin padded to 16 (Kp), the x, wexp
    and expanded pixel strides in words, tap segments a row, the expanded
    row's width in pixels (RW), bands, rows of the circular buffer (NR),
    steps an item, pixels of the largest band (M), and the shared memory:
    the band's x, the wexp slice [CB][Kp], the circular buffer plus one zero
    row, bexp and the pool's lane sums."""

    Kp: int
    xs_words: int
    wk_words: int
    S: int
    segs: int
    RW: int
    nb: int
    NR: int
    steps: int
    M: int
    smem_bytes: int


def layout(H: int, W: int, Cin: int, CB: int, RB: int, k: int) -> Layout:
    R = k // 2
    Kp = _cdiv(Cin, 16) * 16
    xs_words, wk_words, S = _conflict_free(Kp // 2), Kp // 2 + 4, _conflict_free(CB // 2)
    segs = _cdiv(W, TW)
    RW = segs * TW + 2 * R
    nb = _cdiv(H, RB)
    NR = H if nb == 1 else RB + 2 * R
    M = (H if nb == 1 else RB) * W
    smem = (_align16(4 * M * xs_words) + _align16(4 * CB * wk_words)
            + _align16(4 * (NR + 1) * RW * S) + _align16(4 * CB) + 4 * (THREADS // (CB // 2)) * CB)
    return Layout(Kp, xs_words, wk_words, S, segs, RW, nb, NR, 1 if nb == 1 else nb + 1, M, smem)


def band_of(s: int, H: int, RB: int, R: int, nb: int) -> tuple[int, int, int, int]:
    """Step ``s`` of an item: (lo, hi, olo, ohi), it expands rows [lo, hi)
    and writes output rows [olo, ohi). One band does everything in one step;
    else step 0 expands the first R rows and step s >= 1 the rows
    [(s-1)RB + R, sRB + R) and writes [(s-1)RB, sRB), each clipped to H."""
    if nb == 1:
        return 0, H, 0, H
    lo = 0 if s == 0 else (s - 1) * RB + R
    return (min(lo, H), min(s * RB + R, H), 0 if s == 0 else (s - 1) * RB,
            0 if s == 0 else min(s * RB, H))


@dataclass(frozen=True)
class Plan:
    """Launch geometry: CB Ce-channels an item, bands of RB rows, NR rows in
    the circular buffer, steps an item, items (B x channel blocks), the
    persistent grid, blocks an SM and one block's shared memory."""

    CB: int
    RB: int
    NR: int
    steps: int
    items: int
    grid: int
    blocks_per_sm: int
    smem_bytes: int
    cost: int = field(default=0, compare=False)


def make_plan(B: int, H: int, W: int, Cin: int, Ce: int, k: int, CB: int, RB: int,
              sms: int = SMS) -> Plan:
    """``make_plan`` in csrc/expand_dw.cu: the plan for CB and RB, with its
    cost (the expand's warp rounds and the taps' lane rounds of each step,
    the waves of items over the grid, one or two blocks an SM), in integers
    so that both pick the same plan."""
    RB = min(RB, H)
    L = layout(H, W, Cin, CB, RB, k)
    bps = 2 if L.smem_bytes <= TWO_BLOCKS_PER_SM else 1  # its registers allow two
    items = _cdiv(Ce, CB) * B
    grid = min(items, bps * sms)
    R, lanes = k // 2, THREADS // (CB // 2)
    tap_round = 2 * TW * k * k + 3 * k * (TW + k - 1) + 308
    exp_round = 384 + L.Kp
    item = 400
    for s in range(L.steps):
        lo, hi, olo, ohi = band_of(s, H, RB, R, L.nb)
        item += _cdiv(_cdiv((hi - lo) * W, 16) * (CB // 32), WARPS) * exp_round
        item += _cdiv((ohi - olo) * L.segs, lanes) * tap_round
        item += 800
    cost = _cdiv(items, grid) * item * (47 if bps == 2 else 43)
    return Plan(CB, RB, L.NR, L.steps, items, grid, bps, L.smem_bytes, cost)


@functools.lru_cache(maxsize=None)
def plan(H: int, W: int, Cin: int, Ce: int, k: int, B: int = 128, sms: int = SMS) -> Plan:
    """``choose_plan`` in csrc/expand_dw.cu: the cheapest plan that fits one
    block's shared memory, over CB 64 then 32 (only 32 when Ce <= 32) and RB
    from H down to max(k // 2, 1) (a band has at least the k // 2 rows that
    step 0 expands, unless the map is one band); the first of equal costs
    wins."""
    best = None
    for CB in (64, 32):
        if CB == 64 and Ce <= 32:
            continue
        for RB in range(H, min(H, max(k // 2, 1)) - 1, -1):
            p = make_plan(B, H, W, Cin, Ce, k, CB, RB, sms)
            if p.smem_bytes <= MAX_SMEM_BYTES and (best is None or p.cost < best.cost):
                best = p
    return best


def block_items(p: Plan, block: int) -> range:
    """The items one block of the persistent grid walks, in order (item i is
    image i % B of channel block i // B)."""
    return range(block * p.items // p.grid, (block + 1) * p.items // p.grid)


def wpack_words(Cin: int, Ce: int) -> int:
    """32-bit words of the wexp scratch the kernel packs into, [Ce padded to
    64][Cin padded to 16] bf16."""
    return _cdiv(Cin, 16) * 8 * _cdiv(Ce, 64) * 64


def kernel_plan(B: int, H: int, W: int, Cin: int, Ce: int, k: int, sms: int) -> Plan | None:
    """The plan the built library computes for the shape (card only), to hold
    ``plan`` to it."""
    import ctypes

    out = (ctypes.c_int * 8)()
    if build.library().dfd_expand_dw_plan(B, H, W, Cin, Ce, k, sms, out) != 0:
        return None
    return Plan(*out)


def expand_dw_silu_pool_plain(
    x: torch.Tensor,
    wexp: torch.Tensor,
    bexp: torch.Tensor,
    wdw: torch.Tensor,
    bdw: torch.Tensor,
    *,
    kernel: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,H,W,Cin] bf16; wexp [Cin,Ce], bexp [Ce], wdw [k,k,Ce], bdw [Ce]
    f32 -> (y [B,H,W,Ce] bf16, pool [B,Ce] f32).

    The expand multiplies bf16 x by bf16-rounded wexp with f32 accumulation,
    adds bexp, applies SiLU and rounds to bf16; the expanded map is then
    zero-padded by k//2, the taps run in f32, + bdw, SiLU. The pool is the
    mean of that f32 activation before it is rounded to bf16."""
    k = kernel
    Ce = wexp.shape[1]
    e = x.float() @ wexp.to(torch.bfloat16).float() + bexp
    e = F.silu(e).to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wf = wdw.permute(2, 0, 1).reshape(Ce, 1, k, k)
    yf = F.silu(F.conv2d(e, wf, None, 1, k // 2, 1, Ce) + bdw.view(1, Ce, 1, 1))
    y = yf.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
    return y, yf.mean(dim=(2, 3))


def _check(x, wexp, bexp, wdw, bdw, k: int) -> None:
    if k not in (3, 5):
        raise ValueError(f"expand_dw_silu_pool: kernel must be 3 or 5, got {k}")
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            "expand_dw_silu_pool: x must be a contiguous NHWC bf16 tensor, got "
            f"shape {tuple(x.shape)} {x.dtype} strides {x.stride()}"
        )
    Cin = x.shape[-1]
    Ce = wexp.shape[-1] if wexp.dim() == 2 else -1
    for name, t, shape in (
        ("wexp", wexp, (Cin, Ce)), ("bexp", bexp, (Ce,)),
        ("wdw", wdw, (k, k, Ce)), ("bdw", bdw, (Ce,)),
    ):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"expand_dw_silu_pool: {name} must be contiguous f32 {shape}, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"expand_dw_silu_pool: {name} on {t.device}, x on {x.device}")


def expand_dw_silu_pool(
    x: torch.Tensor,
    wexp: torch.Tensor,
    bexp: torch.Tensor,
    wdw: torch.Tensor,
    bdw: torch.Tensor,
    *,
    kernel: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 (see ``expand_dw_silu_pool_plain`` for the contract). Launches the
    CUDA kernel on the current stream for a CUDA tensor, runs the plain
    version for a CPU tensor, raises on any other device."""
    _check(x, wexp, bexp, wdw, bdw, kernel)
    if x.device.type == "cpu":
        return expand_dw_silu_pool_plain(x, wexp, bexp, wdw, bdw, kernel=kernel)
    if x.device.type != "cuda":
        raise ValueError(f"expand_dw_silu_pool: unsupported device {x.device}")
    B, H, W, Cin = x.shape
    Ce = wexp.shape[1]
    p = plan(H, W, Cin, Ce, kernel, B, sm_count(x.device))
    if p is None:
        raise ValueError(f"expand_dw_silu_pool: no launch plan fits {MAX_SMEM_BYTES} B at "
                         f"{tuple(x.shape)} -> {Ce}, k {kernel}")
    y = torch.empty((B, H, W, Ce), dtype=torch.bfloat16, device=x.device)
    pool = torch.empty((B, Ce), dtype=torch.float32, device=x.device)
    wpack = torch.empty(wpack_words(Cin, Ce), dtype=torch.int32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dfd_expand_dw_silu_pool(
            x.data_ptr(), wexp.data_ptr(), bexp.data_ptr(), wdw.data_ptr(),
            bdw.data_ptr(), y.data_ptr(), pool.data_ptr(), wpack.data_ptr(),
            B, H, W, Cin, Ce, kernel, p.CB, p.RB, stream,
        )
    build.check(rc, "expand_dw_silu_pool")
    expand_dw_silu_pool.launches += 1
    return y, pool


expand_dw_silu_pool.launches = 0


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SMs, which size the persistent grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count
