"""K5 forward's launch plan (``deepfakedetection_tpu_torch/ops/window_attn.
fwd_plan``, the Python mirror of ``fwd_plan`` in ``ops/csrc/window_attn.cu``),
on the CPU, without building a model.

For every K5 forward launch of FasterViT-0 to -4 at 224 px in both head
configurations (stage 3's windows of 49 + 4 carrier tokens, stage 4's
windows of 49) at the eval batch of 256 images and the fine-tune batch of
128, and for ``chip_smoke.K5_ODD`` and phase 1's unaligned view: the plan
fits a block's 227 KB; its blocks' warp groups cover every (head, window)
pair exactly once, each block a contiguous range of one head's windows split
evenly (no block more than one window over another, no group more than one
over another) over no more blocks than the card has SMs. Every (N,
head_dim) that the kernel this design replaced took
(``replaced_fwd_smem_bytes``) has a plan. The table in the kernel's header
comment is the plan this mirror computes. On the card,
``chip_smoke.phase1_k5`` holds the mirror to the built kernel's own plan
(``kernel_fwd_plan``).
"""

import itertools
import re
from collections import Counter
from pathlib import Path

import pytest

import chip_smoke
from deepfakedetection_tpu_torch.models.fastervit import _VARIANTS, tpu_heads
from deepfakedetection_tpu_torch.ops import window_attn as k5

SMEM = 232448  # shared memory one H100 block may use
SMS = 132  # an H100 SXM's SMs
CSRC = Path(k5.__file__).resolve().parent / "csrc" / "window_attn.cu"


def replaced_fwd_smem_bytes(N: int, d: int) -> int:
    """Shared memory of the forward block this design replaced (one window
    and head a block: q, k and v rows at a stride of the padded d + 8): the
    shapes it took must all have a plan."""
    Np, Dp = -(-N // 16) * 16, -(-d // 16) * 16
    return 3 * Np * (Dp + 8) * 2


def fastervit_fwd_shapes():
    """(label, windows, N, heads, head_dim) of every K5 forward launch of a
    FasterViT at 224 px at the eval batch of 256 and the fine-tune batch of
    128 images."""
    out = []
    for v, cfg in sorted(_VARIANTS.items()):
        dim, official = cfg["dim"], cfg["num_heads"]
        for config, heads in (("official", official), ("tpu", tpu_heads(dim, official))):
            for batch in (256, 128):
                out += [(f"fastervit{v}-{config}-b{batch}-N53", 4 * batch, 53, heads[2],
                         4 * dim // heads[2]),
                        (f"fastervit{v}-{config}-b{batch}-N49", batch, 49, heads[3],
                         8 * dim // heads[3])]
    return out


SHAPES = fastervit_fwd_shapes() + [(f"odd{s}", *s) for s in chip_smoke.K5_ODD] + [
    ("unaligned view", 512, 53, 8, 48)]


@pytest.mark.parametrize("label,B,N,h,d", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_fits_and_covers_every_item_once(label, B, N, h, d):
    if d > k5.MAX_HEAD_DIM:  # head_dim past 128 (FasterViT-1 and -4 in the tpu configuration)
        assert replaced_fwd_smem_bytes(N, d) > 0
        return
    plan = k5.fwd_plan(B, N, h, d, SMS)
    assert plan is not None and plan.smem <= SMEM
    assert plan.smem == k5.fwd_smem_bytes(N, d, plan.slots)
    assert 1 <= plan.slots <= k5.FWD_MAX_SLOTS
    assert plan.groups == (4 if N <= 64 and d <= 64 else 2)
    items, sizes = Counter(), []
    for block in range(plan.blocks(h)):
        head, part = divmod(block, plan.per_head)
        groups = [plan.windows(B, part, grp) for grp in range(plan.groups)]
        # the block's windows: a contiguous range, interleaved over its groups
        mine = sorted(b for windows in groups for b in windows)
        assert mine and mine == list(range(mine[0], mine[-1] + 1))
        assert max(map(len, groups)) - min(map(len, groups)) <= 1
        items.update((head, b) for b in mine)
        sizes.append(len(mine))
    assert set(items) == set(itertools.product(range(h), range(B)))
    assert set(items.values()) == {1}
    assert max(sizes) - min(sizes) <= 1  # an even split with no wave tail
    assert plan.blocks(h) <= max(SMS, h)


def test_eval_shapes_fill_the_card_with_a_ring_in_flight():
    """At FasterViT-2's eval shapes every launch holds one block a SM on at
    least 128 of the 132 and keeps at least one window loading in each group
    while it computes one."""
    for _, B, N, C, h, _ in chip_smoke.K5_SHAPES:
        plan = k5.fwd_plan(B, N, h, C // h, SMS)
        assert 128 <= plan.blocks(h) <= SMS and plan.slots >= 2


def test_odd_sizes_cover_every_pipeline():
    """``chip_smoke.K5_ODD`` (which the card tests share) holds, with many
    windows a block (four a group or more), both group counts and rings of
    every depth the plan picks, warps without a query tile, two tiles a warp
    and the element copies."""
    many = [(B, N, h, d) for B, N, h, d in chip_smoke.K5_ODD
            if min(len(k5.fwd_plan(B, N, h, d, SMS).windows(B, 0, g))
                   for g in range(k5.fwd_plan(B, N, h, d, SMS).groups)) >= 4]
    assert {k5.fwd_plan(B, N, h, d, SMS).slots for B, N, h, d in many} == {1, 2, 3, 4}
    assert {k5.fwd_plan(B, N, h, d, SMS).groups for B, N, h, d in many} == {2, 4}
    assert any(N <= 48 for _, N, _, _ in many) and any(N > 64 for _, N, _, _ in many)
    assert any(d % 8 for _, _, _, d in many)


@pytest.mark.parametrize("N", range(1, k5.MAX_TOKENS + 1, 16))
def test_every_shape_the_replaced_kernel_took_has_a_plan(N):
    for n, d in itertools.product(range(N, min(N + 16, k5.MAX_TOKENS + 1)),
                                  range(1, k5.MAX_HEAD_DIM + 1)):
        plan = k5.fwd_plan(1, n, 1, d, SMS)
        if replaced_fwd_smem_bytes(n, d) <= SMEM:
            assert plan is not None, (n, d)
        if plan is not None:
            assert plan.smem <= SMEM


def test_header_table_is_the_plan():
    """The plan table in window_attn.cu's header comment is fwd_plan's."""
    rows = re.findall(r"//\s+(official|tpu) \((\d+), (\d+), (\d+), (\d+)\)\s+(\d+)\s+(\d+)\s+"
                      r"(\d+)(?: - (\d+))?\s+(\d)\s+(\d)\s+([\d,]+)", CSRC.read_text())
    assert len(rows) == len(chip_smoke.K5_SHAPES)
    for (_, B, N, C, h, P, grid, lo, hi, groups, slots, smem), shape in zip(
            rows, chip_smoke.K5_SHAPES):
        B, N, C, h = int(B), int(N), int(C), int(h)
        assert (B, N, C, h) == shape[1:5]
        plan = k5.fwd_plan(B, N, h, C // h, SMS)
        assert (plan.per_head, plan.blocks(h), plan.groups, plan.slots, plan.smem) == (
            int(P), int(grid), int(groups), int(slots), int(smem.replace(",", "")))
        sizes = {sum(len(plan.windows(B, part, g)) for g in range(plan.groups))
                 for part in range(plan.per_head)}
        assert sizes == {int(lo), int(hi or lo)}


def test_cpu_wrappers_refuse_sizes_past_the_kernels_limits():
    import torch

    qkv = torch.zeros(1, 129, 3 * 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 <= N <= 128 tokens"):
        k5.window_attention(qkv, torch.zeros(1, 129, 129), num_heads=1, scale=0.1)
    q = torch.zeros(1, 1, 8, 129, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim=129"):
        k5.window_attention_heads(q, q, q, torch.zeros(1, 8, 8), scale=0.1)
