"""K5 backward's launch plan (``deepfakedetection_tpu_torch/ops/window_attn.
bwd_plan``, the Python mirror of ``bwd_plan`` in ``ops/csrc/
window_attn_bwd.cu``), on the CPU, without building a model.

For every K5 backward launch of FasterViT-0 to -4 at 224 px in both head
configurations (stage 3's 512 windows of 49 + 4 carrier tokens, stage 4's 128
windows of 49) at the fine-tune batch of 128 images, and for
``chip_smoke.K5_BWD_ODD`` and phase 1's unaligned view: the plan fits a
block's 227 KB; its blocks' (head, window) items cover every pair exactly
once; each head's windows are summed in one fixed order (its blocks in
order, each a contiguous ascending range), split evenly (no block more than
one window over another) over no more blocks than the card has SMs. Every
(N, head_dim) that the kernel this design replaced took
(``replaced_bwd_smem_bytes``) has a plan. The table in the kernel's header
comment is the plan this mirror computes. On the card,
``chip_smoke.phase1_k5_bwd`` holds the mirror to the built kernel's own plan
(``kernel_bwd_plan``).
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
CSRC = Path(k5.__file__).resolve().parent / "csrc" / "window_attn_bwd.cu"


def replaced_bwd_smem_bytes(N: int, d: int) -> int:
    """Shared memory of the backward block this design replaced (one window
    group of one head a block: q, k, v and dout rows, bf16 p and ds, an
    unpadded f32 dbias accumulator): the shapes it took must all have a plan."""
    Np, Dp = -(-N // 16) * 16, -(-d // 16) * 16
    return (4 * Np * (Dp + 8) + 2 * Np * (Np + 8)) * 2 + Np * Np * 4


def fastervit_bwd_shapes():
    """(label, windows, N, heads, head_dim) of every K5 backward launch of a
    FasterViT at 224 px at the fine-tune batch of 128 images."""
    out = []
    for v, cfg in sorted(_VARIANTS.items()):
        dim, official = cfg["dim"], cfg["num_heads"]
        for config, heads in (("official", official), ("tpu", tpu_heads(dim, official))):
            out += [(f"fastervit{v}-{config}-N53", 512, 53, heads[2], 4 * dim // heads[2]),
                    (f"fastervit{v}-{config}-N49", 128, 49, heads[3], 8 * dim // heads[3])]
    return out


SHAPES = fastervit_bwd_shapes() + [(f"odd{s}", *s) for s in chip_smoke.K5_BWD_ODD] + [
    ("unaligned view", 16, 53, 8, 48)]


@pytest.mark.parametrize("label,B,N,h,d", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_fits_covers_every_item_once_and_sums_in_a_fixed_order(label, B, N, h, d):
    if d > k5.MAX_HEAD_DIM:  # head_dim past 128 (FasterViT-1 and -4 in the tpu configuration)
        assert replaced_bwd_smem_bytes(N, d) > 0
        return
    plan = k5.bwd_plan(B, N, h, d, SMS)
    assert plan is not None and plan.smem <= SMEM
    assert plan.smem == k5.bwd_smem_bytes(N, d, plan.slots, plan.buffers)
    assert 1 <= plan.slots <= k5.BWD_MAX_SLOTS and plan.buffers in (1, 2)
    # the blocks' (head, window) items: every pair exactly once
    items = Counter()
    order = {head: [] for head in range(h)}
    sizes = []
    for block in range(plan.blocks(h)):
        head, part = divmod(block, plan.per_head)
        windows = plan.windows(B, part)
        assert len(windows) >= 1 and windows.step == 1
        items.update((head, b) for b in windows)
        order[head] += list(windows)
        sizes.append(len(windows))
    assert set(items) == set(itertools.product(range(h), range(B)))
    assert set(items.values()) == {1}
    # each head's windows in one fixed order: its blocks in order, each ascending
    assert all(order[head] == list(range(B)) for head in range(h))
    # an even split with no wave tail
    assert max(sizes) - min(sizes) <= 1
    assert plan.blocks(h) <= max(SMS, h)


def test_fine_tune_shapes_fill_the_card_with_a_ring_in_flight():
    """At FasterViT-2's fine-tune shapes every launch holds one block a SM on
    at least 128 of the 132 and keeps at least one window loading while one
    computes."""
    for _, B, N, C, h, _ in chip_smoke.K5_BWD_SHAPES:
        plan = k5.bwd_plan(B, N, h, C // h, SMS)
        assert 128 <= plan.blocks(h) <= SMS and plan.slots >= 2 and plan.buffers == 2


@pytest.mark.parametrize("N", range(1, k5.MAX_TOKENS + 1, 9))
def test_every_shape_the_replaced_kernel_took_has_a_plan(N):
    for n, d in itertools.product(range(N, min(N + 9, k5.MAX_TOKENS + 1)),
                                  range(1, k5.MAX_HEAD_DIM + 1)):
        plan = k5.bwd_plan(1, n, 1, d, SMS)
        if replaced_bwd_smem_bytes(n, d) <= SMEM:
            assert plan is not None, (n, d)
        if plan is not None:
            assert plan.smem <= SMEM


def test_header_table_is_the_plan():
    """The plan table in window_attn_bwd.cu's header comment is bwd_plan's."""
    rows = re.findall(r"//\s+(official|tpu) \((\d+), (\d+), (\d+), (\d+)\)\s+(\d+)\s+(\d+)\s+"
                      r"(\d+)(?: - (\d+))?\s+(\d)\s+(\d)\s+([\d,]+)", CSRC.read_text())
    assert len(rows) == len(chip_smoke.K5_BWD_SHAPES)
    for (_, B, N, C, h, P, grid, lo, hi, slots, buffers, smem), shape in zip(
            rows, chip_smoke.K5_BWD_SHAPES):
        B, N, C, h = int(B), int(N), int(C), int(h)
        assert (B, N, C, h) == shape[1:5]
        plan = k5.bwd_plan(B, N, h, C // h, SMS)
        assert (plan.per_head, plan.blocks(h), plan.slots, plan.buffers, plan.smem) == (
            int(P), int(grid), int(slots), int(buffers), int(smem.replace(",", "")))
        sizes = {len(plan.windows(B, part)) for part in range(plan.per_head)}
        assert sizes == {int(lo), int(hi or lo)}


def test_cpu_wrapper_refuses_a_shape_no_plan_fits():
    import torch

    qkv = torch.zeros(1, 128, 3 * 2 * 128, dtype=torch.bfloat16)
    bias, dout = torch.zeros(2, 128, 128), torch.zeros(1, 128, 2 * 128, dtype=torch.bfloat16)
    assert k5.bwd_plan(1, 128, 2, 128) is None
    with pytest.raises(ValueError, match="N=128, head_dim=128 needs 278656 bytes"):
        k5.window_attention_bwd(qkv, bias, dout, num_heads=2, scale=0.1)
