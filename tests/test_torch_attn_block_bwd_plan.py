"""The K6 backward's launch plan (``deepfakedetection_tpu_torch/ops/
attn_block.bwd_plan``, the Python mirror of ``bwd_plan`` in
``ops/csrc/attn_block_bwd.cu``), on the CPU, without building a model.

For every K6 backward launch of FasterViT-0 to -4 at 224 px in both head
configurations (stage 3's windows of 49 + 4 carrier tokens, its 16 carrier
tokens, stage 4's window of 49) at the fine-tune batch of 128 images, and for
``chip_smoke``'s odd sizes and backward tails: wherever the one-window-a-block
kernel this design replaced (``replaced_bwd_smem_bytes``) took the shape, the
plan fits a block's 227 KB; the blocks' window groups cover the batch
exactly in whole clusters; the head groups cover the heads exactly; each Wqkv
tile read from L2 serves at least 128 wgmma rows. The table in the kernel's
header comment is the plan this mirror computes. On the card,
``chip_smoke.phase1_k6`` holds the mirror to the built kernel's own plan
(``kernel_bwd_plan``).
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from deepfakedetection_tpu_torch.models.fastervit import _VARIANTS, tpu_heads
from deepfakedetection_tpu_torch.ops import attn_block as k6

SMEM = 232448  # shared memory one H100 block may use
CSRC = Path(k6.__file__).resolve().parent / "csrc" / "attn_block_bwd.cu"


def replaced_bwd_smem_bytes(N, C, d):
    """Shared memory of the backward window block this design replaced (one
    window's x, one head's q, k, v and dctx, bf16 p and ds): the shapes it
    took must all have a plan."""
    pad = lambda n: -(-n // 16) * 16  # noqa: E731
    Np, Cp, Dp = pad(N), pad(C), pad(d)
    return (Np * (Cp + 8) + 4 * Np * (Dp + 8) + 2 * Np * (Np + 8)) * 2


def fastervit_bwd_shapes():
    """(label, windows, N, C, heads) of every K6 backward launch of a
    FasterViT at 224 px at the fine-tune batch of 128 images: 4 windows an
    image at stage 3, one carrier-token set and one stage-4 window an image."""
    out = []
    for v, cfg in sorted(_VARIANTS.items()):
        dim, official = cfg["dim"], cfg["num_heads"]
        for config, heads in (("official", official), ("tpu", tpu_heads(dim, official))):
            out += [(f"fastervit{v}-{config}-N53", 512, 53, 4 * dim, heads[2]),
                    (f"fastervit{v}-{config}-N16", 128, 16, 4 * dim, heads[2]),
                    (f"fastervit{v}-{config}-N49", 128, 49, 8 * dim, heads[3])]
    return out


SHAPES = fastervit_bwd_shapes() + [
    (f"odd{s}", s[0], s[1], s[2] * s[3], s[2]) for s in chip_smoke.K6_ODD] + [
    (f"tail{s}", s[0], s[1], s[2] * s[3], s[2]) for s in chip_smoke.K6_BWD_TAILS]


@pytest.mark.parametrize("label,B,N,C,h", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_fits_covers_and_shares_each_weight_tile(label, B, N, C, h):
    d = C // h
    plan = k6.bwd_plan(B, N, C, h)
    if d > 128:  # head_dim past 128 (FasterViT-1 and -4 in the tpu configuration)
        return
    if replaced_bwd_smem_bytes(N, C, d) <= SMEM:
        assert plan is not None
    if plan is None:
        return
    assert plan.smem <= SMEM
    assert plan.smem == k6.bwd_smem_bytes(N, -(-C // 16) * 16, -(-d // 16) * 16, plan.windows,
                                          plan.heads, plan.chunk, plan.stages, plan.staged)
    assert plan.windows * N <= 128 and plan.stages >= 2 and plan.chunk in k6._UNITS
    # the window groups cover the batch exactly, in whole clusters of 2
    groups = -(-B // plan.windows)
    last = B - (groups - 1) * plan.windows
    assert 1 <= last <= plan.windows and (groups - 1) * plan.windows + last == B
    assert plan.blocks % 2 == 0 and plan.blocks - 2 < groups <= plan.blocks
    # the head groups cover the heads exactly
    assert plan.head_groups == -(-h // plan.heads) and plan.heads <= h
    assert (plan.head_groups - 1) * plan.heads < h <= plan.head_groups * plan.heads
    assert plan.rows_per_weight_read(N) >= 128


@pytest.mark.parametrize("B,N,h,d", chip_smoke.K6_BWD_TAILS)
def test_tails_leave_an_empty_block_a_partial_group_or_a_partial_head_group(B, N, h, d):
    plan = k6.bwd_plan(B, N, h * d, h)
    groups = -(-B // plan.windows)
    assert B % plan.windows or plan.blocks > groups or h % plan.heads


def test_fine_tune_shapes_fill_the_warps_and_the_card():
    """At FasterViT-2's fine-tune shapes each block gives every one of its 8
    consumer warps a row-pass item, and the grids of stage 3's and stage 4's
    windows hold two blocks a SM of the card's 132 at least."""
    for _, B, N, C, h, _ in chip_smoke.K6_BWD_SHAPES:
        plan = k6.bwd_plan(B, N, C, h)
        assert plan.windows * plan.heads * (-(-N // 16)) >= 8
        assert N == 16 or plan.blocks * plan.head_groups >= 2 * 132


def test_header_table_is_the_plan():
    """The plan table in attn_block_bwd.cu's header comment is bwd_plan's."""
    rows = re.findall(r"//\s+(official|tpu) \((\d+), (\d+), (\d+)\)\s+(\d+)\s+(\d+)\s+(\d+)\s+"
                      r"(\d+)\s+(\d)\s+(\d+)\s+\(\s*(\d+)\)\s+([\d,]+)", CSRC.read_text())
    assert len(rows) == 6
    batch = {53: 512, 16: 128, 49: 128}
    for _, N, C, h, G, HG, NT, stages, staged, per_read, real, smem in rows:
        N, C, h = int(N), int(C), int(h)
        plan = k6.bwd_plan(batch[N], N, C, h)
        assert (plan.windows, plan.heads, plan.chunk, plan.stages, plan.staged, plan.smem) == (
            int(G), int(HG), int(NT), int(stages), int(staged), int(smem.replace(",", "")))
        assert plan.rows_per_weight_read(N) == int(per_read)
        assert 2 * plan.windows * N == int(real)


@pytest.mark.parametrize("M,C,h", [(512 * 53, 384, 8), (128 * 16, 384, 3), (128 * 49, 768, 16),
                                   (8 * 33, 123, 3), (1, 16, 2)])
def test_weight_gradient_chunks_cover_the_rows(M, C, h):
    """The row chunks of the weight gradients: at least one, at most one
    chunk a 512 rows, their 64-row multiples covering the M rows."""
    splits = k6.wgrad_splits(M, C, h)
    chunk = -(-(-(-M // splits)) // 64) * 64
    assert 1 <= splits <= max(1, -(-M // 512))
    assert chunk % 64 == 0 and (-(-M // chunk) - 1) * chunk < M <= -(-M // chunk) * chunk


def _args(N, C, h):
    return [torch.zeros(2, N, C, dtype=torch.bfloat16), torch.zeros(3 * C, C),
            torch.zeros(3 * C), torch.zeros(h, N, N), torch.zeros(C, C)]


@pytest.mark.parametrize("N,C,h,message", [
    (129, 16, 2, "attn_subblock_bwd: the kernel takes 1 <= N <= 128 tokens and head_dim <= 128, "
                 "got N=129, head_dim=8"),
    (16, 129, 1, "attn_subblock_bwd: the kernel takes 1 <= N <= 128 tokens and head_dim <= 128, "
                 "got N=16, head_dim=129"),
    (49, 2048, 16, "attn_subblock_bwd: N=49, C=2048, head_dim=128 needs"),
])
def test_cpu_wrapper_refuses_past_the_limits(N, C, h, message):
    args = _args(N, C, h)
    with pytest.raises(ValueError, match=re.escape(message)):
        k6.attn_subblock_bwd(*args, args[0], num_heads=h, scale=0.1)
