"""The K6 forward's launch plan (``deepfakedetection_tpu_torch/ops/
attn_block.fwd_plan``, the Python mirror of ``fwd_plan`` in
``ops/csrc/attn_block.cu``), on the CPU, without building a model.

For every attention sub-block of FasterViT-0 to -4 at 224 px in both head
configurations (stage 3's windows of 49 + 4 carrier tokens, its 16 carrier
tokens, stage 4's window of 49) at the eval batch of 256 and the fine-tune
batch of 128 images: wherever a one-window-a-block kernel
(``one_window_smem_bytes``) takes the shape, the plan fits a block's 227 KB; each
weight tile read from L2 serves at least 128 rows; the blocks' windows cover
the batch's exactly, the last group partial where the count does not divide,
and the grid is whole clusters. The table in the kernel's header comment is
the plan this mirror computes. On the card, ``chip_smoke.phase1_k6`` holds
the mirror to the built kernel's own plan (``kernel_plan``).
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from deepfakedetection_tpu_torch.models.fastervit import _VARIANTS, tpu_heads
from deepfakedetection_tpu_torch.ops import attn_block as k6

SMEM = 232448  # shared memory one H100 block may use
CSRC = Path(k6.__file__).resolve().parent / "csrc" / "attn_block.cu"


def one_window_smem_bytes(N, C, d):
    """Shared memory of a forward block of one window holding x, ctx and one
    head's q, k, v: the shapes such a kernel takes must all have a plan."""
    pad = lambda n: -(-n // 16) * 16  # noqa: E731
    Np, Cp, Dp = pad(N), pad(C), pad(d)
    return (Np * (Cp + 8) + 3 * Np * (Dp + 8)) * 2


def fastervit_shapes():
    """(variant, config, images, windows, N, C, heads) of every K6 launch of a
    FasterViT at 224 px: 4 windows an image at stage 3, one carrier-token
    set and one stage-4 window an image."""
    out = []
    for v, cfg in sorted(_VARIANTS.items()):
        dim, official = cfg["dim"], cfg["num_heads"]
        for config, heads in (("official", official), ("tpu", tpu_heads(dim, official))):
            for images in (256, 128):
                out += [(v, config, images, 4 * images, 53, 4 * dim, heads[2]),
                        (v, config, images, images, 16, 4 * dim, heads[2]),
                        (v, config, images, images, 49, 8 * dim, heads[3])]
    return out


SHAPES = fastervit_shapes()


def _covers(plan, B):
    """The windows a plan's blocks take: groups of ``windows``, the last
    partial, the grid rounded up to whole clusters of 2."""
    G = plan.windows
    groups = -(-B // G)
    last = B - (groups - 1) * G
    return groups, last


@pytest.mark.parametrize("v,config,images,B,N,C,h", SHAPES,
                         ids=[f"fastervit{s[0]}-{s[1]}-{s[2]}-N{s[4]}" for s in SHAPES])
def test_plan_fits_and_shares_each_weight_tile(v, config, images, B, N, C, h):
    d = C // h
    took = N <= 128 and d <= 128 and one_window_smem_bytes(N, C, d) <= SMEM
    plan = k6.fwd_plan(B, N, C, h)
    if not took:  # head_dim past 128 (FasterViT-1 and -4 in the tpu configuration)
        assert d > 128
        return
    assert plan is not None and plan.smem <= SMEM
    assert plan.smem == k6.fwd_smem_bytes(N, -(-C // 16) * 16, -(-d // 16) * 16, plan.windows,
                                          plan.heads, plan.chunk, plan.kblocks, plan.stages,
                                          plan.staged)
    assert plan.rows_per_weight_read(N) >= 128
    assert plan.windows * N <= 128 and plan.stages >= 2 and plan.chunk in k6._UNITS
    groups, last = _covers(plan, B)
    assert 1 <= last <= plan.windows and (groups - 1) * plan.windows + last == B
    assert plan.blocks % 2 == 0 and plan.blocks - 2 < groups <= plan.blocks


@pytest.mark.parametrize("B,N,h,d", chip_smoke.K6_TAILS)
def test_tail_sizes_leave_a_partial_group_or_an_empty_block(B, N, h, d):
    plan = k6.fwd_plan(B, N, h * d, h)
    groups, last = _covers(plan, B)
    assert last < plan.windows or plan.blocks > groups


def test_header_table_is_the_plan():
    """The plan table in attn_block.cu's header comment is fwd_plan's."""
    rows = re.findall(r"//\s+(official|tpu) \((\d+), (\d+), (\d+)\)\s+(\d+)\s+(\d+)\s+(\d+)\s+"
                      r"(\d+)\s+(\d+)\s+(\d)\s+(\d+)\s+\(\s*\d+\)\s+([\d,]+)", CSRC.read_text())
    assert len(rows) == 6
    batch = {53: 1024, 16: 256, 49: 256}
    for _, N, C, h, G, HG, NT, KB, stages, staged, per_read, smem in rows:
        N, C, h = int(N), int(C), int(h)
        plan = k6.fwd_plan(batch[N], N, C, h)
        assert (plan.windows, plan.heads, plan.chunk, plan.kblocks, plan.stages, plan.staged,
                plan.smem) == (int(G), int(HG), int(NT), int(KB), int(stages), int(staged),
                               int(smem.replace(",", "")))
        assert plan.rows_per_weight_read(N) == int(per_read)


def _args(N, C, h):
    return [torch.zeros(2, N, C, dtype=torch.bfloat16), torch.zeros(3 * C, C),
            torch.zeros(3 * C), torch.zeros(h, N, N), torch.zeros(C, C), torch.zeros(C)]


@pytest.mark.parametrize("N,C,h,message", [
    (129, 16, 2, "attn_subblock: the kernel takes 1 <= N <= 128 tokens and head_dim <= 128, "
                 "got N=129, head_dim=8"),
    (16, 129, 1, "attn_subblock: the kernel takes 1 <= N <= 128 tokens and head_dim <= 128, "
                 "got N=16, head_dim=129"),
])
def test_cpu_wrapper_refuses_past_the_limits(N, C, h, message):
    assert k6.fwd_plan(2, N, C, h) is None or N > 128 or C // h > 128
    with pytest.raises(ValueError, match=re.escape(message)):
        k6.attn_subblock(*_args(N, C, h), num_heads=h, scale=0.1)
