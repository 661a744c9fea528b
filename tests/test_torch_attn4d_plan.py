"""K7's launch plan (``deepfakedetection_tpu_torch/ops/attn4d.plan``, the
mirror of ``plan`` in ``csrc/attn4d.cu``) with no card: it equals the plan
table in the kernel's header; at every EfficientFormerV2 variant's K7 shape at
224 px, at batch 256 and 8, a block's shared memory fits (232,448 B) with the
whole image in one row group; it fits at every N from 1 to 128 with heads 1 to
8 and the widths ``chip_smoke.K7_ODD`` uses; ``chip_smoke.py``'s shapes reach
every kind of plan. No JAX; seconds.
"""

import functools
import re

import pytest

from deepfakedetection_tpu_torch.models.efficientformer_v2 import (
    _VARIANTS,
    Attention2d,
    create_efficientformer_v2,
)
from deepfakedetection_tpu_torch.ops import attn4d as k7
from deepfakedetection_tpu_torch.ops import build

SMEM = 232448
SMS = 132  # an H100 SXM's


@functools.lru_cache(maxsize=None)
def k7_shapes(variant: str) -> tuple[tuple[int, int, int, int], ...]:
    """(N, heads, d, dv) of each attention of the variant built at 224 px
    that runs K7."""
    model = create_efficientformer_v2(variant, img_size=224)
    return tuple((a.resolution**2, a.num_heads, a.q.conv.out_channels // a.num_heads,
                  a.dh // a.num_heads) for a in model.modules() if isinstance(a, Attention2d))


def test_plan_matches_the_kernel_header_table():
    text = (build.CSRC / "attn4d.cu").read_text()
    rows = re.findall(r"^//\s+\((\d+), (\d+), (\d+), (\d+), (\d+)\):\s+(\d+)\s+(\d+)\s+(\d+)\s+"
                      r"(\d+)\s+(\d+)$", text, re.M)
    assert len(rows) >= 4
    for row in rows:
        B, N, h, d, dv, *want = map(int, row)
        assert tuple(k7.plan(B, N, h, d, dv, SMS)) == tuple(want)


@pytest.mark.parametrize("B", [256, 8])
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_every_efficientformer_shape_fits_in_one_row_group(variant, B):
    shapes = k7_shapes(variant)
    assert shapes, f"{variant} has no attention that runs K7"
    for N, h, d, dv in shapes:
        p = k7.plan(B, N, h, d, dv, SMS)
        assert p is not None and p.smem <= SMEM
        assert p.tiles == -(-N // 16)  # q, k and v read once an image
        assert p.slots >= 2 and p.images == -(-B // min(B, SMS))
        assert p.blocks * p.images >= B > (p.blocks - 1) * p.images


def _odd_widths() -> list[tuple[int, int]]:
    import chip_smoke

    return sorted({(d, dv) for _, _, _, d, dv in chip_smoke.K7_ODD})


@pytest.mark.parametrize("d,dv", _odd_widths())
def test_every_token_count_and_head_count_has_a_plan(d, dv):
    for N in range(1, 129):
        for h in range(1, 9):
            p = k7.plan(256, N, h, d, dv, SMS)
            assert p is not None, (N, h, d, dv)
            base, slot = k7.layout_bytes(N, h, d, dv, p.tiles)
            assert p.smem == base + p.slots * slot <= SMEM
            assert 1 <= p.slots <= k7.MAX_SLOTS and 1 <= p.tiles <= -(-N // 16)


def test_a_shape_past_shared_memory_has_no_plan():
    assert k7.plan(8, 128, 8, 512, 1024, SMS) is None


def test_phase_ones_shapes_reach_every_kind_of_plan():
    import chip_smoke

    shapes = [s[:5] for s in chip_smoke.K7_SHAPES] + chip_smoke.K7_ODD
    plans = [(s, k7.plan(*s, SMS)) for s in shapes]
    whole = [p.tiles == -(-s[1] // 16) for s, p in plans]
    assert any(whole) and not all(whole)  # one row group an image, and several
    assert any(p.tiles == 1 and s[1] > 16 for s, p in plans)
    assert any(p.slots < s[2] for s, p in plans) and any(p.slots >= s[2] for s, p in plans)
    assert any(p.images > 1 for _, p in plans)
    assert any(p.blocks * p.images > s[0] for s, p in plans)  # a last block with fewer images
    assert {s[1] for s in shapes} >= {17, 48, 49, 65, 128}
    assert any(s[1] > 64 for s in shapes) and any(s[2] < 8 for s in shapes)
