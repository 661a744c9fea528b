"""K3's launch plan (``deepfakedetection_tpu_torch/ops/fused_mbconv.plan``:
K2's plan, then the projection's, the mirror of ``choose_plan`` in
``csrc/fused_mbconv.cu``) with no card: it equals the plan table in the
kernel's header; at every stride-1, in == out expansion block of
EfficientNet-B0 to B7 at 224 px, of B3 at its 300 px and at the 160 px of
``config/train_imagenette.yaml``, at batch 128 and 8, each kernel's shared
memory fits one block (232,448 B) and the projection takes the tile rule;
large maps have plans; ``chip_smoke.py``'s shapes reach every projection
plan. No JAX; seconds.
"""

import math
import re

import pytest

from deepfakedetection_tpu_torch.models.efficientnet import _BASE_BLOCKS, _VARIANTS, make_divisible
from deepfakedetection_tpu_torch.ops import build
from deepfakedetection_tpu_torch.ops import expand_dw as k2
from deepfakedetection_tpu_torch.ops import fused_mbconv as k3

SMEM = 232448

# the models and sizes K3's plan is held to: B0-B7 at 224 px, B3 at its 300 px
# and at config/train_imagenette.yaml's 160
MODELS = [(f"b{i}", 224) for i in range(8)] + [("b3", 300), ("b3", 160)]


def residual_blocks(variant: str, size: int) -> list[tuple[int, int, int, int]]:
    """(H, W, C, k) of an EfficientNet variant's stride-1, in == out blocks
    with an expansion at ``size`` px: each stage's blocks after its first, at
    the stage's map size (SAME padding: ceil at each stride)."""
    width, depth, _, _ = _VARIANTS[variant]
    side, shapes = math.ceil(size / 2), []
    for expand, channels, repeats, stride, kernel in _BASE_BLOCKS:
        side = math.ceil(side / stride)
        if expand != 1 and math.ceil(depth * repeats) > 1:
            shapes.append((side, side, make_divisible(channels * width, 8), kernel))
    return shapes


CASES = sorted({(shape, f"{variant}@{size}") for variant, size in MODELS
                for shape in residual_blocks(variant, size)})


def test_the_b3_shapes_are_phase_ones():
    import chip_smoke

    assert residual_blocks("b3", 224) == [s[:4] for s in chip_smoke.K3_SHAPES]


def test_plan_matches_the_kernel_header_table():
    text = (build.CSRC / "fused_mbconv.cu").read_text()
    rows = re.findall(r"^//\s+(\d+) x\s+(\d+) x\s+(\d+) k(\d): (wgmma|mma) (\d+) (\d+) (\d+)$",
                      text, re.M)
    assert [tuple(map(int, r[:4])) for r in rows] == residual_blocks("b3", 224)
    for H, W, C, k, proj, BN, tiles, smem in rows:
        assert k3.choose_plan(int(C), 6 * int(C)) == (proj, int(BN), int(tiles), int(smem))


def _cost(C, w):
    return -(-C // w) * (w + 32)


@pytest.mark.parametrize("B", [128, 8])
@pytest.mark.parametrize("shape,model", CASES)
def test_every_efficientnet_plan_fits(shape, model, B):
    H, W, C, k = shape
    p = k3.plan(B, H, W, C, 6 * C, k)
    assert p.k2 == k2.plan(H, W, C, 6 * C, k, B) and p.k2.smem_bytes <= SMEM
    # every EfficientNet width takes wgmma, with the cheapest tile of the rule
    assert p.proj == "wgmma" and p.BN in k3.PROJ_WIDTHS
    assert p.tiles == -(-C // p.BN) and p.tiles * p.BN >= C
    assert all(_cost(C, p.BN) <= _cost(C, w) for w in k3.PROJ_WIDTHS)
    assert p.smem_bytes == k3.proj_smem(p.BN) <= SMEM
    assert p.kernels()[0] == "expand_dw_kernel" and p.kernels()[-1] == "gated_proj_kernel"


@pytest.mark.parametrize("shape", [(80, 80, 32, 3), (150, 150, 32, 3), (75, 75, 48, 5)])
def test_a_large_map_has_a_plan_that_fits(shape):
    """Maps past B3 @ 224's (B3 @ 300's stage 2, and larger): K2 walks them
    in bands of rows, and the projection's plan does not depend on the map."""
    H, W, C, k = shape
    p = k3.plan(128, H, W, C, 6 * C, k)
    assert p.k2.smem_bytes <= SMEM and p.k2.RB < H
    assert (p.proj, p.BN, p.tiles, p.smem_bytes) == k3.choose_plan(C, 6 * C)


def test_widths_off_the_16_byte_rows_take_the_mma_kernel():
    for C in (13, 22, 7):  # Cmid = 6C, not a multiple of 8
        assert k3.choose_plan(C, 6 * C) == ("mma", k3.MMA_COLS, -(-C // k3.MMA_COLS), 0)
    assert k3.choose_plan(4, 24)[0] == "wgmma"


def test_phase_ones_shapes_reach_every_projection_plan():
    import chip_smoke

    shapes = [s[:4] for s in chip_smoke.K3_SHAPES] + chip_smoke.K3_ODD
    plans = {k3.choose_plan(C, 6 * C)[:3] for _, _, C, _ in shapes}
    assert {p[1] for p in plans if p[0] == "wgmma"} == set(k3.PROJ_WIDTHS)
    assert any(p[0] == "wgmma" and p[2] > 1 for p in plans)
    assert any(p[0] == "mma" for p in plans)
