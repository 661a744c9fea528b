"""K1's launch plan (``depthwise_se.plan``, the Python mirror of ``make_plan``
in deepfakedetection_tpu_torch/ops/csrc/depthwise_se.cu) on the CPU: it fits
one block's shared memory and threads at B3's two stage-0 shapes, at
``chip_smoke.K1_ODD`` and at every channel count up to 384 at k 3 and 5;
every unit of a band has a thread and no thread idles a whole round; a
block's items cover every (image, channel block) once; the plan table in the
kernel's header is the mirror's. The card holds the built kernel's plan to
the mirror (``chip_smoke.py`` phase 1). No JAX, seconds.
"""

import re
from pathlib import Path

import pytest

from deepfakedetection_tpu_torch.ops import depthwise_se as k1

B3 = [(112, 112, 40, 3), (112, 112, 24, 3)]  # EfficientNet-B3 @ 224, stage 0
ODD = [(9, 11, 128, 5), (37, 45, 72, 3), (13, 10, 20, 5)]  # chip_smoke.K1_ODD


def _check(p: k1.Plan, B, H, W, C, k):
    assert p.smem <= k1.MAX_SMEM_BYTES
    assert p.threads == p.T * p.G <= k1.MAX_THREADS
    units = p.RB * -(-W // k1.NPX)  # a band's units of one 4-channel group
    rounds = -(-units // p.T)
    assert rounds * p.T >= units > (rounds - 1) * p.T  # balanced: no idle round
    assert p.bands * p.RB >= H > (p.bands - 1) * p.RB
    assert p.NR == 2 * p.RB + k - 1  # a band read while the next arrives
    assert p.items == B * -(-C // p.CB) and 1 <= p.grid <= min(p.items, k1.SMS)
    covered = [i for blk in range(p.grid)
               for i in range(blk * p.items // p.grid, (blk + 1) * p.items // p.grid)]
    assert covered == list(range(p.items))


@pytest.mark.parametrize("B", [8, 64, 128])
@pytest.mark.parametrize("H,W,C,k", B3 + ODD)
def test_plan_fits_b3_and_odd_sizes(B, H, W, C, k):
    _check(k1.plan(B, H, W, C, k), B, H, W, C, k)


@pytest.mark.parametrize("k", [3, 5])
def test_plan_fits_every_channel_count(k):
    for C in range(1, 385):
        for H, W in ((112, 112), (7, 7), (1, 1), (30, 33)):
            _check(k1.plan(8, H, W, C, k), 8, H, W, C, k)


def test_header_plan_table():
    src = (Path(k1.__file__).parent / "csrc" / "depthwise_se.cu").read_text()
    rows = re.findall(r"\[128, 112, 112, (\d+)\] k3: RB (\d+), (\d+) threads a group, (\d+) "
                      r"threads, (\d+) items", src)
    assert len(rows) == 2
    for C, RB, T, threads, items in rows:
        p = k1.plan(128, 112, 112, int(C), 3)
        assert (p.RB, p.T, p.threads, p.items) == (int(RB), int(T), int(threads), int(items))
