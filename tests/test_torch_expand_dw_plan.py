"""K2's launch plan (``deepfakedetection_tpu_torch/ops/expand_dw.plan``, the
mirror of ``choose_plan`` in ``csrc/expand_dw.cu``) at every EfficientNet-B3
shape K2 serves and at odd sizes, with no card: it fits one block's shared
memory, its persistent grid is no larger than the work, its work items and
their steps write each (image, channel, row) of the output exactly once and
expand each row of the map once, and the circular buffer holds the k - 1
rows a band's taps need beyond it. Then a numpy walk of the kernel's
schedule (bands, circular buffer slots, the zero row, the padding columns,
the pool's lanes) against ``expand_dw_silu_pool_plain``, so the arithmetic
the card runs is checked here too. No JAX; seconds.
"""

import numpy as np
import pytest
import torch

from deepfakedetection_tpu_torch.ops import expand_dw as k2

B3_SHAPES = [
    (56, 56, 32, 192, 3), (28, 28, 48, 288, 5), (14, 14, 96, 576, 3),
    (14, 14, 96, 576, 5), (14, 14, 136, 816, 5), (7, 7, 232, 1392, 5),
    (7, 7, 232, 1392, 3), (7, 7, 384, 2304, 3),
]
ODD_SHAPES = [(9, 11, 32, 192, 5), (30, 33, 24, 144, 5), (1, 1, 8, 48, 5), (13, 10, 20, 42, 3)]
CASES = [(s, B) for s in B3_SHAPES + ODD_SHAPES for B in (128, 8)]


def _steps(p, H, k):
    L = k2.layout(H, 1, 16, p.CB, p.RB, k)
    return [k2.band_of(s, H, p.RB, k // 2, L.nb) for s in range(p.steps)]


@pytest.mark.parametrize("shape,B", CASES)
def test_plan_fits_one_block_and_the_grid_the_work(shape, B):
    H, W, Cin, Ce, k = shape
    p = k2.plan(H, W, Cin, Ce, k, B)
    assert p.smem_bytes <= k2.MAX_SMEM_BYTES == 232448
    assert p.smem_bytes == k2.layout(H, W, Cin, p.CB, p.RB, k).smem_bytes
    assert p.blocks_per_sm == (2 if p.smem_bytes <= k2.TWO_BLOCKS_PER_SM else 1)
    assert p.CB in (32, 64) and (p.CB == 32 or Ce > 32)
    assert p.items == -(-Ce // p.CB) * B
    assert p.grid <= min(p.items, p.blocks_per_sm * k2.SMS)
    assert p.grid == min(p.items, p.blocks_per_sm * k2.SMS)  # persistent: one wave of blocks


@pytest.mark.parametrize("shape,B", CASES)
def test_items_cover_each_image_channel_row_once(shape, B):
    H, W, Cin, Ce, k = shape
    p = k2.plan(H, W, Cin, Ce, k, B)
    written = np.zeros((B, -(-Ce // p.CB) * p.CB, H), np.int32)
    expanded = np.zeros_like(written)
    steps = _steps(p, H, k)
    walked = []
    for block in range(p.grid):
        items = k2.block_items(p, block)
        assert len(items) >= 1
        walked += list(items)
        for item in items:
            b, c0 = item % B, (item // B) * p.CB
            for lo, hi, olo, ohi in steps:
                expanded[b, c0:c0 + p.CB, lo:hi] += 1
                written[b, c0:c0 + p.CB, olo:ohi] += 1
    assert walked == list(range(p.items))  # contiguous runs, channel block first
    assert (written == 1).all() and (expanded == 1).all()
    # a block's runs change channel block at most a few times
    changes = max(len({i // B for i in k2.block_items(p, j)}) for j in range(p.grid))
    assert changes <= 2 + p.items // p.grid // B


@pytest.mark.parametrize("shape,B", CASES)
def test_ring_holds_the_rows_the_taps_need(shape, B):
    H, W, Cin, Ce, k = shape
    R = k // 2
    p = k2.plan(H, W, Cin, Ce, k, B)
    if p.steps == 1:  # one band: the whole map is expanded, then the taps run
        assert p.NR == H and p.RB == H
        return
    assert p.NR == p.RB + k - 1 and p.RB >= R
    done = 0  # rows expanded so far in the item
    for lo, hi, olo, ohi in _steps(p, H, k):
        assert lo == done
        done = hi
        if ohi == olo:
            continue
        need_lo, need_hi = max(olo - R, 0), min(ohi + R, H)
        assert need_hi <= hi  # every row the taps read is expanded
        assert hi - need_lo <= p.NR  # ... and still in the buffer (slot r % NR)
    assert done == H


def _walk(x, wexp, bexp, wdw, bdw, k, p):
    """The kernel's walk in numpy: per block its items, per item its steps;
    the expand writes rows into slots r % NR of a buffer with R zero columns
    each side and one zero row; taps of kTW columns read rows outside the
    image from the zero row; each lane sums its pool, the lanes in order."""
    B, H, W, Cin = x.shape
    Ce, R = wexp.shape[1], k // 2
    L = k2.layout(H, W, Cin, p.CB, p.RB, k)
    CB, lanes = p.CB, k2.THREADS // (p.CB // 2)
    pad = -(-Ce // CB) * CB - Ce
    xf = x.float().numpy()
    wb = np.pad(wexp.to(torch.bfloat16).float().numpy(), ((0, 0), (0, pad)))
    be, bd = np.pad(bexp.numpy(), (0, pad)), np.pad(bdw.numpy(), (0, pad))
    wd = np.pad(wdw.numpy(), ((0, 0), (0, 0), (0, pad)))
    y = np.zeros((B, H, W, Ce + pad), np.float32)
    pool = np.zeros((B, Ce + pad), np.float32)
    silu = torch.nn.functional.silu
    for block in range(p.grid):
        ring = np.zeros((L.NR + 1, L.RW, CB), np.float32)  # the last row stays zero
        for item in k2.block_items(p, block):
            b, c0 = item % B, (item // B) * CB
            cs = slice(c0, c0 + CB)
            psum = np.zeros((lanes, CB), np.float32)
            for s in range(L.steps):
                lo, hi, olo, ohi = k2.band_of(s, H, p.RB, R, L.nb)
                for r in range(lo, hi):
                    e = silu(torch.from_numpy(xf[b, r] @ wb[:, cs] + be[cs]))
                    ring[r % L.NR, R:R + W] = e.to(torch.bfloat16).float().numpy()
                for it in range((ohi - olo) * L.segs):
                    yy, x0 = olo + it // L.segs, (it % L.segs) * k2.TW
                    acc = np.zeros((k2.TW, CB), np.float32)
                    for dy in range(k):
                        r = yy + dy - R
                        row = ring[L.NR if r < 0 or r >= H else r % L.NR]
                        for dx in range(k):
                            acc += row[x0 + dx:x0 + dx + k2.TW] * wd[dy, dx, cs]
                    v = silu(torch.from_numpy(acc + bd[cs])).numpy()[:max(0, min(k2.TW, W - x0))]
                    y[b, yy, x0:x0 + len(v), cs] = v
                    psum[it % lanes] += v.sum(0)
            pool[b, cs] = psum.sum(0) / (H * W)
    return torch.from_numpy(y[..., :Ce]).to(torch.bfloat16), torch.from_numpy(pool[:, :Ce])


# (shape, forced (CB, RB) or None for the chosen plan): one band, several
# bands with a short last one, RB = k // 2, ragged segments and channel blocks
WALKS = [((9, 11, 32, 48, 5), None), ((9, 11, 32, 48, 5), (32, 2)), ((13, 10, 20, 42, 3), (64, 4)),
         ((1, 1, 8, 48, 5), None), ((16, 15, 8, 24, 3), (32, 1)), ((12, 14, 24, 72, 5), (64, 5))]


@pytest.mark.parametrize("shape,forced", WALKS)
def test_the_kernels_walk_matches_the_plain_version(shape, forced):
    H, W, Cin, Ce, k = shape
    B = 2
    rng = np.random.default_rng(H * W + Ce)
    x = torch.from_numpy(rng.normal(size=(B, H, W, Cin)).astype(np.float32)).to(torch.bfloat16)
    wexp = torch.from_numpy((rng.normal(size=(Cin, Ce)) * Cin**-0.5).astype(np.float32))
    bexp, bdw = (torch.from_numpy((rng.normal(size=Ce) * 0.1).astype(np.float32)) for _ in "ab")
    wdw = torch.from_numpy((rng.normal(size=(k, k, Ce)) / k).astype(np.float32))
    p = k2.plan(H, W, Cin, Ce, k, B, 3) if forced is None else \
        k2.make_plan(B, H, W, Cin, Ce, k, *forced, 3)
    y, pool = _walk(x, wexp, bexp, wdw, bdw, k, p)
    ry, rpool = k2.expand_dw_silu_pool_plain(x, wexp, bexp, wdw, bdw, kernel=k)
    # f32 sums in another order: at most one bf16 step of y, pool to f32 rounding
    torch.testing.assert_close(y.float(), ry.float(), atol=8e-3, rtol=8e-3)
    torch.testing.assert_close(pool, rpool, atol=1e-5, rtol=1e-5)
