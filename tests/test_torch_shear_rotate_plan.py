"""K4's fused kernel (deepfakedetection_tpu_torch/ops/csrc/shear_rotate.cu) on
the CPU: its launch plan (``shear_rotate.plan``, the Python mirror of the
kernel's ``make_plan``), and a numpy walk of its tiles that computes each
output tile only from what the plan stages: the (segment, row) pieces of
the input, read as the 16-byte chunks that cover them with zeros outside
the image row, then the three passes in the kernel's buffers, whose
never-written elements hold NaN. The walk must equal ``rotate_batch_plain``
bit for bit at every geometry ``chip_smoke.K4_CASES`` sends to the card;
the card then holds the built kernel to the same plan and output. No JAX,
seconds.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepfakedetection_tpu_torch.ops import shear_rotate as k4

R = k4.ROWS_PER_BLOCK
F32 = np.float32
# (B, H, W, max_theta, largest |angle|): chip_smoke.K4_CASES' geometries at a small batch
CASES = [(2, 257, 257, 0.17453, 0.17453), (2, 257, 257, 0.23911, 0.23911),
         (3, 96, 96, 0.45, 0.45), (3, 37, 45, 0.2, 0.2), (3, 45, 37, 0.45, 0.45),
         (2, 33, 31, 0.2, 0.0)]


def _shear(k, center, r, taps):
    """The kernel's ``shear_of`` over an int array of rows, in float32."""
    r = np.asarray(r, np.int64)
    r0 = (r // R) * R
    s_first = F32(k) * (r0.astype(F32) - F32(center))
    s_last = F32(k) * ((r0 + R - 1).astype(F32) - F32(center))
    m0 = np.clip(np.floor(np.minimum(s_first, s_last)), -(1 << 20), 1 << 20).astype(np.int64)
    frac = F32(k) * (r.astype(F32) - F32(center)) - m0.astype(F32)
    ka = np.floor(frac).astype(np.int64)
    use = (((ka >= 0) & (ka < taps)) * 1) | (((ka >= -1) & (ka < taps - 1)) * 2)
    w0 = np.maximum(F32(0), F32(1) - np.abs(frac - ka.astype(F32)))
    w1 = np.maximum(F32(0), F32(1) - np.abs(frac - (ka + 1).astype(F32)))
    return m0, ka, use, w0, w1


def _blend(use, w0, w1, v0, v1):
    acc = np.where(use & 1, F32(0) + w0 * v0, F32(0)).astype(F32)
    acc = np.where(use & 2, acc + w1 * v1, acc).astype(F32)
    return torch.from_numpy(acc).to(torch.bfloat16).float().numpy()


def emulate(imgs: torch.Tensor, thetas: torch.Tensor, max_theta: float, shift: int = 0):
    """K4's fused kernel, tile by tile, with x's element e at aligned index
    e + shift (a base address ``shift`` elements past a 16-byte boundary)."""
    B, H, W, C = imgs.shape
    p = k4.plan(H, W, C, max_theta)
    taps_x, taps_y = k4.taps(max_theta)
    (a, cy, _, _), (bc, cx, _, _), _ = k4._passes(thetas, H, W, max_theta)
    flat = imgs.float().reshape(-1).numpy()
    out = np.full(flat.size, np.nan, F32)
    WC = W * C
    for b in range(B):
        ak, bk = F32(a[b]), F32(bc[b])
        for ty in range(p.tiles_y):
            for tx in range(p.tiles_x):
                y0, x0 = ty * R, tx * p.TW
                th, tw = min(R, H - y0), min(p.TW, W - x0)
                W2, H1 = tw + taps_x - 1, th + taps_y - 1
                NE = W2 * C
                x2lo = x0 + int(_shear(ak, cy, [y0], taps_x)[0][0])
                clo, chi = max(0, -x2lo), min(W2, W - x2lo)
                kb0 = (x2lo + clo) // R if clo < chi else 0
                nseg = (x2lo + chi - 1) // R - kb0 + 1 if clo < chi else 0
                assert nseg <= p.nb and W2 <= p.W2 and H1 <= p.H1 and NE <= p.NE
                s0 = np.full(p.H1 * p.row0, np.nan, F32)  # S0, then S2 over it
                s1 = np.full(p.H1 * p.NE, np.nan, F32)
                so = 0
                for i in range(nseg):  # pass 1, segment by segment
                    cs = max(clo, (kb0 + i) * R - x2lo)
                    ce = min(chi, (kb0 + i + 1) * R - x2lo)
                    e = np.arange(cs * C, ce * C)
                    m2 = int(_shear(bk, cx, [(kb0 + i) * R], taps_y)[0][0])
                    rows = y0 + m2 + np.arange(H1)
                    m1, ka1, use1, w0, w1 = _shear(ak, cy, np.clip(rows, 0, H - 1), taps_x)
                    for r in range(H1):
                        if not (0 <= rows[r] < H and use1[r]):
                            s1[r * NE + e] = 0.0
                            continue
                        lo = (b * H + rows[r]) * WC + shift
                        g = lo + (x2lo + cs + m1[r] + ka1[r]) * C
                        g8 = (g // 8) * 8
                        nch = -(-(g - g8 + (ce - cs + 1) * C) // 8)
                        idx = g8 + np.arange(8 * nch)
                        inside = (idx >= lo) & (idx < lo + WC)
                        slot = r * p.row0 + so
                        assert so + 8 * nch <= p.row0
                        s0[slot:slot + 8 * nch] = np.where(
                            inside, flat[np.clip(idx - shift, 0, flat.size - 1)], F32(0))
                        base = slot + (g - g8) - cs * C
                        s1[r * NE + e] = _blend(use1[r], w0[r], w1[r], s0[base + e],
                                                s0[base + e + C])
                    so += -(-(7 + (ce - cs + 1) * C) // 8) * 8
                # pass 2 into S0's space: one element column at a time down the rows
                e = np.arange(NE)
                cols = x2lo + e // C
                _, ka2, use2, w0, w1 = _shear(bk, cx, np.clip(cols, 0, W - 1), taps_y)
                use2 = np.where((cols >= 0) & (cols < W), use2, 0)
                for y in range(th):
                    v0 = s1[np.clip(y + ka2, 0, H1 - 1) * NE + e]
                    v1 = s1[np.clip(y + ka2 + 1, 0, H1 - 1) * NE + e]
                    s0[y * NE + e] = _blend(use2, w0, w1, v0, v1)
                # pass 3 into the output
                e = np.arange(tw * C)
                _, ka3, use3, w0, w1 = _shear(ak, cy, y0 + np.arange(th), taps_x)
                for y in range(th):
                    v0 = s0[y * NE + np.clip(e + ka3[y] * C, 0, NE - 1)]
                    v1 = s0[y * NE + np.clip(e + (ka3[y] + 1) * C, 0, NE - 1)]
                    out[(b * H + y0 + y) * WC + x0 * C + e] = _blend(use3[y], w0[y], w1[y], v0,
                                                                     v1)
    return torch.from_numpy(out.reshape(B, H, W, C)).to(torch.bfloat16)


def _inputs(B, H, W, largest, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, H, W, 3, generator=g).to(torch.bfloat16)
    thetas = (torch.rand(B, generator=g) * 2 - 1) * largest
    if largest:
        thetas[0], thetas[-1] = largest, -largest
    return x, thetas


@pytest.mark.parametrize("B,H,W,max_theta,largest", CASES)
def test_tile_walk_is_the_plain_rotation(B, H, W, max_theta, largest):
    x, thetas = _inputs(B, H, W, largest, seed=H * W + B)
    want = k4.rotate_batch_plain(x, thetas, max_theta=max_theta)
    got = emulate(x, thetas, max_theta, shift=(H + W) % 8)
    assert torch.equal(got, want)  # NaN anywhere would mean a read of an unstaged element


def test_tile_walk_past_the_angle_bound_drops_taps_as_the_plain_version():
    """Angles past max_theta change no buffer size: taps past the count are
    dropped, as the plain version drops them."""
    x, thetas = _inputs(2, 70, 90, 0.4, seed=7)
    want = k4.rotate_batch_plain(x, thetas, max_theta=0.1)
    assert torch.equal(emulate(x, thetas, 0.1), want)


@pytest.mark.parametrize("H,W", [(257, 257), (96, 96), (37, 45), (45, 37), (33, 31), (224, 224),
                                 (1, 1), (300, 517), (64, 31)])
@pytest.mark.parametrize("C", [1, 3, 4])
@pytest.mark.parametrize("max_theta", [0.0, 0.17453, 0.23911, 0.45])
def test_plan_fits_one_block(H, W, C, max_theta):
    p = k4.plan(H, W, C, max_theta)
    taps_x, taps_y = k4.taps(max_theta)
    assert p.smem <= k4.MAX_SMEM_BYTES
    assert 1 <= p.TW <= W and p.tiles_x * p.TW >= W > (p.tiles_x - 1) * p.TW
    assert p.tiles_y * R >= H > (p.tiles_y - 1) * R
    assert p.W2 == p.TW + taps_x - 1 and p.H1 == R + taps_y - 1
    assert p.threads % 32 == 0 and p.threads <= k4.MAX_THREADS
    assert p.NE <= k4.MAX_THREADS or p.TW == 1  # one element column a thread
    assert 2 * p.row0 * p.H1 >= 2 * R * p.NE  # pass 2's buffer fits in the staged input's


def test_header_plan_table():
    """The plan quoted in the kernel's header is the mirror's."""
    src = (Path(k4.__file__).parent / "csrc" / "shear_rotate.cu").read_text()
    m = re.search(r"\[128, 257, 257, 3\] at 10 degrees \(taps (\d+), (\d+)\): TW (\d+), (\d+) x "
                  r"(\d+) tiles an\s*//\s*image, W2 (\d+), H1 (\d+), nb (\d+), (\d+) threads, "
                  r"([\d,]+) bytes", src)
    assert m, "the plan line of shear_rotate.cu's header"
    p = k4.plan(257, 257, 3, 0.17453)
    got = [int(v.replace(",", "")) for v in m.groups()]
    assert got == [*k4.taps(0.17453), p.TW, p.tiles_x, p.tiles_y, p.W2, p.H1, p.nb, p.threads,
                   p.smem]
