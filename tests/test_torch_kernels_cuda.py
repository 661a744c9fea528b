"""The port's CUDA kernels against their plain PyTorch versions on the card
(bf16), at the EfficientNet-B3 @ 224 shapes of the main path and at odd
sizes: ragged tiles, a map smaller than the halo, and channel counts off the
kernels' vector widths. Tolerances are the JAX package's kernel tests':
K1 y 3e-2 / pool 2e-3, K2 y 5e-2 / pool atol 2e-2 rtol 5e-2; K1 repeats bit
for bit and computes the plan its Python mirror does. K4 (the shear
rotation, one launch) at the B3 fine-tune canvas, the shear's angle bounds,
odd sizes and a zero angle: bit-identical to the plain version (both round
the same f32 operations at the same points), the plan its mirror's. K5 (window attention) at the four FasterViT-2
shapes of the eval path (64 windows each), at ragged and small token counts,
head_dims off the 16-byte loads, many windows a block in every pipeline its
launch plan picks, a strided view that takes the kernel's one-element path,
and the v1 [B, h, N, d] layout: within two bf16 steps of the output's scale
(both sides round the probabilities and the output once, from f32 sums taken
in different orders), bit-identical over two runs, its plan the built
library's. K5's backward at the same shapes: dq, dk
and dv within two bf16 steps of each one's scale, dbias within 1e-3 of its
scale (f32 on both sides, summed over the windows in other orders), and
bit-identical dbias and dqkv over two runs; the autograd Function launches
the forward once and the backward once. K5's long kernels (past 128
tokens) at FasterViT-2's stage 4 at 448, 560 and 672 px and odd sizes, to the
same tolerances, bit-identical over two runs, their plans the built
library's, counted on their own counters. K7 (talking-head attention) at
EfficientFormerV2-S1's shape and at ragged and small sizes: within two bf16
steps of the output's scale, bit-identical over two runs, its plan the
built library's, at every kind of plan; it refuses a gradient, and a
full-width S1 forward launches it four times. K7's long kernel at S1's
384 and 512 px shapes and odd sizes likewise. K6 (the fused
attention sub-block) at a FasterViT-2 stage-3 shape and an odd one: the
output and dx within two bf16 steps of their scales, the f32 gradients within
1e-2 of theirs, the backward's six outputs bit-identical over two runs; the
autograd Function launches each once; sizes past the limits raise. K3 (the
whole MBConv+SE block) at B3's six K3 shapes and odd sizes: within two bf16
steps of the output's scale, bit-identical over two runs; a narrow B3 built
with ``DFD_FUSED_MBCONV`` launches it three times a forward. K2 also repeats
bit for bit over two runs, and its launch plan is the built library's. The
int8 depthwise conv of the int8 eval: its int32 accumulator bit-exact, its
activated bf16 output within one bf16 step of the plain version.

Needs a CUDA card and imports no JAX, so it runs on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``;
elsewhere every case skips.
"""

import math

import numpy as np
import pytest
import torch

from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2
from deepfakedetection_tpu_torch.ops import attn4d as k7
from deepfakedetection_tpu_torch.ops import depthwise_se as k1
from deepfakedetection_tpu_torch.ops import expand_dw as k2
from deepfakedetection_tpu_torch.ops import fused_mbconv as k3
from deepfakedetection_tpu_torch.ops import shear_rotate as k4
from deepfakedetection_tpu_torch.ops import window_attn as k5

K1_SHAPES = [
    (112, 112, 40, 3), (112, 112, 24, 3),  # B3 stage 0
    (7, 7, 256, 5), (14, 14, 128, 3), (9, 11, 128, 5), (37, 45, 72, 3), (13, 10, 20, 5),
]
K2_SHAPES = [
    (56, 56, 32, 192, 3), (28, 28, 48, 288, 5), (14, 14, 96, 576, 3),
    (14, 14, 96, 576, 5), (14, 14, 136, 816, 5), (7, 7, 232, 1392, 5),
    (7, 7, 232, 1392, 3), (7, 7, 384, 2304, 3),  # every B3 stride-1 expand block
    (9, 11, 32, 192, 5), (30, 33, 24, 144, 5), (1, 1, 8, 48, 5), (13, 10, 20, 42, 3),
]

BOUND = 0.23911  # 13.7 degrees in radians, the augmentation's shear limit
K4_CASES = [
    # (B, H, W, max_theta, largest |angle|); angles drawn within +-largest
    (128, 257, 257, 0.17453, 0.17453),  # B3 fine-tune canvas, the recipe's 10 degrees
    (16, 257, 257, BOUND, BOUND),
    (16, 96, 96, 0.45, 0.45),
    (8, 37, 45, 0.2, 0.2),
    (8, 45, 37, 0.45, 0.45),
    (8, 33, 31, 0.2, 0.0),  # zero angle: the identity
]


K5_CASES = [
    # (windows, N, heads, d)
    (64, 53, 8, 48), (64, 49, 16, 48),  # FasterViT-2 official, stages 3 and 4
    (64, 53, 3, 128), (64, 49, 6, 128),  # the tpu configuration
    (8, 16, 8, 48), (8, 1, 2, 16), (8, 100, 2, 64), (8, 128, 1, 128), (8, 53, 8, 8),
    (8, 37, 3, 100), (8, 20, 2, 4),
    # many windows a block in every pipeline the forward's plan picks: warps
    # without a query tile (N <= 48), two tiles a warp (N > 64), the
    # element-by-element copies, two and four warp groups, rings of 4, 3, 2
    # and 1 slots a group
    (512, 37, 3, 100), (512, 16, 8, 48), (1024, 33, 4, 64), (2048, 20, 2, 4), (512, 80, 2, 16),
    (512, 100, 4, 64), (1024, 128, 2, 32), (192, 128, 8, 128),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(rng, shape, scale, device):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,k", K1_SHAPES)
def test_depthwise_silu_pool_kernel_matches_plain(cuda, H, W, C, k):
    rng = np.random.default_rng(H + C)
    x = _randn(rng, (8, H, W, C), 1.0, cuda).to(torch.bfloat16)
    w, b = _randn(rng, (k, k, C), 1.0 / k, cuda), _randn(rng, (C,), 0.1, cuda)
    before = k1.depthwise_silu_pool.launches
    y, pool = k1.depthwise_silu_pool(x, w, b, k=k)
    again = k1.depthwise_silu_pool(x, w, b, k=k)
    torch.cuda.synchronize()
    assert k1.depthwise_silu_pool.launches == before + 2
    assert torch.equal(again[0], y) and torch.equal(again[1], pool)  # no atomics
    sms = k2.sm_count(x.device)
    assert k1.kernel_plan(8, H, W, C, k, sms) == k1.plan(8, H, W, C, k, sms)
    y_ref, pool_ref = k1.depthwise_silu_pool_plain(x, w, b, k=k)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(pool, pool_ref, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,Cin,Ce,k", K2_SHAPES)
def test_expand_dw_silu_pool_kernel_matches_plain(cuda, H, W, Cin, Ce, k):
    rng = np.random.default_rng(H + Ce)
    x = _randn(rng, (8, H, W, Cin), 1.0, cuda).to(torch.bfloat16)
    wexp, bexp = _randn(rng, (Cin, Ce), Cin ** -0.5, cuda), _randn(rng, (Ce,), 0.1, cuda)
    wdw, bdw = _randn(rng, (k, k, Ce), 1.0 / k, cuda), _randn(rng, (Ce,), 0.1, cuda)
    before = k2.expand_dw_silu_pool.launches
    y, pool = k2.expand_dw_silu_pool(x, wexp, bexp, wdw, bdw, kernel=k)
    again = k2.expand_dw_silu_pool(x, wexp, bexp, wdw, bdw, kernel=k)
    torch.cuda.synchronize()
    assert k2.expand_dw_silu_pool.launches == before + 2
    assert torch.equal(again[0], y) and torch.equal(again[1], pool)  # no atomics
    sms = k2.sm_count(x.device)
    assert k2.kernel_plan(8, H, W, Cin, Ce, k, sms) == k2.plan(H, W, Cin, Ce, k, 8, sms)
    y_ref, pool_ref = k2.expand_dw_silu_pool_plain(x, wexp, bexp, wdw, bdw, kernel=k)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(pool, pool_ref, atol=2e-2, rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,max_theta,largest", K4_CASES)
def test_rotate_batch_kernel_matches_plain(cuda, B, H, W, max_theta, largest):
    g = torch.Generator().manual_seed(H * W + B)
    x = torch.rand(B, H, W, 3, generator=g).to(torch.bfloat16).to(cuda)
    thetas = ((torch.rand(B, generator=g) * 2 - 1) * largest).to(cuda)
    if largest:
        thetas[0], thetas[-1] = largest, -largest
    before = k4.rotate_batch.launches
    y = k4.rotate_batch(x, thetas, max_theta=max_theta)
    torch.cuda.synchronize()
    assert k4.rotate_batch.launches == before + 1  # the three shears in one launch
    assert k4.kernel_plan(H, W, 3, max_theta) == k4.plan(H, W, 3, max_theta)
    ref = k4.rotate_batch_plain(x, thetas, max_theta=max_theta)
    assert torch.equal(y, ref)  # each pass rounds as the plain version does
    if not largest:
        assert torch.equal(y, x)


def _k5_inputs(B, N, h, d, device, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3 * h * d, generator=g).to(torch.bfloat16).to(device)
    bias = torch.randn(h, N, N, generator=g).to(device)
    return qkv, bias


def _k5_close(got, ref):
    scale = float(ref.float().abs().max())
    tol = 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, f"max|d| {err:.3e} > {tol:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,d", K5_CASES)
def test_window_attention_kernel_matches_plain(cuda, B, N, h, d):
    qkv, bias = _k5_inputs(B, N, h, d, cuda, seed=N * d + h)
    sms = k5.sm_count(qkv.device)
    assert k5.kernel_fwd_plan(B, N, h, d, sms) == k5.fwd_plan(B, N, h, d, sms)
    before = k5.window_attention.launches
    out = k5.window_attention(qkv, bias, num_heads=h, scale=d**-0.5)
    again = k5.window_attention(qkv, bias, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert k5.window_attention.launches == before + 2
    assert torch.equal(again, out)  # no race between the ring's slots
    _k5_close(out, k5.window_attention_plain(qkv, bias, num_heads=h, scale=d**-0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 512])
def test_window_attention_kernel_takes_an_unaligned_view(cuda, B):
    qkv, bias = _k5_inputs(B, 53, 8, 48, cuda, seed=5)
    wide = torch.zeros(B, 53, qkv.shape[-1] + 2, dtype=torch.bfloat16, device=cuda)
    wide[..., 1:-1] = qkv
    out = k5.window_attention(wide[..., 1:-1], bias, num_heads=8, scale=48**-0.5)
    again = k5.window_attention(wide[..., 1:-1], bias, num_heads=8, scale=48**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(again, out)
    _k5_close(out, k5.window_attention_plain(qkv, bias, num_heads=8, scale=48**-0.5))


@pytest.mark.cuda
def test_window_attention_heads_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(32, 4, 53, 48, generator=g).to(torch.bfloat16).to(cuda)
               for _ in range(3))
    bias = torch.randn(4, 53, 53, generator=g).to(cuda)
    before = k5.window_attention_heads.launches
    out = k5.window_attention_heads(q, k, v, bias, scale=0.15)
    torch.cuda.synchronize()
    assert k5.window_attention_heads.launches == before + 1
    _k5_close(out, k5.window_attention_heads_plain(q, k, v, bias, scale=0.15))


K5_BWD_CASES = K5_CASES[:4] + [(8, 16, 8, 48), (8, 1, 2, 16), (8, 100, 2, 64), (8, 128, 1, 64),
                               (8, 53, 8, 8), (8, 37, 3, 100), (8, 20, 2, 4)] + [
    # many windows a block: row warps without a tile, the shared dbias sum,
    # the shallow-ring plans, the element-by-element copies
    (512, 37, 3, 100), (512, 16, 8, 48), (512, 33, 4, 64), (512, 20, 2, 4), (256, 100, 2, 64),
    (256, 128, 1, 80), (512, 128, 2, 32)]


def _k5_bwd_close(got, want):
    (dqkv, dbias), (ref_qkv, ref_bias) = got, want
    C = ref_qkv.shape[-1] // 3
    for i in range(3):
        ref = ref_qkv[..., i * C:(i + 1) * C].float()
        top = float(ref.abs().max())
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
        err = float((dqkv[..., i * C:(i + 1) * C].float() - ref).abs().max())
        assert err <= tol, f"{'qkv'[i]}: max|d| {err:.3e} > {tol:.3e}"
    err, top = float((dbias - ref_bias).abs().max()), float(ref_bias.abs().max())
    assert dbias.dtype == torch.float32 and err <= 1e-3 * top, f"dbias {err:.3e} of {top:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,d", K5_BWD_CASES)
def test_window_attention_bwd_kernel_matches_plain_and_repeats(cuda, B, N, h, d):
    qkv, bias = _k5_inputs(B, N, h, d, cuda, seed=N * d + h + 1)
    g = torch.Generator().manual_seed(N + d)
    dout = torch.randn(B, N, h * d, generator=g).to(torch.bfloat16).to(cuda)
    before = k5.window_attention_bwd.launches
    got = k5.window_attention_bwd(qkv, bias, dout, num_heads=h, scale=d**-0.5)
    again = k5.window_attention_bwd(qkv, bias, dout, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert k5.window_attention_bwd.launches == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _k5_bwd_close(got, k5.window_attention_bwd_plain(qkv, bias, dout, num_heads=h,
                                                     scale=d**-0.5))


@pytest.mark.cuda
def test_window_attention_function_runs_both_kernels(cuda):
    qkv, bias = _k5_inputs(32, 53, 8, 48, cuda, seed=11)
    qkv.requires_grad_()
    bias.requires_grad_()
    dout = torch.randn(32, 53, 384, generator=torch.Generator().manual_seed(12)).to(cuda)
    before = (k5.window_attention.launches, k5.window_attention_bwd.launches)
    out = k5.window_attention(qkv, bias, num_heads=8, scale=48**-0.5)
    out.backward(dout.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert (k5.window_attention.launches, k5.window_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _k5_bwd_close((qkv.grad, bias.grad), k5.window_attention_bwd_plain(
        qkv.detach(), bias.detach(), dout.to(torch.bfloat16), num_heads=8, scale=48**-0.5))


K5_LONG_CASES = [
    # (windows, N, heads, d): FasterViT-2's stage 4 at 448 px in both head
    # configurations, at 560 px (324 tokens) and 672 px (441), and odd sizes
    # (256 at d 128, the old kernels' limits; a head_dim off the 16-wide tiles)
    (64, 196, 16, 48), (32, 196, 6, 128), (16, 256, 16, 48), (8, 129, 2, 64), (8, 197, 3, 40),
    (8, 208, 1, 128), (8, 324, 16, 48), (4, 441, 6, 128), (8, 256, 6, 128), (8, 257, 2, 40),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,d", K5_LONG_CASES)
def test_window_attention_long_kernels_match_plain_and_repeat(cuda, B, N, h, d):
    """Past 128 tokens the wrappers launch ``csrc/window_attn_long.cu``'s
    forward and backward (counted there, not on the short kernels), within
    the short kernels' tolerances, bit-identical over two runs, their plans
    the built library's."""
    qkv, bias = _k5_inputs(B, N, h, d, cuda, seed=N * d + h + 2)
    sms = k5.sm_count(qkv.device)
    assert k5.kernel_long_fwd_plan(B, N, h, d, sms) == k5.long_fwd_plan(B, N, h, d, sms)
    assert k5.kernel_long_bwd_plan(B, N, h, d, sms) == k5.long_bwd_plan(B, N, h, d, sms)
    counts = (k5.window_attention.launches, k5.window_attention_long.launches,
              k5.window_attention_bwd.launches, k5.window_attention_long_bwd.launches)
    out = k5.window_attention(qkv, bias, num_heads=h, scale=d**-0.5)
    again = k5.window_attention(qkv, bias, num_heads=h, scale=d**-0.5)
    dout = torch.randn(B, N, h * d, generator=torch.Generator().manual_seed(N)).to(
        torch.bfloat16).to(cuda)
    got = k5.window_attention_bwd(qkv, bias, dout, num_heads=h, scale=d**-0.5)
    twice = k5.window_attention_bwd(qkv, bias, dout, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert (k5.window_attention.launches, k5.window_attention_long.launches,
            k5.window_attention_bwd.launches, k5.window_attention_long_bwd.launches) == (
        counts[0], counts[1] + 2, counts[2], counts[3] + 2)
    assert torch.equal(again, out) and torch.equal(got[0], twice[0])
    assert torch.equal(got[1], twice[1])
    _k5_close(out, k5.window_attention_plain(qkv, bias, num_heads=h, scale=d**-0.5))
    _k5_bwd_close(got, k5.window_attention_bwd_plain(qkv, bias, dout, num_heads=h,
                                                     scale=d**-0.5))


K7_CASES = [
    # (B, N, heads, d, dv)
    (64, 49, 8, 32, 128),  # EfficientFormerV2-S1's 7x7 attention
    (8, 25, 4, 16, 64), (8, 16, 8, 32, 128), (8, 1, 2, 16, 8), (8, 100, 3, 32, 40),
    (8, 128, 8, 16, 16), (8, 64, 8, 32, 128),
    # every kind of plan: several row groups (one tile each at N 128), rings
    # shallower and deeper than the heads, more images than SMs with a last
    # block that takes fewer
    (300, 49, 8, 32, 128), (133, 17, 5, 16, 24), (8, 48, 6, 32, 64), (8, 65, 8, 32, 128),
    (8, 128, 8, 32, 128), (20, 49, 1, 16, 8), (150, 128, 3, 16, 40),
]


def _k7_inputs(B, N, h, d, dv, device, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = [torch.randn(B, N, h * c, generator=g).to(torch.bfloat16) for c in (d, d, dv)]
    tables = [torch.randn(h, N, N, generator=g) * 0.5, torch.randn(h, h, generator=g) * 0.5,
              torch.randn(h, generator=g) * 0.1, torch.randn(h, h, generator=g) * 0.5,
              torch.randn(h, generator=g) * 0.1]
    return [t.to(device) for t in qkv + tables]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,d,dv", K7_CASES)
def test_attn4d_kernel_matches_plain_and_repeats(cuda, B, N, h, d, dv):
    sms = k2.sm_count(cuda)
    assert k7.plan(B, N, h, d, dv, sms) == k7.kernel_plan(B, N, h, d, dv, sms)
    args = _k7_inputs(B, N, h, d, dv, cuda, seed=N * dv + h)
    before = k7.attn4d.launches
    out = k7.attn4d(*args, num_heads=h, scale=d**-0.5)
    again = k7.attn4d(*args, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert k7.attn4d.launches == before + 2
    assert torch.equal(out, again)
    _k5_close(out, k7.attn4d_plain(*args, num_heads=h, scale=d**-0.5))


K7_LONG_CASES = [
    # (B, N, heads, d, dv): S1 at 384 and 512 px, odd sizes, fewer heads, dv % 16 == 8;
    # past 256 tokens: 257, S1 at 544 and 640 px, 1,024 tokens, an odd head count
    (64, 144, 8, 32, 128), (8, 256, 8, 32, 128), (8, 129, 8, 32, 128), (8, 197, 8, 32, 128),
    (8, 150, 3, 16, 40), (8, 257, 8, 32, 128), (8, 289, 8, 32, 128), (16, 400, 8, 32, 128),
    (2, 1024, 8, 32, 128), (4, 300, 5, 32, 72),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,d,dv", K7_LONG_CASES)
def test_attn4d_long_kernel_matches_plain_and_repeats(cuda, B, N, h, d, dv):
    sms = k2.sm_count(cuda)
    assert k7.long_plan(B, N, h, d, dv, sms) == k7.kernel_long_plan(B, N, h, d, dv, sms)
    args = _k7_inputs(B, N, h, d, dv, cuda, seed=N * dv + h + 1)
    before = (k7.attn4d.launches, k7.attn4d_long.launches)
    out = k7.attn4d(*args, num_heads=h, scale=d**-0.5)
    again = k7.attn4d(*args, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert (k7.attn4d.launches, k7.attn4d_long.launches) == (before[0], before[1] + 2)
    assert torch.equal(out, again)
    _k5_close(out, k7.attn4d_plain(*args, num_heads=h, scale=d**-0.5))


@pytest.mark.cuda
def test_attn4d_kernel_takes_unaligned_views(cuda):
    args = _k7_inputs(16, 49, 8, 32, 128, cuda, seed=13)
    wide = torch.zeros(16, 49, 514, dtype=torch.bfloat16, device=cuda)
    wide[..., 1:257], wide[..., 257:513] = args[0], args[1]
    out = k7.attn4d(wide[..., 1:257], wide[..., 257:513], *args[2:], num_heads=8,
                    scale=32**-0.5)
    torch.cuda.synchronize()
    _k5_close(out, k7.attn4d_plain(*args, num_heads=8, scale=32**-0.5))


@pytest.mark.cuda
def test_attn4d_refuses_a_gradient(cuda):
    args = _k7_inputs(2, 49, 8, 32, 128, cuda, seed=14)
    args[0].requires_grad_()
    with pytest.raises(ValueError, match="inference-only"):
        k7.attn4d(*args, num_heads=8, scale=32**-0.5)


@pytest.mark.cuda
def test_efficientformer_forward_launches_k7_four_times(cuda, monkeypatch):
    """The bf16 forward on the card runs K7 and never its plain version."""
    from deepfakedetection_tpu_torch.models import efficientformer_v2 as efv2

    def refuse(*args, **kw):
        raise AssertionError("the bf16 forward on the card ran attn4d_plain")

    monkeypatch.setattr(k7, "attn4d_plain", refuse)
    monkeypatch.setattr(efv2, "attn4d_plain", refuse)
    model = create_efficientformer_v2("s1", generator=torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = k7.attn4d.launches
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    assert k7.attn4d.launches == before + 4
    assert out.shape == (2, 2) and bool(torch.isfinite(out).all())


K6_CASES = [
    # (windows, N, heads, d): a FasterViT-2 official stage-3 window, and an odd
    # size (N past 64, a head_dim and C off the 16-byte loads, C 123 odd)
    (64, 53, 8, 48), (8, 100, 3, 41),
    # the forward's last, partial window group and the cluster's empty block
    # (chip_smoke.K6_TAILS)
    (1, 53, 8, 48), (3, 53, 8, 48), (1023, 53, 8, 48), (250, 16, 8, 48),
    # the backward's: a cluster's empty block, a partial last window group, a
    # partial last head group (chip_smoke.K6_BWD_TAILS)
    (511, 53, 8, 48), (127, 49, 16, 48), (65, 53, 3, 128),
    # FasterViT-4's stage 4 (C 1,568, 32 heads), which the backward takes since
    # its redesign
    (2, 49, 32, 49),
]
K6_GRAD_TOL = 1e-2  # dW, db, dbias: max|d| over the scale (chip_smoke.K6_BWD_TOL)


def _k6_inputs(B, N, h, d, device, seed):
    rng = np.random.default_rng(seed)
    C = h * d
    x = _randn(rng, (B, N, C), 1.0, device).to(torch.bfloat16)
    weights = [_randn(rng, (3 * C, C), C**-0.5, device), _randn(rng, (3 * C,), 0.1, device),
               _randn(rng, (h, N, N), 1.0, device), _randn(rng, (C, C), C**-0.5, device),
               _randn(rng, (C,), 0.1, device)]
    dout = _randn(rng, (B, N, C), 1.0, device).to(torch.bfloat16)
    return [x, *weights], dout


def _two_steps(ref):
    top = float(ref.float().abs().max())
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,d", K6_CASES)
def test_attn_subblock_kernels_match_plain_and_repeat(cuda, B, N, h, d):
    from deepfakedetection_tpu_torch.ops import attn_block as k6

    args, dout = _k6_inputs(B, N, h, d, cuda, seed=N + d)
    before = (k6.attn_subblock.launches, k6.attn_subblock_bwd.launches)
    out = k6.attn_subblock(*args, num_heads=h, scale=d**-0.5)
    grads = k6.attn_subblock_bwd(*args[:5], dout, num_heads=h, scale=d**-0.5)
    again = k6.attn_subblock_bwd(*args[:5], dout, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert (k6.attn_subblock.launches, k6.attn_subblock_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    ref = k6.attn_subblock_plain(*args, num_heads=h, scale=d**-0.5)
    assert float((out.float() - ref.float()).abs().max()) <= _two_steps(ref)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))  # bit-identical
    refs = k6.attn_subblock_bwd_plain(*args[:5], dout, num_heads=h, scale=d**-0.5)
    for name, got, want in zip(("dx", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"), grads,
                               refs):
        err = float((got.float() - want.float()).abs().max())
        tol = _two_steps(want) if name == "dx" else K6_GRAD_TOL * float(want.abs().max())
        assert err <= tol, f"{name}: max|d| {err:.3e} > {tol:.3e}"


@pytest.mark.cuda
def test_attn_subblock_function_runs_both_kernels(cuda):
    from deepfakedetection_tpu_torch.ops import attn_block as k6

    args, dout = _k6_inputs(16, 49, 6, 128, cuda, seed=5)
    args = [a.requires_grad_() for a in args]
    before = (k6.attn_subblock.launches, k6.attn_subblock_bwd.launches)
    out = k6.attn_subblock(*args, num_heads=6, scale=128**-0.5)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (k6.attn_subblock.launches, k6.attn_subblock_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert [a.grad.dtype for a in args] == [torch.bfloat16] + [torch.float32] * 5


@pytest.mark.cuda
def test_attn_subblock_refuses_sizes_past_its_limits(cuda):
    from deepfakedetection_tpu_torch.ops import attn_block as k6

    args, dout = _k6_inputs(2, 129, 2, 16, cuda, seed=6)
    with pytest.raises(ValueError, match="N <= 128"):
        k6.attn_subblock(*args, num_heads=2, scale=0.25)
    args, dout = _k6_inputs(1, 49, 16, 128, cuda, seed=7)  # C 2,048: x fills a block
    with pytest.raises(ValueError, match="shared memory"):
        k6.attn_subblock_bwd(*args[:5], dout, num_heads=16, scale=128**-0.5)


K3_CASES = [
    # (B, H, W, C, k): the six B3 K3 shapes, then odd sizes (H off the tiles,
    # a 1 x 1 map, Cse 1, C 4, 13, 20 and 22 off the 16-byte loads and 4-byte
    # pairs; with the six, every projection plan: wgmma BN 32, 48, 64, 128,
    # 144, 192, one or two column tiles, and the mma.sync kernel where Cmid %
    # 8 != 0), then one B3 shape at batch 128 (many 128-row tiles)
    (8, 56, 56, 32, 3), (8, 28, 28, 48, 5), (8, 14, 14, 96, 3), (8, 14, 14, 136, 5),
    (8, 7, 7, 232, 5), (8, 7, 7, 384, 3),
    (8, 10, 12, 24, 5), (8, 1, 1, 16, 5), (8, 6, 6, 4, 3), (8, 9, 11, 22, 3), (8, 5, 7, 13, 5),
    (8, 13, 16, 64, 3), (8, 9, 10, 192, 3), (8, 7, 9, 200, 5), (8, 30, 30, 20, 5),
    (128, 14, 14, 136, 5),
]


def _k3_inputs(B, H, W, C, k, device, seed):
    rng = np.random.default_rng(seed)
    Cmid, Cse = 6 * C, max(C // 4, 1)
    x = _randn(rng, (B, H, W, C), 1.0, device).to(torch.bfloat16)
    return [x, _randn(rng, (C, Cmid), C**-0.5, device), _randn(rng, (Cmid,), 0.1, device),
            _randn(rng, (k, k, Cmid), 1.0 / k, device), _randn(rng, (Cmid,), 0.1, device),
            _randn(rng, (Cmid, Cse), Cmid**-0.5, device), _randn(rng, (Cse,), 0.1, device),
            _randn(rng, (Cse, Cmid), Cse**-0.5, device), _randn(rng, (Cmid,), 0.1, device),
            _randn(rng, (Cmid, C), Cmid**-0.5, device), _randn(rng, (C,), 0.1, device)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,k", K3_CASES)
def test_fused_mbconv_se_kernel_matches_plain_and_repeats(cuda, B, H, W, C, k):
    args = _k3_inputs(B, H, W, C, k, cuda, seed=H * C + k)
    before = k3.fused_mbconv_se.launches
    out = k3.fused_mbconv_se(*args, kernel=k)
    again = k3.fused_mbconv_se(*args, kernel=k)
    torch.cuda.synchronize()
    assert k3.fused_mbconv_se.launches == before + 2
    assert torch.equal(out, again)
    ref = k3.fused_mbconv_se_plain(*args, kernel=k)
    torch.testing.assert_close(out.float(), ref.float(), atol=_two_steps(ref), rtol=0)


def _k3_block(args, k, device, monkeypatch):
    """A bf16 eval MBConv block (in == out, expand 6, stride 1) built with
    DFD_FUSED_MBCONV whose folded weights are K3's operands ``args``
    (BatchNorms at unit scale, zero mean, variance 1 - eps: the fold
    multiplies by exactly 1)."""
    from deepfakedetection_tpu_torch.models.efficientnet import BlockArgs, MBConv

    w_exp, b_exp, w_dw, b_dw, w_r, b_r, w_e, b_e, w_p, b_p = (t.cpu() for t in args)
    C, r = w_exp.shape[0], k // 2
    monkeypatch.setenv("DFD_FUSED_MBCONV", "1")
    blk = MBConv(BlockArgs(C, C, 6, k, 1, 0.25, 0.0, ((r, r), (r, r))))
    with torch.no_grad():
        for conv, bn, w, b in ((blk._expand_conv, blk._bn0, w_exp.t(), b_exp),
                               (blk._depthwise_conv, blk._bn1, w_dw.permute(2, 0, 1), b_dw),
                               (blk._project_conv, blk._bn2, w_p.t(), b_p)):
            conv.weight.copy_(w.reshape(conv.weight.shape))
            bn.weight.fill_(1.0)
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0 - bn.eps)
            bn.bias.copy_(b)
        blk._se_reduce.weight.copy_(w_r.t().reshape(blk._se_reduce.weight.shape))
        blk._se_reduce.bias.copy_(b_r)
        blk._se_expand.weight.copy_(w_e.t().reshape(blk._se_expand.weight.shape))
        blk._se_expand.bias.copy_(b_e)
    return blk.to(device).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,k", K3_CASES)
def test_fused_mbconv_se_plan_is_the_kernels_and_an_mbconv_block_gives_its_output(
        cuda, monkeypatch, B, H, W, C, k):
    """The built library's projection plan is the Python mirror's, and an
    MBConv block built with the switch (weights packed once, in its cache)
    gives the wrapper's output bit for bit, twice."""
    args = _k3_inputs(B, H, W, C, k, cuda, seed=H * C + k)
    assert k3.kernel_plan(C, 6 * C) == k3.choose_plan(C, 6 * C)
    out = k3.fused_mbconv_se(*args, kernel=k)
    block = _k3_block(args[1:], k, cuda, monkeypatch)
    x = args[0].permute(0, 3, 1, 2)
    with torch.no_grad():
        first, second = block(x), block(x)
    torch.cuda.synchronize()
    assert torch.equal(first.permute(0, 2, 3, 1), out)
    assert torch.equal(second, first)


@pytest.mark.cuda
def test_b3_with_the_switch_launches_k3_on_the_card(cuda, monkeypatch):
    """A narrow bf16 EfficientNet built with DFD_FUSED_MBCONV runs K3 three
    times a forward on the card and never its plain version, and agrees with
    its own CPU run (plain versions) within the logit gate of
    tests/test_torch_efficientnet.py (1.5e-2 of the scale)."""
    from deepfakedetection_tpu_torch.models import efficientnet

    monkeypatch.setenv("DFD_FUSED_MBCONV", "1")
    narrow = dict(num_classes=2, width_coefficient=0.25, depth_coefficient=0.5,
                  native_resolution=32)
    model = efficientnet.EfficientNet(**narrow, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.eval()(x).float()

    def refuse(*args, **kw):
        raise AssertionError("the bf16 forward on the card ran fused_mbconv_se_plain")

    monkeypatch.setattr(k3, "fused_mbconv_se_plain", refuse)
    model = model.to(cuda)
    before = k3.fused_mbconv_se.launches
    with torch.no_grad():
        out = model(x.to(cuda)).float().cpu()
    torch.cuda.synchronize()
    assert k3.fused_mbconv_se.launches == before + 3
    assert float((out - want).abs().max()) <= 1.5e-2 * float(want.abs().max())


# the int8 depthwise conv (ops/int8_dw.py): B3's and S1's kinds of shape,
# asymmetric pads, channel counts off 4 (the byte-wise path) and one channel
INT8_DW_CASES = [
    (112, 112, 144, 3, 2, ((0, 1), (0, 1)), "silu"), (7, 7, 1392, 5, 1, ((2, 2), (2, 2)), "silu"),
    (56, 56, 128, 3, 1, ((1, 1), (1, 1)), "gelu_tanh"), (14, 14, 512, 3, 2, ((1, 1), (1, 1)), "none"),
    (9, 11, 13, 5, 2, ((1, 2), (2, 1)), "gelu_erf"), (5, 4, 1, 3, 1, ((1, 1), (1, 1)), "silu"),
    (17, 19, 6, 3, 2, ((0, 0), (1, 1)), "none"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,k,s,pads,act", INT8_DW_CASES)
def test_int8_depthwise_kernel_matches_plain(cuda, H, W, C, k, s, pads, act):
    """The int32 accumulator bit-exact (no activation, scale 1, bias 0, f32
    out), the activated bf16 output within one bf16 step of the f32 plain
    version, one launch counted a call."""
    from deepfakedetection_tpu_torch.ops import int8_dw

    g = torch.Generator().manual_seed(H + C)
    xq = torch.randint(-127, 128, (4, H, W, C), generator=g, dtype=torch.int8).to(cuda)
    wq = torch.randint(-127, 128, (k, k, C), generator=g, dtype=torch.int8).to(cuda)
    scale = (torch.rand(C, generator=g) * 2e-4 + 1e-5).to(cuda)
    bias = (torch.randn(C, generator=g) * 0.5).to(cuda)
    before = int8_dw.int8_depthwise.launches
    acc = int8_dw.int8_depthwise(xq, wq, torch.ones_like(scale), torch.zeros_like(bias),
                                 stride=s, pads=pads, out_dtype=torch.float32)
    y = int8_dw.int8_depthwise(xq, wq, scale, bias, stride=s, pads=pads, act=act)
    torch.cuda.synchronize()
    assert int8_dw.int8_depthwise.launches == before + 2
    assert torch.equal(acc.to(torch.int32), int8_dw.int8_depthwise_acc_plain(
        xq, wq, stride=s, pads=pads))
    ref = int8_dw.int8_depthwise_plain(xq, wq, scale, bias, stride=s, pads=pads, act=act,
                                       out_dtype=torch.float32)
    assert bool(((y.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-6).all())
