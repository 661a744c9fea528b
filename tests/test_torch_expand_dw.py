"""K2 port (deepfakedetection_tpu_torch/ops/expand_dw.py) against the JAX
package's Pallas kernel in interpret mode, on the same numpy-seeded bf16
inputs and f32 folded weights. Both round at the same points (bf16 expand
weights with f32 accumulation, the expanded map rounded to bf16 and
zero-padded, taps in f32, the pool over the f32 y before rounding), so the
tolerances are those of tests/test_expand_dw.py: y 5e-2, pool atol 2e-2
rtol 5e-2. Measured at these shapes: max|dy| <= 4e-3 (one bf16 step, on
0.01% of the elements), max|dpool| <= 9e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.ops.pallas.expand_dw import expand_dw_silu_pool as jax_k2
from deepfakedetection_tpu_torch.ops import expand_dw as k2

# (k, H, Cin, Ce): the JAX package's test shapes, then a 7x7 map whose
# channels are not 128-aligned (the JAX wrapper's channel-padding branch)
SHAPES = [(3, 14, 8, 32), (5, 10, 16, 24), (3, 7, 24, 40), (5, 7, 24, 144)]
# EfficientNet-B3 @ 224 shapes that K2 serves: (H, W, Cin, Ce, k)
B3_SHAPES = [
    (56, 56, 32, 192, 3), (28, 28, 48, 288, 5), (14, 14, 96, 576, 3),
    (14, 14, 96, 576, 5), (14, 14, 136, 816, 5), (7, 7, 232, 1392, 5),
    (7, 7, 232, 1392, 3), (7, 7, 384, 2304, 3),
]
ODD_SHAPES = [(9, 11, 32, 192, 5), (30, 33, 24, 144, 5), (1, 1, 8, 48, 5), (13, 10, 20, 42, 3)]


def _inputs(B, H, W, Cin, Ce, k, seed):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(size=(B, H, W, Cin)),
        rng.normal(size=(Cin, Ce)) * 0.3,
        rng.normal(size=(Ce,)) * 0.1,
        rng.normal(size=(k, k, Ce)) * 0.3,
        rng.normal(size=(Ce,)) * 0.1,
    )
    x, *ws = (torch.from_numpy(a.astype(np.float32)) for a in arrays)
    return [x.to(torch.bfloat16), *ws]


@pytest.mark.parametrize("k,H,Cin,Ce", SHAPES)
def test_plain_matches_jax_interpret_kernel(k, H, Cin, Ce):
    args = _inputs(4, H, H, Cin, Ce, k, seed=0)
    jargs = [jnp.asarray(args[0].float().numpy(), jnp.bfloat16)] + [
        jnp.asarray(t.numpy()) for t in args[1:]
    ]
    y_jax, pool_jax = jax_k2(*jargs, kernel=k, interpret=True)
    y, pool = k2.expand_dw_silu_pool_plain(*args, kernel=k)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (4, H, H, Ce)
    assert pool.dtype == torch.float32 and tuple(pool.shape) == (4, Ce)
    np.testing.assert_allclose(
        y.float().numpy(), np.asarray(y_jax, np.float32), atol=5e-2, rtol=5e-2
    )
    np.testing.assert_allclose(pool.numpy(), np.asarray(pool_jax), atol=2e-2, rtol=5e-2)


def test_zero_padding_is_of_the_expanded_map():
    """At a 1x1 map every tap but the centre reads padding: y must equal
    silu(wdw[centre] * e + bdw) with e the expanded pixel, not a value that
    zero-padded x would give (silu(0 @ w + bexp) != 0)."""
    x, wexp, bexp, wdw, bdw = _inputs(2, 1, 1, 8, 48, 5, seed=3)
    y, pool = k2.expand_dw_silu_pool_plain(x, wexp, bexp, wdw, bdw, kernel=5)
    e = torch.nn.functional.silu(x.float() @ wexp.to(torch.bfloat16).float() + bexp)
    e = e.to(torch.bfloat16).float()
    want = torch.nn.functional.silu(e * wdw[2, 2] + bdw)
    torch.testing.assert_close(pool, want.view(2, 48), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float(), atol=0, rtol=0)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    args = _inputs(2, 9, 11, 16, 96, 5, seed=1)
    before = k2.expand_dw_silu_pool.launches
    y, pool = k2.expand_dw_silu_pool(*args, kernel=5)
    y_ref, pool_ref = k2.expand_dw_silu_pool_plain(*args, kernel=5)
    assert torch.equal(y, y_ref) and torch.equal(pool, pool_ref)
    assert k2.expand_dw_silu_pool.launches == before


@pytest.mark.parametrize("change", ["x_f32", "x_strided", "wexp_shape", "wdw_bf16", "k7"])
def test_wrapper_rejects_what_the_kernel_does_not_take(change):
    x, wexp, bexp, wdw, bdw = _inputs(2, 8, 8, 16, 48, 3, seed=2)
    k = 3
    if change == "x_f32":
        x = x.float()
    elif change == "x_strided":
        x = x[:, ::2]
    elif change == "wexp_shape":
        wexp = wexp[:-1]
    elif change == "wdw_bf16":
        wdw = wdw.to(torch.bfloat16)
    else:
        k = 7
    with pytest.raises(ValueError):
        k2.expand_dw_silu_pool(x, wexp, bexp, wdw, bdw, kernel=k)


@pytest.mark.parametrize("H,W,Cin,Ce,k", B3_SHAPES + ODD_SHAPES)
def test_launch_plan_fits_one_block(H, W, Cin, Ce, k):
    p = k2.plan(H, W, Cin, Ce, k)
    assert p.smem_bytes <= k2.MAX_SMEM_BYTES
    assert p.blocks_per_sm == (2 if p.smem_bytes <= k2.TWO_BLOCKS_PER_SM else 1)
    assert k2.THREADS % (p.CB // 2) == 0 and p.items == -(-Ce // p.CB) * 128
    assert p.steps == (1 if p.RB == H else -(-H // p.RB) + 1)
    if max(H, W) <= 7:  # small maps are one band: the whole image expanded once
        assert p.steps == 1
