"""K1 port (deepfakedetection_tpu_torch/ops/depthwise_se.py) against the JAX
package's Pallas kernel in interpret mode, on the same numpy-seeded bf16
inputs and f32 folded weights. Both round at the same points (taps and bias
in f32, y rounded to bf16, the pool is the mean of the rounded y), so the
tolerances are those of tests/test_depthwise_se.py: y atol = rtol = 3e-2,
pool 2e-3. Measured at these shapes: max|dy| <= 1e-3 (one bf16 step, from f32
summation order), max|dpool| <= 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.ops.pallas.depthwise_se import depthwise_silu_pool as jax_k1
from deepfakedetection_tpu_torch.ops import depthwise_se as k1

SHAPES = [(7, 7, 256, 5), (14, 14, 128, 3), (9, 11, 128, 5)]
# EfficientNet-B3 @ 224 shapes that K1 serves (stage 0), plus ragged tiles
B3_SHAPES = [(112, 112, 40, 3), (112, 112, 24, 3)]


def _inputs(B, H, W, C, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(k, k, C)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    x_bf16 = torch.from_numpy(x).to(torch.bfloat16)
    return x_bf16, torch.from_numpy(w), torch.from_numpy(b)


@pytest.mark.parametrize("H,W,C,k", SHAPES)
def test_plain_matches_jax_interpret_kernel(H, W, C, k):
    x, w, b = _inputs(4, H, W, C, k, seed=k + H)
    y_jax, pool_jax = jax_k1(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), H=H, W=W, k=k, interpret=True,
    )
    y, pool = k1.depthwise_silu_pool_plain(x, w, b, k=k)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (4, H, W, C)
    assert pool.dtype == torch.float32 and tuple(pool.shape) == (4, C)
    np.testing.assert_allclose(
        y.float().numpy(), np.asarray(y_jax, np.float32), atol=3e-2, rtol=3e-2
    )
    np.testing.assert_allclose(pool.numpy(), np.asarray(pool_jax), atol=2e-3, rtol=2e-3)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    x, w, b = _inputs(2, 9, 11, 24, 3, seed=0)
    before = k1.depthwise_silu_pool.launches
    y, pool = k1.depthwise_silu_pool(x, w, b, k=3)
    y_ref, pool_ref = k1.depthwise_silu_pool_plain(x, w, b, k=3)
    assert torch.equal(y, y_ref) and torch.equal(pool, pool_ref)
    assert k1.depthwise_silu_pool.launches == before


@pytest.mark.parametrize(
    "change",
    ["x_f32", "x_nchw_view", "w_bf16", "b_shape", "k4"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(change):
    x, w, b = _inputs(2, 8, 8, 16, 3, seed=1)
    k = 3
    if change == "x_f32":
        x = x.float()
    elif change == "x_nchw_view":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif change == "w_bf16":
        w = w.to(torch.bfloat16)
    elif change == "b_shape":
        b = b[:-1]
    else:
        k = 4
    with pytest.raises(ValueError):
        k1.depthwise_silu_pool(x, w, b, k=k)


@pytest.mark.parametrize("H,W,C,k", B3_SHAPES + SHAPES + [(37, 45, 72, 3), (13, 10, 20, 5)])
def test_launch_plan_fits_one_block(H, W, C, k):
    p = k1.plan(128, H, W, C, k)
    assert p.smem <= k1.MAX_SMEM_BYTES
    assert p.CB == min(C, 64) and p.G == -(-p.CB // 8) * 2 and p.items == -(-C // p.CB) * 128
    assert 1 <= p.RB <= min(H, k1.MAX_RB) and p.NR == 2 * p.RB + k - 1
    assert p.T * p.G == p.threads <= k1.MAX_THREADS and p.grid == min(p.items, k1.SMS)
