"""K6, the fused attention sub-block (deepfakedetection_tpu_torch/ops/
attn_block.py), against the JAX package's ``attn_subblock`` in interpret
mode, on the CPU.

The port's plain forward, which ``attn_subblock`` runs for CPU tensors, is
held against the JAX wrapper ``window_attn_subblock(..., interpret=True)``
(rows padded to 16, -1e9 on the padded keys, the Pallas kernel in interpret
mode) and against ``attn_subblock_reference`` on the unpadded window, from
the same numpy-seeded inputs: 4 windows, N 16 (the carrier tokens) and 53
(FasterViT's stage-3 window), h x d 4 x 16 and 2 x 48. Tolerance: two bf16
steps of the output's scale, 2 * 2**(floor(log2 max|ref|) - 7), absolute;
every side rounds qkv, the probabilities, ctx and the output once, from f32
sums in different orders.

All six gradients, through ``AttnSubblock`` on the CPU (the plain backward),
against ``jax.grad`` of the interpret-mode kernel, within 4e-2 of each
gradient's scale (the JAX package's own tolerance between its kernel and its
reference, tests/test_attn_block.py). The float64 plain backward against
``torch.autograd`` of the float64 plain forward to 1e-10.

The gates catch wrong variants: the qkv bias added after rounding x Wqkv
(inputs whose qkv cancels a large bias, so the early rounding costs whole
steps) and the bias tensor's heads rolled by one. The wrappers refuse a bad
dtype, a device that is neither the CPU nor CUDA, and sizes past the
kernels' limits.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.ops.attention import window_attn_subblock
from deepfakedetection_tpu.ops.pallas.attn_block import attn_subblock_reference
from deepfakedetection_tpu_torch.ops import attn_block as k6
from deepfakedetection_tpu_torch.ops.window_attn import window_attention_plain

WINDOWS = 4
CASES = [(N, h, d) for N in (16, 53) for h, d in ((4, 16), (2, 48))]
GRAD_TOL = 4e-2
NAMES = ("dx", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj")


def _inputs(N, h, d, seed, offset=0.0):
    """numpy-seeded (x bf16, Wqkv [C, 3C], bqkv, bias [h, N, N], Wproj [C, C],
    bproj), the weights in the JAX kernel's [in, out] layout. ``offset``
    shifts x and sets bqkv to cancel it in x Wqkv (the rounding-order test)."""
    rng = np.random.default_rng(seed)
    C = h * d
    x = (rng.normal(size=(WINDOWS, N, C)) + offset).astype(np.float32)
    wqkv = (rng.normal(size=(C, 3 * C)) * C**-0.5).astype(np.float32)
    bqkv = (rng.normal(size=3 * C) * 0.1 - offset * wqkv.sum(0)).astype(np.float32)
    bias = rng.normal(size=(h, N, N)).astype(np.float32)
    wproj = (rng.normal(size=(C, C)) * C**-0.5).astype(np.float32)
    bproj = (rng.normal(size=C) * 0.1).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, wqkv, bqkv, bias, wproj, bproj


def _jax_args(inputs):
    x, *rest = inputs
    return (jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, rest))


def _port_args(inputs):
    """The same tensors for the port: x bf16, the weights as nn.Linear holds
    them ([out, in])."""
    x, wqkv, bqkv, bias, wproj, bproj = (torch.from_numpy(np.array(a)) for a in inputs)
    return x.to(torch.bfloat16), wqkv.t().contiguous(), bqkv, bias, wproj.t().contiguous(), bproj


def _jax_kernel(inputs, h, scale):
    return window_attn_subblock(*_jax_args(inputs), num_heads=h, scale=scale, interpret=True)


def _two_steps(ref) -> float:
    return 2.0 * 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


def _f32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("N,h,d", CASES)
def test_plain_forward_matches_the_jax_kernel_and_reference(N, h, d):
    inputs = _inputs(N, h, d, seed=N + d)
    scale = d**-0.5
    kernel = _f32(_jax_kernel(inputs, h, scale))
    reference = _f32(attn_subblock_reference(*_jax_args(inputs), num_heads=h, scale=scale))
    before = k6.attn_subblock.launches
    got = _f32(k6.attn_subblock(*_port_args(inputs), num_heads=h, scale=scale))
    assert k6.attn_subblock.launches == before  # the CPU runs the plain version
    for want in (kernel, reference):
        tol = _two_steps(want)
        assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("N,h,d", CASES)
def test_gradients_match_the_jax_kernel(N, h, d):
    inputs = _inputs(N, h, d, seed=2 * N + d)
    scale = d**-0.5
    w = np.random.default_rng(7).normal(size=(WINDOWS, N, h * d)).astype(np.float32)

    def loss(*a):
        out = window_attn_subblock(*a, num_heads=h, scale=scale, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w)

    want = jax.grad(loss, argnums=tuple(range(6)))(*_jax_args(inputs))
    # the JAX weights are [in, out]: their gradients transposed are the port's
    want = [_f32(g) for g in want]
    want[1], want[4] = want[1].T, want[4].T
    args = [t.requires_grad_() for t in _port_args(inputs)]
    before = k6.attn_subblock_bwd.launches
    out = k6.attn_subblock(*args, num_heads=h, scale=scale)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert k6.attn_subblock_bwd.launches == before
    for name, a, g in zip(NAMES, args, want):
        assert a.grad.dtype == a.dtype, name  # f32 gradients for the f32 weights
        s = max(float(np.abs(g).max()), 1e-3)
        err = float(np.abs(_f32(a.grad) - g).max()) / s
        assert err <= GRAD_TOL, (name, err)


def test_float64_backward_matches_autograd():
    rng = np.random.default_rng(3)
    N, h, d = 11, 3, 5
    C = h * d
    shapes = [(2, N, C), (3 * C, C), (3 * C,), (h, N, N), (C, C), (C,)]
    args = [torch.from_numpy(rng.normal(size=s) * (0.3 if len(s) == 2 else 1.0))
            .requires_grad_() for s in shapes]
    out = k6.attn_subblock_plain(*args, num_heads=h, scale=d**-0.5)
    g = torch.from_numpy(rng.normal(size=out.shape))
    auto = torch.autograd.grad(out, args, g)
    mine = k6.attn_subblock_bwd_plain(*[a.detach() for a in args[:5]], g, num_heads=h,
                                      scale=d**-0.5)
    for name, a, b in zip(NAMES, auto, mine):
        assert b.dtype == torch.float64
        torch.testing.assert_close(b, a, atol=1e-10, rtol=0, msg=name)


def _bias_after_rounding(x, wqkv, bqkv, bias, wproj, bproj, *, num_heads, scale):
    acc = torch.float32
    qkv = ((x.to(acc) @ wqkv.to(torch.bfloat16).to(acc).t()).to(torch.bfloat16).to(acc)
           + bqkv).to(torch.bfloat16)
    ctx = window_attention_plain(qkv, bias, num_heads=num_heads, scale=scale)
    return k6._dense(ctx, wproj, bproj, torch.bfloat16)


def _heads_rolled(x, wqkv, bqkv, bias, wproj, bproj, *, num_heads, scale):
    return k6.attn_subblock_plain(x, wqkv, bqkv, bias.roll(1, 0), wproj, bproj,
                                  num_heads=num_heads, scale=scale)


@pytest.mark.parametrize("wrong,offset", [(_bias_after_rounding, 24.0), (_heads_rolled, 0.0)])
def test_the_gate_catches_wrong_variants(wrong, offset):
    N, h, d = 53, 2, 48
    inputs = _inputs(N, h, d, seed=11, offset=offset)
    want = _f32(_jax_kernel(inputs, h, d**-0.5))
    tol = _two_steps(want)
    args = _port_args(inputs)
    sound = _f32(k6.attn_subblock(*args, num_heads=h, scale=d**-0.5))
    bad = _f32(wrong(*args, num_heads=h, scale=d**-0.5))
    assert np.abs(sound - want).max() <= tol
    assert np.abs(bad - want).max() > 2 * tol


def test_wrappers_refuse_what_the_kernels_do_not_take():
    args = list(_port_args(_inputs(16, 2, 16, seed=1)))
    with pytest.raises(ValueError, match="bf16"):
        k6.attn_subblock(args[0].float(), *args[1:], num_heads=2, scale=0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        k6.attn_subblock(*[a.to("meta") for a in args], num_heads=2, scale=0.25)
    dout = torch.zeros(WINDOWS, 16, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dout must be bf16"):
        k6.attn_subblock_bwd(*args[:5], dout.float(), num_heads=2, scale=0.25)
    long = list(_port_args(_inputs(129, 1, 8, seed=2)))
    with pytest.raises(ValueError, match="N <= 128"):
        k6.attn_subblock(*long, num_heads=1, scale=0.25)

    def wide(C, h):
        return [torch.zeros(1, 49, C, dtype=torch.bfloat16), torch.zeros(3 * C, C),
                torch.zeros(3 * C), torch.zeros(h, 49, 49), torch.zeros(C, C), torch.zeros(C)]

    # C 2,048: one window's x alone fills a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        k6.attn_subblock(*wide(2048, 16), num_heads=16, scale=0.1)
    # FasterViT-4's stage 4 (C 1,568, 32 heads): the forward fits, the backward does not
    assert k6.attn_subblock(*wide(1568, 32), num_heads=32, scale=0.1).shape == (1, 49, 1568)
    t = wide(1568, 32)
    with pytest.raises(ValueError, match="shared memory"):
        k6.attn_subblock_bwd(*t[:5], t[0], num_heads=32, scale=0.1)
