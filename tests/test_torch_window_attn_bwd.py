"""K5 backward (deepfakedetection_tpu_torch/ops/window_attn.py) against the JAX
package's window-attention backward kernels in interpret mode, on the CPU.

The port's plain backward, which ``window_attention_bwd`` runs for CPU
tensors, is held against ``fused_window_attention_v5_bwd`` (the sliced-head
backward, the default of ``window_attention_v2``'s custom_vjp),
``fused_window_attention_v2_bwd`` (lane-masked over the full C) and
``_headed_window_attention_bwd`` (the per-head layout), all on inputs padded
and key-masked as ``ops/attention.py`` pads them (rows to a multiple of 16,
-1e9 on the padded key columns, zero output gradient on the padded rows), and
against ``_xla_window_attention_bwd`` unpadded. N covers the 16-token
carrier-token attention and FasterViT's 49- and 53-token windows; head_dim the
official 48 and the tpu configuration's 128; 2 heads, 3 windows;
numpy-seeded bf16 inputs.

Tolerances. dq, dk and dv: two bf16 steps of each one's own scale,
2 * 2**(floor(log2 max|ref|) - 7), absolute. Both sides round bf16(p),
bf16(ds) and each output once, from f32 sums taken in different orders, so a
rounded ds may land one step apart and move an output by a step (measured at
most a quarter of a step of the scale). dbias: 1e-4 of its scale. It is f32
on both sides, the sum over windows of the unrounded ds, so only summation
order separates them (measured at most 3.3e-7 of the scale; dbias of one
window in three reads 0.67).

The float64 plain backward is held against ``torch.autograd`` of the float64
plain forward to 1e-12 (gradcheck-tight), and the autograd Function against
the plain backward on the CPU, where it counts no kernel launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.ops.pallas.window_attn import (
    _headed_window_attention_bwd,
    _xla_window_attention_bwd,
    fused_window_attention_v2_bwd,
    fused_window_attention_v5_bwd,
)
from deepfakedetection_tpu_torch.ops import window_attn as k5

CASES = [(N, d) for N in (16, 49, 53) for d in (48, 128)]
HEADS = 2
WINDOWS = 3
JAX_BWD = {"v5 (sliced)": fused_window_attention_v5_bwd,
           "v2 (masked)": fused_window_attention_v2_bwd,
           "headed": _headed_window_attention_bwd}
DBIAS_TOL = 1e-4


def _inputs(N, d, seed):
    rng = np.random.default_rng(seed)
    C = HEADS * d
    qkv = torch.from_numpy(rng.normal(size=(WINDOWS, N, 3 * C)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(HEADS, N, N)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(WINDOWS, N, C)).astype(np.float32))
    return qkv.to(torch.bfloat16), bias, dout.to(torch.bfloat16)


def _jnp(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else None)


def _padded(qkv, bias, dout):
    """The JAX wrapper's padding (ops/attention.py:153-163)."""
    N = qkv.shape[1]
    Np = -(-N // 16) * 16
    jq = jnp.pad(_jnp(qkv), ((0, 0), (0, Np - N), (0, 0)))
    jd = jnp.pad(_jnp(dout), ((0, 0), (0, Np - N), (0, 0)))
    jb = jnp.pad(jnp.asarray(bias.numpy()), ((0, 0), (0, Np - N), (0, Np - N)))
    jb = jnp.where((jnp.arange(Np) >= N)[None, None, :], -1e9, jb)
    return jq, jb, jd


def _two_steps(ref: np.ndarray) -> float:
    return float(2.0 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _close(dqkv, dbias, ref_dqkv, ref_dbias):
    ref_dqkv = np.asarray(ref_dqkv, np.float32)
    ref_dbias = np.asarray(ref_dbias, np.float32)
    assert dqkv.dtype == torch.bfloat16 and tuple(dqkv.shape) == ref_dqkv.shape
    assert dbias.dtype == torch.float32 and tuple(dbias.shape) == ref_dbias.shape
    C = ref_dqkv.shape[-1] // 3
    got = dqkv.float().numpy()
    for i, part in enumerate(("dq", "dk", "dv")):
        ref = ref_dqkv[..., i * C:(i + 1) * C]
        err = float(np.abs(got[..., i * C:(i + 1) * C] - ref).max())
        assert err <= _two_steps(ref), f"{part}: max|d|={err:.3e} > {_two_steps(ref):.3e}"
    rel = float(np.abs(dbias.numpy() - ref_dbias).max() / np.abs(ref_dbias).max())
    assert rel <= DBIAS_TOL, f"dbias: max|d|/scale={rel:.3e}"


@pytest.mark.parametrize("kernel", list(JAX_BWD))
@pytest.mark.parametrize("N,d", CASES)
def test_plain_backward_matches_jax_kernels(N, d, kernel):
    qkv, bias, dout = _inputs(N, d, seed=N * d)
    scale = d**-0.5
    jq, jb, jd = _padded(qkv, bias, dout)
    ref_dqkv, ref_dbias = JAX_BWD[kernel](jq, jb, jd, num_heads=HEADS, scale=scale,
                                          interpret=True)
    dqkv, dbias = k5.window_attention_bwd_plain(qkv, bias, dout, num_heads=HEADS, scale=scale)
    _close(dqkv, dbias, ref_dqkv[:, :N], ref_dbias[:, :N, :N])


@pytest.mark.parametrize("N,d", CASES)
def test_plain_backward_matches_jax_xla_backward(N, d):
    qkv, bias, dout = _inputs(N, d, seed=7 + N * d)
    scale = d**-0.5
    ref = _xla_window_attention_bwd(_jnp(qkv), jnp.asarray(bias.numpy()), _jnp(dout),
                                    num_heads=HEADS, scale=scale)
    _close(*k5.window_attention_bwd_plain(qkv, bias, dout, num_heads=HEADS, scale=scale), *ref)


@pytest.mark.parametrize("N,d", [(16, 8), (53, 48)])
def test_float64_plain_backward_is_the_gradient_of_the_plain_forward(N, d):
    g = torch.Generator().manual_seed(N)
    C = HEADS * d
    qkv = torch.randn(WINDOWS, N, 3 * C, generator=g, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(HEADS, N, N, generator=g, dtype=torch.float64, requires_grad=True)
    dout = torch.randn(WINDOWS, N, C, generator=g, dtype=torch.float64)
    out = k5.window_attention_plain(qkv, bias, num_heads=HEADS, scale=d**-0.5)
    want = torch.autograd.grad(out, [qkv, bias], dout)
    got = k5.window_attention_bwd_plain(qkv.detach(), bias.detach(), dout, num_heads=HEADS,
                                        scale=d**-0.5)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_function_runs_the_plain_versions_on_the_cpu_and_counts_no_launch():
    qkv, bias, dout = _inputs(53, 48, seed=3)
    qkv.requires_grad_()
    bias.requires_grad_()
    before = (k5.window_attention.launches, k5.window_attention_bwd.launches)
    out = k5.window_attention(qkv, bias, num_heads=HEADS, scale=0.2)
    assert out.grad_fn is not None
    assert torch.equal(out, k5.window_attention_plain(qkv.detach(), bias.detach(),
                                                      num_heads=HEADS, scale=0.2))
    out.backward(dout)
    want = k5.window_attention_bwd_plain(qkv.detach(), bias.detach(), dout, num_heads=HEADS,
                                         scale=0.2)
    assert torch.equal(qkv.grad, want[0]) and torch.equal(bias.grad, want[1])
    assert float(qkv.grad.float().abs().max()) > 0 and float(bias.grad.abs().max()) > 0
    assert (k5.window_attention.launches, k5.window_attention_bwd.launches) == before


@pytest.mark.parametrize("needs", ["qkv", "bias"])
def test_gradient_reaches_whichever_input_requires_it(needs):
    qkv, bias, dout = _inputs(49, 48, seed=4)
    (qkv if needs == "qkv" else bias).requires_grad_()
    out = k5.window_attention(qkv, bias, num_heads=HEADS, scale=0.2)
    out.backward(dout)
    grad = qkv.grad if needs == "qkv" else bias.grad
    other = bias.grad if needs == "qkv" else qkv.grad
    assert grad is not None and float(grad.float().abs().max()) > 0 and other is None
    with torch.no_grad():  # no autograd record: the raw forward, no graph
        assert k5.window_attention(qkv, bias, num_heads=HEADS, scale=0.2).grad_fn is None


@pytest.mark.parametrize("what", ["f32 dout", "dout shape", "dout stride", "shared memory"])
def test_backward_refuses_what_the_kernel_does_not_take(what):
    qkv, bias, dout = _inputs(16, 48, seed=9)
    if what == "f32 dout":
        dout = dout.float()
    elif what == "dout shape":
        dout = dout[:, :8]
    elif what == "dout stride":
        dout = dout.transpose(1, 2).contiguous().transpose(1, 2)
    else:  # 128 tokens of head_dim 128 need more than a block's 227 KB
        qkv = torch.zeros(1, 128, 3 * 2 * 128, dtype=torch.bfloat16)
        bias = torch.zeros(2, 128, 128)
        dout = torch.zeros(1, 128, 2 * 128, dtype=torch.bfloat16)
        assert k5.bwd_smem_bytes(128, 128) > k5.MAX_SMEM_BYTES > k5.bwd_smem_bytes(53, 128)
    with pytest.raises(ValueError):
        k5.window_attention_bwd(qkv, bias, dout, num_heads=HEADS, scale=0.2)
