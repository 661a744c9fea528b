"""K5 forward (deepfakedetection_tpu_torch/ops/window_attn.py) against the JAX
package's window-attention kernels in interpret mode, on the CPU.

The port's plain version, which the wrappers run for CPU tensors, is held
against ``window_mhsa_qkv_pallas`` (the head-masked v2 forward that
FasterViT's ``TokenAttention`` calls, with the JAX side's padding and -1e9
key mask), against ``fused_window_attention_v5`` (the sliced-head forward, on
inputs padded as ``ops/attention.py`` pads them) and, for the v1 layout,
against ``window_mhsa_pallas``. N covers the 16-token carrier-token attention
and FasterViT's 49- and 53-token windows; head_dim the official 48 and the
tpu configuration's 128. Inputs are numpy-seeded bf16.

Tolerance: one bf16 step of the output's scale, 2**(floor(log2 max|ref|) -
7), absolute. Both sides round the probabilities and the output to bf16 once
each, from f32 sums taken in different orders, so a value may land one step
apart; nothing more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.ops.attention import window_mhsa_pallas, window_mhsa_qkv_pallas
from deepfakedetection_tpu.ops.pallas.window_attn import fused_window_attention_v5
from deepfakedetection_tpu_torch.ops import window_attn as k5

CASES = [(N, d) for N in (16, 49, 53) for d in (48, 128)]
HEADS = 2
WINDOWS = 3


def _inputs(N, d, seed):
    rng = np.random.default_rng(seed)
    C = HEADS * d
    qkv = rng.normal(size=(WINDOWS, N, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(HEADS, N, N)).astype(np.float32)
    qkv16 = torch.from_numpy(qkv).to(torch.bfloat16)
    return qkv16, torch.from_numpy(bias), jnp.asarray(qkv16.float().numpy(), jnp.bfloat16)


def _ulp_of_scale(ref: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    tol = _ulp_of_scale(ref)
    err = float(np.abs(got.float().numpy() - ref).max())
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    assert err <= tol, f"max|d|={err:.3e} > one bf16 step of the scale {tol:.3e}"


@pytest.mark.parametrize("N,d", CASES)
def test_plain_matches_jax_masked_forward(N, d):
    qkv, bias, jqkv = _inputs(N, d, seed=N + d)
    scale = d**-0.5
    ref = window_mhsa_qkv_pallas(jqkv, jnp.asarray(bias.numpy()), num_heads=HEADS, scale=scale,
                                 interpret=True)
    _close(k5.window_attention_plain(qkv, bias, num_heads=HEADS, scale=scale), ref)


@pytest.mark.parametrize("N,d", CASES)
def test_plain_matches_jax_sliced_forward(N, d):
    qkv, bias, jqkv = _inputs(N, d, seed=100 + N + d)
    scale = d**-0.5
    Np = -(-N // 16) * 16  # ops/attention.py's padding and key mask
    jq = jnp.pad(jqkv, ((0, 0), (0, Np - N), (0, 0)))
    jb = jnp.pad(jnp.asarray(bias.numpy()), ((0, 0), (0, Np - N), (0, Np - N)))
    jb = jnp.where((jnp.arange(Np) >= N)[None, None, :], -1e9, jb)
    ref = fused_window_attention_v5(jq, jb, num_heads=HEADS, scale=scale, interpret=True)
    _close(k5.window_attention_plain(qkv, bias, num_heads=HEADS, scale=scale), ref[:, :N])


@pytest.mark.parametrize("N,d", [(16, 48), (53, 48), (49, 128)])
def test_heads_layout_matches_jax_v1(N, d):
    qkv, bias, jqkv = _inputs(N, d, seed=200 + N + d)
    scale = d**-0.5
    B, C = WINDOWS, HEADS * d
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, HEADS, d) for i in range(3))
    jq, jk, jv = (jqkv[..., i * C:(i + 1) * C].reshape(B, N, HEADS, d) for i in range(3))
    ref = window_mhsa_pallas(jq, jk, jv, jnp.asarray(bias.numpy()), scale=scale, interpret=True)
    out = k5.window_attention_heads(*(t.transpose(1, 2) for t in (q, k, v)), bias, scale=scale)
    _close(out.transpose(1, 2).reshape(B, N, C), ref)
    # the v1 wrapper and the natural-layout one compute the same function
    torch.testing.assert_close(out.transpose(1, 2).reshape(B, N, C),
                               k5.window_attention(qkv, bias, num_heads=HEADS, scale=scale),
                               atol=0.0, rtol=0.0)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_counts_no_launch():
    qkv, bias, _ = _inputs(53, 48, seed=7)
    before = k5.window_attention.launches
    out = k5.window_attention(qkv, bias, num_heads=HEADS, scale=0.25)
    assert torch.equal(out, k5.window_attention_plain(qkv, bias, num_heads=HEADS, scale=0.25))
    assert k5.window_attention.launches == before


def test_wrapper_takes_a_strided_view_of_qkv():
    qkv, bias, _ = _inputs(49, 48, seed=8)
    wide = torch.zeros(WINDOWS, 49, qkv.shape[-1] + 16, dtype=torch.bfloat16)
    wide[..., 8:-8] = qkv
    view = wide[..., 8:-8]
    assert not view.is_contiguous()
    torch.testing.assert_close(k5.window_attention(view, bias, num_heads=HEADS, scale=0.2),
                               k5.window_attention(qkv, bias, num_heads=HEADS, scale=0.2),
                               atol=0.0, rtol=0.0)


@pytest.mark.parametrize("what", ["f32 qkv", "bias shape", "bias dtype", "too many tokens",
                                  "head split", "feature stride"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    qkv, bias, _ = _inputs(16, 48, seed=9)
    kw = {"num_heads": HEADS, "scale": 0.2}
    if what == "f32 qkv":
        qkv = qkv.float()
    elif what == "bias shape":
        bias = bias[:, :8]
    elif what == "bias dtype":
        bias = bias.double()
    elif what == "too many tokens":
        qkv = torch.zeros(1, 129, 3 * 2 * 8, dtype=torch.bfloat16)
        bias = torch.zeros(2, 129, 129)
    elif what == "head split":
        kw["num_heads"] = 5
    else:
        qkv = qkv.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        k5.window_attention(qkv, bias, **kw)
