"""K7 (deepfakedetection_tpu_torch/ops/attn4d.py) against the JAX package's
talking-head attention, on the CPU.

The port's plain version, which the wrapper runs for CPU tensors, is held
(a) in bf16 against ``attn4d_pallas(..., interpret=True)``, the TPU kernel in
    interpret mode, at the shapes of ``tests/test_pallas_attention.py``:
    EfficientFormerV2-S1's (N 49, 8 heads, d 32, dv 128) and a ragged one
    (N 25, 4 heads, d 16, dv 64). Tolerance: one bf16 step of the output's
    scale, 2**(floor(log2 max|ref|) - 7), absolute. Both sides round p2 and
    the output to bf16 once each, from f32 sums in different orders;
(b) in float32 against the JAX model's XLA einsum chain at
    ``jax_default_matmul_precision("highest")``: 1e-5 of the output's scale
    (f32 sums in different orders);
(c) in float64 against an independent numpy einsum of the same function:
    1e-12 of the scale.
Wrong variants (the th2 bias dropped, th1 transposed, th2 applied before the
softmax's normalisation) must fall outside (a)'s tolerance, so the inputs
give each part of the function an effect. Inputs are numpy-seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.ops.pallas.attn4d import attn4d_pallas
from deepfakedetection_tpu_torch.ops import attn4d as k7

SHAPES = [(4, 49, 8, 32, 128), (2, 25, 4, 16, 64)]  # (B, N, h, d, dv)


def _inputs(B, N, h, d, dv, seed):
    """numpy arrays: q, k, v (bf16-representable), bias, th1, th1_b, th2,
    th2_b, at the scales of tests/test_pallas_attention.py."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    return [bf16(rng.normal(size=(B, N, h * d))), bf16(rng.normal(size=(B, N, h * d))),
            bf16(rng.normal(size=(B, N, h * dv))),
            (rng.normal(size=(h, N, N)) * 0.1).astype(np.float32),
            (rng.normal(size=(h, h)) * 0.3).astype(np.float32),
            (rng.normal(size=(h,)) * 0.1).astype(np.float32),
            (rng.normal(size=(h, h)) * 0.3).astype(np.float32),
            (rng.normal(size=(h,)) * 0.1).astype(np.float32)]


def _torch(arrays, dtype):
    """q, k, v in ``dtype``, the tables in f32 (f64 for a float64 run)."""
    table = torch.float64 if dtype == torch.float64 else torch.float32
    return ([torch.from_numpy(a).to(dtype) for a in arrays[:3]]
            + [torch.from_numpy(a).to(table) for a in arrays[3:]])


def _jax_kernel(arrays, h, d):
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in arrays[:3])
    out = attn4d_pallas(q, k, v, *(jnp.asarray(a) for a in arrays[3:]), num_heads=h,
                        scale=d**-0.5, interpret=True)
    return np.asarray(out, np.float32)


def _step(ref: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


@pytest.mark.parametrize("B,N,h,d,dv", SHAPES)
def test_bf16_plain_matches_the_jax_kernel_in_interpret_mode(B, N, h, d, dv):
    arrays = _inputs(B, N, h, d, dv, seed=N)
    ref = _jax_kernel(arrays, h, d)
    out = k7.attn4d_plain(*_torch(arrays, torch.bfloat16), num_heads=h, scale=d**-0.5)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    err = float(np.abs(out.float().numpy() - ref).max())
    assert err <= _step(ref), f"max|d| {err:.3e} > one bf16 step {_step(ref):.3e}"


@pytest.mark.parametrize("B,N,h,d,dv", SHAPES)
def test_f32_plain_matches_the_jax_xla_chain(B, N, h, d, dv):
    """The einsum chain of the JAX model's XLA branch (the reference of
    tests/test_pallas_attention.py), in f32 throughout."""
    arrays = _inputs(B, N, h, d, dv, seed=N + 1)
    q, k, v, bias, th1, th1_b, th2, th2_b = (jnp.asarray(a) for a in arrays)
    qh, kh, vh = (t.reshape(B, N, h, -1).transpose(0, 2, 1, 3) for t in (q, k, v))
    with jax.default_matmul_precision("highest"):
        attn = jnp.einsum("bhnd,bhmd->bhnm", qh, kh) * d**-0.5 + bias[None]
        attn = jnp.einsum("bhnm,hg->bgnm", attn, th1) + th1_b[None, :, None, None]
        attn = jax.nn.softmax(attn, axis=-1)
        attn = jnp.einsum("bhnm,hg->bgnm", attn, th2) + th2_b[None, :, None, None]
        ref = jnp.einsum("bhnm,bhmd->bhnd", attn, vh).transpose(0, 2, 1, 3).reshape(B, N, -1)
    ref = np.asarray(ref)
    out = k7.attn4d_plain(*_torch(arrays, torch.float32), num_heads=h, scale=d**-0.5)
    assert out.dtype == torch.float32
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def _numpy_reference(arrays, h, d):
    """The function in numpy float64, written from its definition."""
    q, k, v, bias, th1, th1_b, th2, th2_b = (a.astype(np.float64) for a in arrays)
    B, N, _ = q.shape
    qh, kh, vh = (t.reshape(B, N, h, -1) for t in (q, k, v))
    s = np.einsum("bnhd,bmhd->bhnm", qh, kh) * d**-0.5 + bias[None]
    s = np.einsum("bhnm,hg->bgnm", s, th1) + th1_b[None, :, None, None]
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    p2 = np.einsum("bhnm,hg->bgnm", p, th2) + th2_b[None, :, None, None]
    return np.einsum("bgnm,bmgd->bngd", p2, vh).reshape(B, N, -1)


@pytest.mark.parametrize("B,N,h,d,dv", SHAPES)
def test_f64_plain_matches_an_independent_einsum(B, N, h, d, dv):
    arrays = _inputs(B, N, h, d, dv, seed=N + 2)
    ref = _numpy_reference(arrays, h, d)
    out = k7.attn4d_plain(*_torch(arrays, torch.float64), num_heads=h, scale=d**-0.5)
    assert out.dtype == torch.float64
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-12 * float(np.abs(ref).max())


def _th2_inside(q, k, v, bias, th1, th1_b, th2, th2_b, *, num_heads, scale):
    """th2 mixed into the unnormalised exponentials, then normalised."""
    from deepfakedetection_tpu_torch.ops.window_attn import _heads, _merge

    qh, kh, vh = (_heads(t, num_heads).float() for t in (q, k, v))
    s = k7._mix((qh @ kh.transpose(-1, -2)) * scale + bias, th1, th1_b)
    e = k7._mix((s - s.amax(dim=-1, keepdim=True)).exp(), th2, th2_b)
    return _merge((e / e.sum(-1, keepdim=True)).to(torch.bfloat16).float() @ vh).to(torch.bfloat16)


WRONG = {
    "th2 bias dropped": lambda a: a[:7] + [torch.zeros_like(a[7])],
    "th1 transposed": lambda a: a[:4] + [a[4].t().contiguous()] + a[5:],
    "th2 before normalising": None,
}


@pytest.mark.parametrize("wrong", list(WRONG))
@pytest.mark.parametrize("B,N,h,d,dv", SHAPES)
def test_wrong_variants_fall_outside_the_tolerance(B, N, h, d, dv, wrong):
    arrays = _inputs(B, N, h, d, dv, seed=N)
    ref = _jax_kernel(arrays, h, d)
    args = _torch(arrays, torch.bfloat16)
    if WRONG[wrong] is None:
        out = _th2_inside(*args, num_heads=h, scale=d**-0.5)
    else:
        out = k7.attn4d_plain(*WRONG[wrong](args), num_heads=h, scale=d**-0.5)
    assert float(np.abs(out.float().numpy() - ref).max()) > 2 * _step(ref), wrong


def test_wrapper_runs_the_plain_version_on_the_cpu_and_counts_no_launch():
    args = _torch(_inputs(2, 49, 8, 32, 128, seed=5), torch.bfloat16)
    before = k7.attn4d.launches
    out = k7.attn4d(*args, num_heads=8, scale=32**-0.5)
    assert torch.equal(out, k7.attn4d_plain(*args, num_heads=8, scale=32**-0.5))
    assert k7.attn4d.launches == before


def test_wrapper_takes_strided_views():
    """q and k as views of one wider tensor, as a caller may hand them."""
    args = _torch(_inputs(2, 25, 4, 16, 64, seed=6), torch.bfloat16)
    wide = torch.cat([args[0], args[1]], dim=-1)
    views = [wide[..., :64], wide[..., 64:]] + args[2:]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(k7.attn4d(*views, num_heads=4, scale=0.25),
                               k7.attn4d(*args, num_heads=4, scale=0.25), atol=0.0, rtol=0.0)


@pytest.mark.parametrize("what", ["f32 q", "bias shape", "bias dtype", "th1 shape",
                                  "too many tokens", "too many heads", "head_dim", "value dim",
                                  "feature stride", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    args = _torch(_inputs(1, 16, 4, 16, 64, seed=7), torch.bfloat16)
    h = 4
    if what == "f32 q":
        args[0] = args[0].float()
    elif what == "bias shape":
        args[3] = args[3][:, :8]
    elif what == "bias dtype":
        args[3] = args[3].double()
    elif what == "th1 shape":
        args[4] = args[4][:2]
    elif what == "too many tokens":  # one past the long kernel's limit, the bias never read
        n = k7.LONG_MAX_TOKENS + 1
        args = [torch.zeros(1, n, 64, dtype=torch.bfloat16)] * 2 + [
            torch.zeros(1, n, 256, dtype=torch.bfloat16), torch.zeros(1, 1, 1).expand(4, n, n),
            *args[4:]]
    elif what == "too many heads":
        args = _torch(_inputs(1, 16, 16, 16, 8, seed=7), torch.bfloat16)
        h = 16
    elif what == "head_dim":
        args = _torch(_inputs(1, 16, 4, 8, 64, seed=7), torch.bfloat16)
    elif what == "value dim":
        args = _torch(_inputs(1, 16, 4, 16, 4, seed=7), torch.bfloat16)
    elif what == "feature stride":
        args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        args = [t.to("meta") for t in args]
    with pytest.raises(ValueError):
        k7.attn4d(*args, num_heads=h, scale=0.25)
