"""K3 port (deepfakedetection_tpu_torch/ops/fused_mbconv.py) and B3 with
``DFD_FUSED_MBCONV`` against the JAX package, on numpy-seeded inputs.

(i) ``fused_mbconv_se_plain`` against the JAX ``fused_mbconv_se`` in
    interpret mode at the JAX test's shapes and a 7x7 map with channels off
    128, at the JAX test's tolerance (5e-2). Measured max|d|: 1.6e-2,
    2.0e-2, 3.1e-2, all from the reference's halo (see (iv)); with that halo
    the plain version is within two bf16 steps of the output's scale of the
    JAX kernel (0, 0, 3.9e-3).
(ii) The plain version rounds where the Pallas kernel does (the gate rounded
    to bf16 before a bf16 product with the bf16 depthwise map), not where
    tests/test_fused_mbconv.py::_reference does (an f32 gate times the f32
    map, one rounding).
(iii) The wrapper's refusals.
(iv) One K3 block of the narrow B3 built from JAX variables, with the
    switch, against the JAX kernel fed those variables folded in numpy,
    through the one difference of the reference: the Pallas kernel expands
    the zero-padded x, so its depthwise halo is silu(b_exp), not zero
    (test_jax_kernel_expands_zero_padded_x).
(v) The narrow bf16 B3 with the switch against the JAX narrow bf16 forward
    (K1 and K2 in interpret mode): logits within 1.5e-2 of the scale
    (measured 8.9e-3; 6.6e-3 without the switch), equal argmax where
    decided; K1 1, K2 2, K3 3 calls.
(vi) Which blocks K3 serves at full width, with the switch and without.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.models import common as jax_common
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.ops.pallas import depthwise_se as jax_k1
from deepfakedetection_tpu.ops.pallas import expand_dw as jax_k2
from deepfakedetection_tpu.ops.pallas.fused_mbconv import fused_mbconv_se as jax_k3
from deepfakedetection_tpu_torch.models import common, efficientnet
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet, create_efficientnet
from deepfakedetection_tpu_torch.ops import fused_mbconv as k3
from tests.test_fused_mbconv import _reference
from tests.test_torch_efficientnet import NARROW, _gate, _images, jax_variables, port_from_jax

# (B, H, W, C, k): the JAX test's two shapes, then a 7x7 map with C 40
# (Cmid 240, Cse 10) off the JAX wrapper's 128-channel padding
SHAPES = [(2, 14, 14, 16, 3), (2, 10, 12, 24, 5), (2, 7, 7, 40, 5)]


def _args(rng, C, k, Cse=None, scale=0.1):
    """The JAX test's weights: normal * 0.1 in the JAX layout, Cmid 6C, Cse
    C // 4 (at least 1)."""
    Cmid, Cse = 6 * C, Cse or max(C // 4, 1)
    shapes = [(C, Cmid), (Cmid,), (k, k, Cmid), (Cmid,), (Cmid, Cse), (Cse,), (Cse, Cmid),
              (Cmid,), (Cmid, C), (C,)]
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _x(rng, B, H, W, C):
    return torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).to(torch.bfloat16)


def _jax(x, args, k):
    out = jax_k3(jnp.asarray(x.float().numpy(), jnp.bfloat16), *map(jnp.asarray, args),
                 kernel_size=k, interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("B,H,W,C,k", SHAPES)
def test_plain_matches_jax_interpret_kernel(B, H, W, C, k):
    rng = np.random.default_rng(C)
    x, args = _x(rng, B, H, W, C), _args(rng, C, k)
    out = k3.fused_mbconv_se_plain(x, *map(torch.from_numpy, args), kernel=k)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, H, W, C)
    want = _jax(x, args, k)
    np.testing.assert_allclose(out.float().numpy(), want, atol=5e-2, rtol=5e-2)
    padded = _plain_on_padded_x(x, list(map(torch.from_numpy, args)), k).float().numpy()
    assert np.abs(padded - want).max() <= _two_steps(want)


def test_rounding_points_are_the_pallas_kernels():
    """A projection that copies one depthwise channel c into output channel
    0, with x and the biases there zero: out[..., 0] is the gated map's
    channel c as it was rounded. The plain version gives bf16(dw *
    bf16(gate)) bit for bit; an f32 gate gives other values at some pixels.
    The expand bias is zero, so the JAX kernel's halo (see
    test_jax_kernel_expands_zero_padded_x) is the model's: the JAX kernel
    then differs from the plain version at 0 of 392 pixels and from the JAX
    test's _reference (f32 gate, unrounded map) at 275 (measured)."""
    rng = np.random.default_rng(7)
    B, H, W, C, k, c = 2, 14, 14, 16, 3, 5
    x, args = _x(rng, B, H, W, C), _args(rng, C, k, scale=0.5)
    x[..., 0] = 0
    args[1][:] = 0
    args[8][:] = 0
    args[8][c, 0] = 1.0
    args[9][:] = 0
    t = list(map(torch.from_numpy, args))
    out = k3.fused_mbconv_se_plain(x, *t, kernel=k)[..., 0].float()

    dw, mean = k3.expand_dw_silu_pool_plain(x, *t[:4], kernel=k)
    se = torch.nn.functional.silu(mean @ t[4].to(torch.bfloat16).float() + t[5])
    gate = torch.sigmoid(se @ t[6].to(torch.bfloat16).float() + t[7])[:, c]
    gated_bf16 = (dw[..., c].float() * gate.to(torch.bfloat16).float()[:, None, None])
    gated_f32 = (dw[..., c].float() * gate[:, None, None])
    assert torch.equal(out, gated_bf16.to(torch.bfloat16).float())
    assert (out != gated_f32.to(torch.bfloat16).float()).sum() > 0

    jax_out = _jax(x, args, k)[..., 0]
    ref = np.asarray(_reference(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                tuple(map(jnp.asarray, args)), k), np.float32)[..., 0]
    with_plain = int((jax_out != out.numpy()).sum())
    with_reference = int((jax_out != ref).sum())
    assert 10 * with_plain < with_reference, (with_plain, with_reference)


def _plain_on_padded_x(x, t, k):
    """The plain version with the JAX kernel's halo: the expand runs over x
    zero-padded by k // 2, so the depthwise taps read silu(b_exp) past the
    image where the model reads zero."""
    r = k // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, r, r, r, r))
    e = torch.nn.functional.silu(xp @ t[0].to(torch.bfloat16).float() + t[1])
    e = e.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    Cmid = e.shape[1]
    w = t[2].permute(2, 0, 1).reshape(Cmid, 1, k, k)
    dw = torch.nn.functional.silu(torch.nn.functional.conv2d(e, w, None, 1, 0, 1, Cmid)
                                  + t[3].view(1, -1, 1, 1))
    mean = dw.mean(dim=(2, 3))
    dw = dw.to(torch.bfloat16).permute(0, 2, 3, 1)
    se = torch.nn.functional.silu(mean @ t[4].to(torch.bfloat16).float() + t[5])
    gate = torch.sigmoid(se @ t[6].to(torch.bfloat16).float() + t[7]).to(torch.bfloat16)
    out = (dw * gate[:, None, None, :]).float() @ t[8].to(torch.bfloat16).float() + t[9]
    return (out + x.float()).to(torch.bfloat16)


def test_jax_kernel_expands_zero_padded_x():
    """A difference of the reference: the Pallas kernel expands the
    zero-padded x (``fused_mbconv.py:134-137, 57-62``), so past the image its
    depthwise halo holds silu(b_exp), where the model's depthwise (and K2,
    and the JAX test's _reference) pads the expanded map with zero. The port
    follows the model. With a large expand bias the JAX kernel equals the
    plain version computed on the padded x, and is far from the port's."""
    rng = np.random.default_rng(8)
    k, C = 5, 16
    x, args = _x(rng, 2, 10, 12, C), _args(rng, C, k, scale=0.5)
    t = list(map(torch.from_numpy, args))
    want = _jax(x, args, k)
    padded = _plain_on_padded_x(x, t, k).float().numpy()
    ours = k3.fused_mbconv_se_plain(x, *t, kernel=k).float().numpy()
    assert np.abs(padded - want).max() <= _two_steps(want)
    assert np.abs(ours - want).max() > 0.1


@pytest.mark.parametrize("change", ["cout", "k7", "x_f32", "w_se_r_shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(change):
    rng = np.random.default_rng(3)
    k, C = 3, 16
    x, args = _x(rng, 2, 6, 6, C), [torch.from_numpy(a) for a in _args(rng, C, k)]
    match = None
    if change == "cout":
        args[8], args[9] = args[8][:, :8].contiguous(), args[9][:8]
        match = "in == out"
    elif change == "k7":
        k = 7
    elif change == "x_f32":
        x = x.float()
    elif change == "w_se_r_shape":
        args[4] = args[4][:-1]
    else:
        x, args = x.to("meta"), [a.to("meta") for a in args]
        match = "unsupported device"
    with pytest.raises(ValueError, match=match):
        k3.fused_mbconv_se(x, *args, kernel=k)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(4)
    x, args = _x(rng, 2, 5, 7, 24), [torch.from_numpy(a) for a in _args(rng, 24, 5)]
    before = k3.fused_mbconv_se.launches
    got = k3.fused_mbconv_se(x, *args, kernel=5)
    assert torch.equal(got, k3.fused_mbconv_se_plain(x, *args, kernel=5))
    assert k3.fused_mbconv_se.launches == before


def _fold(params, stats, eps=1e-3):
    """A JAX ConvBN's (w, b) folded in numpy: w * gamma / sqrt(var + eps),
    beta - mean * gamma / sqrt(var + eps)."""
    denom = params["scale"] / np.sqrt(stats["var"] + eps)
    return params["kernel"] * denom, params["bias"] - stats["mean"] * denom


def _two_steps(ref) -> float:
    """Two bf16 steps of ref's scale."""
    return 2.0 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def test_block_from_jax_variables_matches_jax_kernel(monkeypatch):
    """stage4_block1 of the narrow B3 (C 32, Cmid 192, Cse 8, k 5) on a
    9 x 11 map, with the switch. The operands the port gathers equal the
    JAX variables folded here in numpy; the block's output is K3's contract
    on those folded variables; and that contract with the JAX kernel's halo
    (``_plain_on_padded_x``) is the JAX kernel's output on them, within two
    bf16 steps of the scale (measured: 0 and 0)."""
    monkeypatch.setenv("DFD_FUSED_MBCONV", "1")
    variables = jax_variables(JaxEfficientNet(**NARROW, dtype=jnp.bfloat16), seed=2)
    model = port_from_jax(variables, torch.bfloat16)
    name, idx = "stage4_block1", 6
    block = model._blocks[idx]
    assert block.fused() == "k3"
    p, s = variables["params"][name], variables["batch_stats"][name]
    w_exp, b_exp = _fold(p["expand"], s["expand"])
    w_dw, b_dw = _fold(p["depthwise"], s["depthwise"])
    w_proj, b_proj = _fold(p["project"], s["project"])
    se = p["se"]
    C, Cmid = w_exp.shape[2], w_exp.shape[3]
    args = [np.asarray(a, np.float32) for a in (
        w_exp.reshape(C, Cmid), b_exp, w_dw.reshape(5, 5, Cmid), b_dw,
        se["reduce"]["kernel"].reshape(Cmid, -1), se["reduce"]["bias"],
        se["expand"]["kernel"].reshape(-1, Cmid), se["expand"]["bias"],
        w_proj.reshape(Cmid, C), b_proj)]
    for got, want in zip(block._k3_operands.get(block._k3_tensors()), args):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    t = list(map(torch.from_numpy, args))
    x = _x(np.random.default_rng(5), 2, 9, 11, C)
    with torch.no_grad():
        got = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()
    ours = k3.fused_mbconv_se_plain(x, *t, kernel=5).float().numpy()
    assert np.abs(got - ours).max() <= _two_steps(ours)
    want = _jax(x, args, 5)
    assert np.abs(_plain_on_padded_x(x, t, 5).float().numpy() - want).max() <= _two_steps(want)


def _counting(fn, calls, key):
    def wrapped(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)

    return wrapped


def test_narrow_bf16_b3_with_the_switch_matches_jax(monkeypatch):
    monkeypatch.setenv("DFD_FUSED_MBCONV", "1")
    jmodel = JaxEfficientNet(**NARROW, dtype=jnp.bfloat16)
    variables = jax_variables(jmodel, seed=1)
    model = port_from_jax(variables, torch.bfloat16)
    monkeypatch.setattr(jax_common, "use_pallas_dwse", lambda: True)
    monkeypatch.setattr(jax_k2, "use_pallas_expdw", lambda *a: True)
    for mod, name in ((jax_k1, "depthwise_silu_pool"), (jax_k2, "expand_dw_silu_pool")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, **kw: _o(*a, **{**kw,
                                                                          "interpret": True}))
    calls = {"k1": 0, "k2": 0, "k3": 0}
    for mod, name, key in ((common, "depthwise_silu_pool", "k1"),
                           (efficientnet, "expand_dw_silu_pool", "k2"),
                           (efficientnet, "fused_mbconv_se", "k3")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name), calls, key))

    x = _images(4, seed=2)
    jlogits = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        logits = model(torch.from_numpy(x).permute(0, 3, 1, 2)).float().numpy()

    assert calls == model.kernel_launches_per_forward() == {"k1": 1, "k2": 2, "k3": 3}
    _gate("bf16 logits", logits, jlogits, tol=1.5e-2)
    scale = float(np.abs(jlogits).max())
    decided = np.abs(jlogits[:, 1] - jlogits[:, 0]) > 3e-2 * scale
    assert (logits.argmax(-1) == jlogits.argmax(-1))[decided].all()


def test_k3_serves_b3_residual_blocks_in_bf16_eval_only(monkeypatch):
    off = create_efficientnet("b3", num_classes=2).eval()
    monkeypatch.setenv("DFD_FUSED_MBCONV", "1")
    on = create_efficientnet("b3", num_classes=2).eval()
    f32 = create_efficientnet("b3", num_classes=2, dtype=torch.float32).eval()
    assert off.kernel_launches_per_forward() == {"k1": 2, "k2": 20, "k3": 0}
    assert on.kernel_launches_per_forward() == {"k1": 2, "k2": 2, "k3": 18}
    assert f32.kernel_launches_per_forward() == {"k1": 0, "k2": 0, "k3": 0}
    assert on.train().kernel_launches_per_forward() == {"k1": 0, "k2": 0, "k3": 0}
    # the two stride-1 blocks that keep K2 change their width (no residual)
    kept = [b.args for b in on.eval()._blocks if b.fused() == "k2"]
    assert [(a.in_features, a.out_features) for a in kept] == [(96, 136), (232, 384)]


def test_operands_follow_the_weights(monkeypatch):
    """The gathered operands are cached, and rebuilt after a weight changes
    in place (``load_state_dict``)."""
    monkeypatch.setenv("DFD_FUSED_MBCONV", "1")
    model = EfficientNet(**NARROW, generator=torch.Generator().manual_seed(0)).eval()
    block = model._blocks[4]
    first = block._k3_operands.get(block._k3_tensors())
    assert block._k3_operands.get(block._k3_tensors()) is first
    before = [t.clone() for t in first]
    with torch.no_grad():
        block._project_conv.weight.mul_(2.0)
        block._se_expand.weight.add_(1.0)
    second = block._k3_operands.get(block._k3_tensors())
    assert second is not first
    torch.testing.assert_close(second[8], 2.0 * before[8])
    torch.testing.assert_close(second[6], before[6] + 1.0)
