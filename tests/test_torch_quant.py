"""The port's int8 eval (``ops/quant.py``, ``ops/int8_dw.py`` and ConvBN's
int8 branch) against the JAX package's ``deepfakedetection_tpu.ops.quant``
on seeded numpy inputs.

- ``quantize_act`` and ``quantize_weight_per_channel``: equal int8 arrays.
- ``int8_conv``: equal int32 accumulators and f32 outputs within rtol 1e-6
  (dense 3x3 and 1x1, depthwise at stride 1 and 2 with asymmetric pads,
  per-channel scales folded into dense and depthwise weights, and the
  scalar-max fallback of a grouped conv); the depthwise kernel's plain
  version with each activation within one bf16 step of JAX's.
- ``calibrate_act_scales`` in all three modes within rtol 1e-6, and the
  percentile statistic on a tensor past ``torch.quantile``'s 2^24 elements.
- Narrow B3, EfficientFormerV2 and FasterViT int8 forwards against JAX's with
  the same scales (carried across by ``runtime/convert.conv_names_from_jax``):
  in f32 under the module gate (max|d| under 5e-3 of the output scale, equal
  argmax), in bf16 within 5e-2 of it: bf16 roundings that differ between the
  frameworks move an activation across an int8 level now and then.
- ConvBN's int8 weights derived once per set of weights and scales, train
  mode ignoring the context, depthwise exclusion, K1/K2 off under it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from deepfakedetection_tpu.models.efficientformer_v2 import EfficientFormerV2 as JaxEFv2
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.ops import quant as jq
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch.models import common, efficientnet
from deepfakedetection_tpu_torch.models.common import ConvBN, name_conv_bns
from deepfakedetection_tpu_torch.models.efficientnet import static_same_pads
from deepfakedetection_tpu_torch.ops import quant as tq
from deepfakedetection_tpu_torch.ops.int8_dw import int8_depthwise_acc_plain, int8_depthwise_plain
from deepfakedetection_tpu_torch.runtime.convert import conv_names_from_jax
from tests import test_torch_efficientformer_v2 as ef_tests
from tests import test_torch_efficientnet as b3_tests
from tests import test_torch_fastervit as fv_tests
from tests.test_quant import ConvBNNet

GATE = 5e-3  # f32 logits, the cross-framework module gate
BF16_GATE = 5e-2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (as tests/test_torch_cam.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _np(a):
    return np.asarray(a)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def test_quantize_act_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 6, 8)) * 3).astype(np.float32)
    for scale in (0.037, rng.uniform(0.01, 0.1, 8)):
        want = _np(jq.quantize_act(jnp.asarray(x), scale))
        got = tq.quantize_act(torch.from_numpy(x), scale).numpy()
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = _np(jq.quantize_act(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), 0.02))
    np.testing.assert_array_equal(tq.quantize_act(xb, 0.02).numpy(), want)


def test_quantize_weight_per_channel_matches_jax():
    w = np.random.default_rng(1).normal(size=(3, 3, 4, 8)).astype(np.float32)
    wq_j, sw_j = jq.quantize_weight_per_channel(jnp.asarray(w))
    wq, sw = tq.quantize_weight_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(wq.numpy(), _np(wq_j))
    np.testing.assert_array_equal(sw.numpy(), _np(sw_j))


# (name, x shape, w shape HWIO, strides, pads, groups, per-channel scale)
CONV_CASES = [
    ("dense3x3_s2", (2, 9, 10, 5), (3, 3, 5, 16), (2, 2), ((0, 1), (1, 1)), 1, False),
    ("dense1x1", (2, 6, 6, 24), (1, 1, 24, 12), (1, 1), ((0, 0), (0, 0)), 1, False),
    ("dense1x1_k_off8", (1, 3, 4, 5), (1, 1, 5, 8), (1, 1), ((0, 0), (0, 0)), 1, False),
    ("dw3_s1", (2, 7, 8, 12), (3, 3, 1, 12), (1, 1), ((1, 1), (1, 1)), 12, False),
    ("dw5_s2_asym", (2, 11, 9, 8), (5, 5, 1, 8), (2, 2), ((1, 2), (2, 2)), 8, False),
    ("dw3_s2", (2, 8, 8, 6), (3, 3, 1, 6), (2, 2), ((0, 1), (0, 1)), 6, False),
    ("dense_per_channel", (2, 8, 8, 6), (3, 3, 6, 8), (1, 1), ((1, 1), (1, 1)), 1, True),
    ("dw_per_channel", (2, 8, 8, 8), (3, 3, 1, 8), (1, 1), ((1, 1), (1, 1)), 8, True),
    ("grouped_scalar_max", (2, 6, 6, 8), (3, 3, 4, 8), (1, 1), ((1, 1), (1, 1)), 2, True),
]


def _conv_case(case, seed=2):
    _, xs, ws, strides, pads, groups, per_channel = case
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=xs) * rng.uniform(0.5, 2.0, xs[-1])).astype(np.float32)
    w = (rng.normal(size=ws) / np.sqrt(np.prod(ws[:3]))).astype(np.float32)
    b = rng.normal(size=ws[-1]).astype(np.float32) * 0.1
    if per_channel:
        scale = (np.abs(x).max(axis=(0, 1, 2)) / 127.0).astype(np.float64)
    else:
        scale = float(np.abs(x).max() / 127.0)
    return x, w, b, scale, strides, pads, groups


def _jax_acc(x, w, scale, strides, pads, groups):
    """JAX's int32 accumulator, its per-channel folding repeated as
    ``int8_conv`` does it."""
    sx = jnp.asarray(scale, jnp.float32)
    cin = x.shape[-1]
    w_eff = jnp.asarray(w)
    if sx.ndim > 0:
        if groups == 1 and w.shape[-2] == cin:
            w_eff = w_eff * sx[None, None, :, None]
        elif groups == cin and w.shape[-2] == 1:
            w_eff = w_eff * sx[None, None, None, :]
        else:
            sx = jnp.max(sx)
    xq = jq.quantize_act(jnp.asarray(x), sx)
    wq, _ = jq.quantize_weight_per_channel(w_eff)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    acc = jax.lax.conv_general_dilated(xq, wq, window_strides=strides, padding=pads,
                                       dimension_numbers=dn, feature_group_count=groups,
                                       preferred_element_type=jnp.int32)
    return _np(xq), _np(acc), sx


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv_matches_jax(case):
    x, w, b, scale, strides, pads, groups = _conv_case(case)
    xq_j, acc_j, sx = _jax_acc(x, w, scale, strides, pads, groups)
    qw = tq.prepare(torch.from_numpy(w), torch.from_numpy(b), scale, groups)
    xq = tq.quantize_act(torch.from_numpy(x), _np(sx))
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    if qw.kind == "depthwise":
        acc = int8_depthwise_acc_plain(xq, qw.wq, stride=strides[0], pads=pads)
    else:
        acc = tq.accumulate(xq, qw, strides, pads)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    want = _np(jq.int8_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), scale, strides,
                            pads, dn, groups))
    got = tq.int8_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), scale,
                       strides, pads, groups).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


JAX_ACTS = {"none": lambda v: v, "silu": jax.nn.silu,
            "gelu_tanh": lambda v: jax.nn.gelu(v, approximate=True),
            "gelu_erf": lambda v: jax.nn.gelu(v, approximate=False)}


@pytest.mark.parametrize("act", list(JAX_ACTS))
@pytest.mark.parametrize("case", [c for c in CONV_CASES if c[0].startswith("dw")],
                         ids=[c[0] for c in CONV_CASES if c[0].startswith("dw")])
def test_depthwise_plain_version_matches_jax(case, act):
    """The kernel's plain version: the accumulator equal to JAX's depthwise
    conv, and act(acc * scale + bias) in bf16 within one bf16 step of JAX's
    f32 output through the same activation, in f32 within rtol 1e-6 without
    one."""
    x, w, b, scale, strides, pads, groups = _conv_case(case, seed=3)
    xq_j, acc_j, _ = _jax_acc(x, w, scale, strides, pads, groups)
    qw = tq.prepare(torch.from_numpy(w), torch.from_numpy(b), scale, groups)
    xq = torch.from_numpy(xq_j.copy())
    acc = int8_depthwise_acc_plain(xq, qw.wq, stride=strides[0], pads=pads)
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    want = _np(JAX_ACTS[act](jq.int8_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), scale,
                                          strides, pads, dn, groups)))
    out_dtype = torch.float32 if act == "none" else torch.bfloat16
    got = int8_depthwise_plain(xq, qw.wq, qw.scale, qw.bias, stride=strides[0], pads=pads,
                               act=act, out_dtype=out_dtype).float().numpy()
    if act == "none":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        step = 2.0 ** -8 * np.maximum(np.abs(want), 1e-3)
        assert (np.abs(got - want) <= step).all(), float(np.abs(got - want).max())


class PortConvBNNet(nn.Module):
    """tests/test_quant.py's ConvBNNet on the port's ConvBN: dense 3x3
    stride 2 (SAME pads) + SiLU -> depthwise 3x3 + SiLU -> 1x1 -> f32 mean
    -> head. Its convs are named as the flax modules are, so the scales'
    keys agree."""

    def __init__(self, num_classes: int = 2, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.c1 = nn.Conv2d(3, 16, 3, stride=2, bias=False)
        self.dw = nn.Conv2d(16, 16, 3, groups=16, bias=False)
        self.c2 = nn.Conv2d(16, 8, 1, bias=False)
        self.bns = nn.ModuleList(nn.BatchNorm2d(c) for c in (16, 16, 8))
        self.head = nn.Linear(8, num_classes)
        self.layers = [
            ConvBN(self.c1, self.bns[0], pads=static_same_pads(16, 3, 2), act=F.silu, dtype=dtype),
            ConvBN(self.dw, self.bns[1], pads=((1, 1), (1, 1)), act=F.silu, dtype=dtype),
            ConvBN(self.c2, self.bns[2], dtype=dtype),
        ]
        name_conv_bns(self)
        if generator is not None:  # convs N(0, 2/fan_in), the head N(0, 0.3), zero biases
            with torch.no_grad():
                self.head.bias.zero_()
                for conv in (self.c1, self.dw, self.c2):
                    fan_in = conv.weight[0].numel()
                    conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                                      * (2.0 / fan_in) ** 0.5)
                self.head.weight.copy_(torch.randn(self.head.weight.shape,
                                                   generator=generator) * 0.3)

    def forward(self, x, generator=None):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        for layer in self.layers:
            x = layer(x)
        return self.head(x.float().mean(dim=(2, 3)))


def port_convbn_net(params, batch_stats, dtype=torch.float32) -> PortConvBNNet:
    """The port's net with a JAX ConvBNNet's variables."""
    model = PortConvBNNet(dtype=dtype).eval()
    with torch.no_grad():
        for conv, bn, name in zip((model.c1, model.dw, model.c2), model.bns, ("c1", "dw", "c2")):
            conv.weight.copy_(_t(np.transpose(params[name]["kernel"], (3, 2, 0, 1))))
            bn.weight.copy_(_t(params[name]["scale"]))
            bn.bias.copy_(_t(params[name]["bias"]))
            bn.running_mean.copy_(_t(batch_stats[name]["mean"]))
            bn.running_var.copy_(_t(batch_stats[name]["var"]))
        model.head.weight.copy_(_t(np.transpose(params["head"]["kernel"])))
        model.head.bias.copy_(_t(params["head"]["bias"]))
    return model


@pytest.fixture(scope="module")
def convbn_net():
    model = ConvBNNet()
    v = model.init({"params": jax.random.key(0)}, jnp.zeros((1, 16, 16, 3)), train=False)
    rng = np.random.default_rng(4)
    params = jax.tree.map(np.asarray, v["params"])
    stats = {k: {"mean": rng.normal(0, 0.1, s["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
             for k, s in v["batch_stats"].items()}
    x = np.random.default_rng(5).normal(size=(4, 16, 16, 3)).astype(np.float32)
    x[0, 0, 0, 0], x[1, 3, 3, 1] = 40.0, -35.0  # outliers for the percentile
    x *= np.array([4.0, 1.0, 0.25], np.float32)  # channels of different ranges
    return model, params, stats, x


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["absmax", "percentile", "per-channel"])
def test_calibrate_act_scales_matches_jax(convbn_net, mode):
    model, params, stats, x = convbn_net
    want = jq.calibrate_act_scales(model, params, stats, [jnp.asarray(x), jnp.asarray(x[:2] * 2)],
                                   mode=mode, percentile=0.995)
    port = port_convbn_net(params, stats)
    batches = [torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(x[:2] * 2).permute(0, 3, 1, 2)]
    got = tq.calibrate_act_scales(port, batches, mode=mode, percentile=0.995)
    assert set(got) == {"c1", "dw", "c2"}
    _close(got, want)
    if mode == "per-channel":
        assert np.shape(got["c1"]) == (3,) and np.shape(got["dw"]) == (16,)
    no_dw = tq.calibrate_act_scales(port, batches[:1], include_depthwise=False, mode=mode)
    assert set(no_dw) == {"c1", "c2"}
    with jq.quantized_eval(jq.QuantCtx(scales=want)):
        out_j = _np(jax.jit(model.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with tq.quantized_eval(tq.QuantCtx(scales=got)), torch.no_grad():
        out = port(batches[0]).numpy()
    assert np.abs(out - out_j).max() <= GATE * np.abs(out_j).max()


def test_percentile_statistic_past_torch_quantile_limit():
    """``range_stat``'s percentile on 2^24 + 5 elements (``torch.quantile``
    refuses more than 2^24) equals ``jnp.quantile``'s within rtol 1e-6, as at
    several q on a small tensor."""
    rng = np.random.default_rng(6)
    big = rng.standard_cauchy(size=(1, 2**12 + 1, 2**12, 1)).astype(np.float32)
    big = big.reshape(-1)[: 2**24 + 5].reshape(1, -1, 1, 1)
    want = float(jnp.quantile(jnp.abs(jnp.asarray(big)).reshape(-1), jnp.float32(0.999)))
    got = float(tq.range_stat(torch.from_numpy(big), "percentile", 0.999))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    small = rng.normal(size=(3, 5, 7, 4)).astype(np.float32)
    for q in (0.0, 0.5, 0.9, 0.999, 1.0):
        want = float(jnp.quantile(jnp.abs(jnp.asarray(small)).reshape(-1), jnp.float32(q)))
        got = float(tq.range_stat(torch.from_numpy(small), "percentile", q))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(q))


def test_unknown_calibration_mode_raises():
    with pytest.raises(ValueError, match="calib_mode"):
        tq.QuantCtx(calibrate=True, calib_mode="Percentile")


def test_int8_weights_derived_once_and_train_mode_ignores_the_context(convbn_net, monkeypatch):
    model, params, stats, x = convbn_net
    port = port_convbn_net(params, stats)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    calls = []
    prepare = tq.prepare
    monkeypatch.setattr(tq, "prepare", lambda *a: calls.append(a[2]) or prepare(*a))
    scales = {"c1": 0.1, "dw": 0.05, "c2": 0.05}
    with tq.quantized_eval(tq.QuantCtx(scales=scales)), torch.no_grad():
        first = port(xt)
        assert len(calls) == 3
        torch.testing.assert_close(port(xt), first, rtol=0, atol=0)
        assert len(calls) == 3  # cached: same weights, same scales
    with tq.quantized_eval(tq.QuantCtx(scales={**scales, "c2": 0.04})), torch.no_grad():
        port(xt)
    assert calls[3:] == [0.04]  # only the layer whose scale changed
    with torch.no_grad():
        port.bns[0].running_var.mul_(2.0)  # new weights: derived again
        with tq.quantized_eval(tq.QuantCtx(scales=scales)):
            port(xt)
    assert calls[4:] == [0.1, 0.05]  # c1's weights are new; c2's scale is back to 0.05
    port.train()
    with torch.no_grad():
        ref = port(xt)
        with tq.quantized_eval(tq.QuantCtx(scales=scales, default_scale=0.1)):
            out = port(xt)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _check(got, want, dtype):
    if dtype == "f32":
        assert _rel(got, want) < GATE, _rel(got, want)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        assert _rel(got, want) < BF16_GATE, _rel(got, want)


def _b3():
    tree = b3_tests.jax_variables(JaxEfficientNet(**b3_tests.NARROW, dtype=jnp.float32))
    return (lambda dt: JaxEfficientNet(**b3_tests.NARROW, dtype=dt), tree,
            lambda dt: b3_tests.port_from_jax(tree, dt), b3_tests.SIZE, "efficientnet")


def _efficientformer():
    cfg, size = ef_tests.NARROW, 128
    tree = ef_tests.seeded_tree(cfg, size, np.random.default_rng(4))
    return (lambda dt: JaxEFv2(num_classes=2, dtype=dt, **cfg), tree,
            lambda dt: ef_tests._port_model(cfg, size, tree, dt), size, "efficientformerv2")


def _fastervit():
    def jmodel(dt):
        return JaxFasterViT(num_classes=2, num_heads=fv_tests._heads("official"),
                            pos_mode="cpb", dtype=dt, **fv_tests.NARROW)

    params, stats = init_model_variables(jmodel(jnp.float32), jax.random.key(0),
                                         (1, fv_tests.SIZE, fv_tests.SIZE, 3))
    rng = np.random.default_rng(3)
    tree = {"params": fv_tests._perturbed(jax.device_get(params), rng),
            "batch_stats": fv_tests._perturbed(jax.device_get(stats), rng)}
    return (jmodel, tree, lambda dt: fv_tests._port_model("official", tree, dt), fv_tests.SIZE,
            "fastervit")


@pytest.fixture(scope="module", params=["b3", "efficientformerv2", "fastervit"])
def narrow(request):
    jmodel, tree, port, size, family = {"b3": _b3, "efficientformerv2": _efficientformer,
                                        "fastervit": _fastervit}[request.param]()
    x = np.random.default_rng(7).normal(size=(3, size, size, 3)).astype(np.float32)
    scales = jq.calibrate_act_scales(jmodel(jnp.float32), tree["params"], tree["batch_stats"],
                                     [jnp.asarray(x)])
    names = conv_names_from_jax(tree, family)
    return jmodel, tree, port, x, scales, {names[k]: v for k, v in scales.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_narrow_int8_forward_matches_jax(narrow, dtype, monkeypatch):
    jmodel, tree, port, x, jax_scales, port_scales = narrow
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = jmodel(jdt)
    with jq.quantized_eval(jq.QuantCtx(scales=jax_scales)), \
            jax.default_matmul_precision("highest"):  # the context is read while tracing
        want = _np(jax.jit(lambda t, v: jm.apply(t, v, train=False))(tree, jnp.asarray(x)))
    want = want.astype(np.float32)
    model = port(tdt)
    held = [v for m in model.modules() for a in vars(m).values()
            for v in (a if isinstance(a, list) else [a])]
    assert set(port_scales) <= {v.name for v in held if isinstance(v, ConvBN)}

    def refuse(*_a, **_k):
        raise AssertionError("a fused MBConv kernel ran under the int8 context")

    monkeypatch.setattr(efficientnet, "expand_dw_silu_pool", refuse)
    monkeypatch.setattr(common, "depthwise_silu_pool", refuse)
    with tq.quantized_eval(tq.QuantCtx(scales=port_scales)), torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).float().numpy()
    assert np.isfinite(got).all()
    _check(got, want, dtype)
