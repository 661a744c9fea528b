"""The port's export (deepfakedetection_tpu_torch/export.py) and the
``torch.ops.dfd`` operators its kernels are called through, on the CPU.

(a) ``torch.library.opcheck`` (schema, fake tensor, autograd registration,
    AOT dispatch with dynamic shapes) on every operator's CPU implementation
    at small shapes; K5's qkv and v1-layout inputs and K7's q, k and v as
    strided views.
(b) A narrow B3 in f32 from a JAX tree (``state_dict_from_jax``), exported on
    the CPU, against the JAX package's ``jax.export`` of the same weights'
    softmax forward (as the root ``export.py`` builds it), serialized,
    deserialized and called: the logit differences log p1 - log p0 within
    ``tests/test_cross_framework.py``'s gate (max|d| / scale < 5e-3) and
    equal argmax.
(c) bf16 round trips of a narrow B3 (with and without ``DFD_FUSED_MBCONV``),
    a narrow FasterViT (with and without ``DFD_FUSED_ATTN``) and a narrow
    EfficientFormerV2: each graph holds one ``torch.ops.dfd`` node for each
    launch the model's own blocks count (``kernel_launches_per_forward``);
    ``load_exported`` in a fresh interpreter gives the eager eval step's
    probabilities bit for bit and imports no model module.
(d) An input a wrapper rejects is rejected by the export with the wrapper's
    message; ``frozen_derived`` refuses a value no eager forward computed;
    the CLI writes the program and the weights beside it; without ``--device
    cpu`` and without a card the export raises.
"""

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jax_export

from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu_torch import export, registry
from deepfakedetection_tpu_torch.evaluate.job import make_eval_step
from deepfakedetection_tpu_torch.models import common
from deepfakedetection_tpu_torch.models.efficientformer_v2 import EfficientFormerV2
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
from deepfakedetection_tpu_torch.models.fastervit import FasterViT
from deepfakedetection_tpu_torch.ops import attn4d as k7
from deepfakedetection_tpu_torch.ops import depthwise_se as k1
from deepfakedetection_tpu_torch.ops import window_attn as k5
from tests import test_torch_efficientnet as b3_tests
from tests import test_torch_fused_mbconv as k3_tests

REPO = Path(__file__).resolve().parents[1]
FV_NARROW = dict(dim=16, in_dim=8, depths=(1, 1, 2, 1))
EF_NARROW = dict(dims=(16, 24, 32, 48), depths=(1, 1, 3, 2), vit_num=1,
                 e_ratios={0: [4], 1: [4], 2: [4, 3, 4], 3: [4, 4]})
OPS = {"k1": "depthwise_silu_pool", "k2": "expand_dw_silu_pool", "k3": "fused_mbconv_se",
       "k5": "window_attention", "k6": "attn_subblock", "k7": "attn4d"}
# name -> (builder, image size, switch set while the model is built)
CASES = {
    "b3": (lambda: EfficientNet(**b3_tests.NARROW), 32, None),
    "b3_k3": (lambda: EfficientNet(**b3_tests.NARROW), 32, "DFD_FUSED_MBCONV"),
    "fastervit": (lambda: FasterViT(2, num_heads=(2, 4, 8, 16), **FV_NARROW), 224, None),
    "fastervit_k6": (lambda: FasterViT(2, num_heads=(2, 4, 8, 16), **FV_NARROW), 224,
                     "DFD_FUSED_ATTN"),
    "efficientformerv2": (lambda: EfficientFormerV2(2, **EF_NARROW, img_size=128), 128, None),
}
LOAD = """
import json, sys, torch
torch.set_num_threads(2)
from deepfakedetection_tpu_torch.export import load_exported
folder, names = sys.argv[1], sys.argv[2:]
for name in names:
    program = load_exported(f"{folder}/{name}.pt2")
    x = torch.load(f"{folder}/{name}_x.pt", weights_only=True)
    torch.save(program(x), f"{folder}/{name}_out.pt")
print("MODELS", json.dumps(sorted(m for m in sys.modules
                                  if m.startswith("deepfakedetection_tpu_torch.models"))))
"""


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (the suite runs a file a
    worker on a few cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _images(n, size, seed):
    x = np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _nodes(module) -> dict[str, int]:
    """The ``torch.ops.dfd`` nodes of a program's graphs, by operator."""
    counts: dict[str, int] = {}
    for gm in module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.op == "call_function" and str(node.target).startswith("dfd."):
                    name = str(node.target).split(".")[1]
                    counts[name] = counts.get(name, 0) + 1
    return counts


@pytest.fixture(scope="module")
def round_trips(tmp_path_factory):
    """Each case exported in bf16, its eager probabilities, and the
    probabilities ``load_exported`` gave in a fresh interpreter."""
    folder = tmp_path_factory.mktemp("programs")
    out = {}
    for name, (build, size, switch) in CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            if switch:
                mp.setenv(switch, "1")
            torch.manual_seed(0)
            model = build().eval()
        x = _images(2, size, seed=len(name))
        program = export.export_program(model, x)
        torch.save(x, folder / f"{name}_x.pt")
        torch.export.save(program, folder / f"{name}.pt2")
        eager = make_eval_step(model)(x.permute(0, 3, 1, 2))
        out[name] = {"model": model, "program": program, "eager": eager}
    proc = subprocess.run([sys.executable, "-c", LOAD, str(folder), *CASES], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in CASES:
        out[name]["loaded"] = torch.load(folder / f"{name}_out.pt", weights_only=True)
    line = next(x for x in proc.stdout.splitlines() if x.startswith("MODELS "))
    return out, json.loads(line[len("MODELS "):])


@pytest.mark.parametrize("name", list(CASES))
def test_graph_holds_an_operator_node_for_each_launch(round_trips, name):
    case = round_trips[0][name]
    want = {OPS[k]: v for k, v in case["model"].kernel_launches_per_forward().items() if v}
    assert want and _nodes(case["program"].graph_module) == want


@pytest.mark.parametrize("name", list(CASES))
def test_program_loaded_in_a_fresh_interpreter_equals_the_eager_step(round_trips, name):
    case = round_trips[0][name]
    assert case["loaded"].dtype == torch.float32 and case["loaded"].shape == (2, 2)
    assert torch.equal(case["loaded"], case["eager"])


def test_load_exported_imports_no_model_module(round_trips):
    assert round_trips[1] == []


def _window_inputs(g):
    B, N, C, h = 3, 40, 64, 4
    big = torch.randn(B, N, 3 * C + 16, generator=g).to(torch.bfloat16)
    return big[..., 16:], torch.randn(h, N, N, generator=g), h


def _op_args(name):
    """Small inputs of each operator, non-contiguous where the wrapper takes
    views."""
    g = torch.Generator().manual_seed(7)
    if name == "depthwise_silu_pool":
        return (torch.randn(2, 6, 7, 16, generator=g).to(torch.bfloat16),
                torch.randn(3, 3, 16, generator=g), torch.randn(16, generator=g), 3)
    if name == "expand_dw_silu_pool":
        return (torch.randn(2, 6, 7, 8, generator=g).to(torch.bfloat16),
                torch.randn(8, 24, generator=g), torch.randn(24, generator=g),
                torch.randn(5, 5, 24, generator=g), torch.randn(24, generator=g), 5)
    if name == "fused_mbconv_se":
        rng = np.random.default_rng(3)
        return (k3_tests._x(rng, 2, 6, 6, 16),
                *(torch.from_numpy(a) for a in k3_tests._args(rng, 16, 3)), 3)
    if name == "window_attention":
        qkv, bias, h = _window_inputs(g)
        return qkv, bias, h, 0.25
    if name == "window_attention_heads":
        q = torch.randn(3, 40, 4, 16, generator=g).to(torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn(3, 4, 40, 16, generator=g).to(torch.bfloat16) for _ in range(2))
        return q, k, v, torch.randn(4, 40, 40, generator=g), 0.25
    if name == "attn_subblock":
        B, N, C, h = 4, 20, 32, 2
        return (torch.randn(B, N, C, generator=g).to(torch.bfloat16),
                torch.randn(3 * C, C, generator=g) * 0.1, torch.randn(3 * C, generator=g),
                torch.randn(h, N, N, generator=g), torch.randn(C, C, generator=g) * 0.1,
                torch.randn(C, generator=g), h, 0.25)
    B, N, h, d, dv = 2, 20, 4, 16, 32
    qkv = torch.randn(B, N, 2 * h * d + h * dv, generator=g).to(torch.bfloat16)
    tables = [torch.randn(*s, generator=g) for s in ((h, N, N), (h, h), (h,), (h, h), (h,))]
    return (qkv[..., :h * d], qkv[..., h * d:2 * h * d], qkv[..., 2 * h * d:], *tables, h, 0.25)


@pytest.mark.parametrize("name", ["depthwise_silu_pool", "expand_dw_silu_pool",
                                  "fused_mbconv_se", "window_attention",
                                  "window_attention_heads", "attn_subblock", "attn4d"])
def test_operator_passes_opcheck(name):
    args = _op_args(name)
    assert any(isinstance(a, torch.Tensor) for a in args)
    result = torch.library.opcheck(getattr(torch.ops.dfd, name), args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_f32_b3_program_matches_the_jax_export():
    jmodel = JaxEfficientNet(**b3_tests.NARROW, dtype=jnp.float32)
    variables = b3_tests.jax_variables(jmodel, seed=3)
    x = _images(4, b3_tests.SIZE, seed=5)

    def forward(params, batch_stats, images):
        logits = jmodel.apply({"params": params, "batch_stats": batch_stats}, images,
                              train=False)
        return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

    spec = lambda t: jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), t)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        exported = jax_export.export(jax.jit(forward))(
            spec(variables["params"]), spec(variables["batch_stats"]),
            jax.ShapeDtypeStruct(tuple(x.shape), jnp.bfloat16))
    restored = jax_export.deserialize(exported.serialize())
    want = np.asarray(restored.call(variables["params"], variables["batch_stats"],
                                    jnp.asarray(x.float().numpy(), jnp.bfloat16)), np.float64)
    program = export.export_program(b3_tests.port_from_jax(variables, torch.float32), x)
    got = program.module()(x).double().numpy()

    def logit_diff(p):
        return np.log(p[:, 1]) - np.log(p[:, 0])

    scale = max(float(np.abs(logit_diff(want)).max()), 1e-3)
    assert float(np.abs(logit_diff(got) - logit_diff(want)).max()) / scale < 5e-3
    assert (got.argmax(-1) == want.argmax(-1)).all()


class _Calls(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _rejected(case):
    """(a module over a wrapper, inputs that wrapper rejects)."""
    g = torch.Generator().manual_seed(1)
    if case == "k1_f32_x":
        w, b = torch.randn(3, 3, 8, generator=g), torch.randn(8, generator=g)
        return (_Calls(lambda x: k1.depthwise_silu_pool(x, w, b, k=3)[0]),
                (torch.randn(2, 5, 5, 8, generator=g),))
    if case == "k5_too_many_tokens":
        return (_Calls(lambda qkv, bias: k5.window_attention(qkv, bias, num_heads=2,
                                                             scale=0.5)),
                (torch.randn(2, k5.LONG_INT_TOKENS + 1, 48, generator=g).to(torch.bfloat16),
                 torch.randn(2, 8, 8, generator=g)))
    *qkv, bias, th1, th1_b, th2, th2_b, _, _ = _op_args("attn4d")
    return (_Calls(lambda q: k7.attn4d(q, *qkv[1:], bias, th1, th1_b, th2, th2_b,
                                       num_heads=4, scale=0.25)),
            (qkv[0].transpose(1, 2).contiguous().transpose(1, 2),))


@pytest.mark.parametrize("case", ["k1_f32_x", "k5_too_many_tokens", "k7_feature_stride"])
def test_rejected_input_raises_at_export_time_with_the_wrappers_message(case):
    module, args = _rejected(case)
    with pytest.raises(ValueError) as eager:
        module(*args)
    with pytest.raises(ValueError, match=re.escape(str(eager.value))):
        torch.export.export(module, args, strict=False)


def test_frozen_derived_refuses_a_value_no_forward_computed():
    model = EfficientNet(**b3_tests.NARROW).eval()
    with common.frozen_derived(), pytest.raises(RuntimeError, match="no eager forward"):
        model(_images(1, 32, seed=0).permute(0, 3, 1, 2))


def _narrow_b3_spec(name, _spec=registry.get_model_spec):
    return dataclasses.replace(
        _spec(name),
        builder=lambda num_classes, dtype, generator, **kw: EfficientNet(
            **b3_tests.NARROW, dtype=dtype, generator=generator))


def test_cli_writes_the_program_and_the_weights_beside_it(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(registry, "get_model_spec", _narrow_b3_spec)
    source = EfficientNet(**b3_tests.NARROW, generator=torch.Generator().manual_seed(5))
    torch.save(source.state_dict(), tmp_path / "b3.pth")
    out = tmp_path / "exports" / "b3.pt2"
    monkeypatch.setattr(sys, "argv", ["export", "--model", "efficientnet_b3", "--weights",
                                      str(tmp_path / "b3.pth"), "--out", str(out), "--batch",
                                      "2", "--img-size", "32", "--device", "cpu"])
    export.main()
    assert "exported:" in capsys.readouterr().out
    weights = torch.load(out.with_suffix(".weights.pth"), weights_only=True)
    assert all(torch.equal(weights[k], v) for k, v in source.state_dict().items())
    x = _images(2, 32, seed=9)
    source.eval()
    assert torch.equal(export.load_exported(out, device="cpu")(x),
                       make_eval_step(source)(x.permute(0, 3, 1, 2)))
    with pytest.raises((AssertionError, RuntimeError)):  # the batch is static
        export.load_exported(out)(_images(3, 32, seed=9))


def test_export_needs_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        export.export_model("efficientnet_b3", None, tmp_path / "b3.pt2", batch=1, img_size=32)
    assert not (tmp_path / "b3.pt2").exists()
