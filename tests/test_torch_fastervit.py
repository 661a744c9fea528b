"""The port's FasterViT (deepfakedetection_tpu_torch/models/fastervit.py)
against the JAX package's Flax model, in both head configurations.

(a) A narrow FasterViT at 224 px (dim 16, in_dim 8, depths (1, 1, 2, 1): stage
    3 still has 2x2 windows of 7x7 with carrier tokens, stage 4 one window),
    built in both packages; the JAX init, with numpy-seeded BatchNorm
    statistics, biases, layer scales, bias tables and position tables, is
    carried into the port by ``state_dict_from_jax`` and loads strictly; the
    head is fitted to spread the logits (``_fit_head``).
    float32: logits within 5e-3 of their scale (the cross-framework gate),
    equal argmax. bf16, the port through the K5 wrapper's plain version and
    the JAX model on its CPU einsum path: within 1.5e-2 of the scale, equal
    argmax where the margin is wider than twice that. Measured max|d|/scale:
    f32 1.6e-7 (official) and 2.8e-6 (tpu); bf16 6.9e-3 and 1.05e-2, where
    each framework's own bf16 run sits 1.5e-2 to 5.3e-2 from its f32 one.
(b) The full-width official FasterViT-2 has the wheel's keys and shapes
    (tests/torch_refs/fastervit_torch.py), and 13 K5 launches per bf16
    forward in both configurations (no K6 without ``DFD_FUSED_ATTN``).
(c) ``chip_smoke.py``'s logit gate for FasterViT-2 separates the seeded
    full-width model's sound bf16 run from wrong variants of its attention.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.models.fastervit import _tpu_heads
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch.models.fastervit import FasterViT, create_faster_vit, tpu_heads
from deepfakedetection_tpu_torch.ops import window_attn
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict, state_dict_from_jax
from tests.torch_refs.fastervit_torch import FasterViT2

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(dim=16, in_dim=8, depths=(1, 1, 2, 1))
OFFICIAL_HEADS = (2, 4, 8, 16)
SIZE = 224
CONFIGS = ["official", "tpu"]


def _heads(config):
    return OFFICIAL_HEADS if config == "official" else _tpu_heads(16, OFFICIAL_HEADS)


def _perturbed(tree, rng):
    """Every leaf the init leaves trivial gets a seeded value of its kind."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturbed(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k in ("mean", "bias", "conv_bias"):
            v = rng.normal(0.0, 0.1, v.shape)
        elif k.endswith("gamma"):
            v = rng.uniform(0.3, 1.0, v.shape)
        elif k == "rel_bias":
            v = rng.normal(0.0, 1.0, v.shape)
        elif k.endswith("pos_embed"):
            v = rng.normal(0.0, 0.1, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module", params=CONFIGS)
def narrow(request):
    config = request.param
    jmodel = JaxFasterViT(num_classes=2, num_heads=_heads(config),
                          pos_mode="cpb" if config == "official" else "table",
                          dtype=jnp.float32, **NARROW)
    params, stats = init_model_variables(jmodel, jax.random.key(0), (1, SIZE, SIZE, 3))
    rng = np.random.default_rng(1)
    tree = {"params": _perturbed(jax.device_get(params), rng),
            "batch_stats": _perturbed(jax.device_get(stats), rng)}
    x = np.random.default_rng(2).normal(size=(6, SIZE, SIZE, 3)).astype(np.float32)
    _fit_head(config, tree, x)
    return config, tree, x


def _fit_head(config, tree, x):
    """A head along the first principal direction of the f32 features of
    ``x``, scaled so the logit difference has a standard deviation of 2: a
    random head leaves the logits at a scale where bf16 rounding alone moves
    them by the gate (the tpu configuration read 1.5e-2 of a 0.32 scale)."""
    model = _port_model(config, tree, torch.float32)
    feats = []
    hook = model.head.register_forward_hook(lambda _m, inp, _o: feats.append(inp[0]))
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    hook.remove()
    f = feats[0].double().numpy()
    centred = f - f.mean(0)
    direction = np.linalg.svd(centred, full_matrices=False)[2][0]
    scale = 2.0 / float((centred @ direction).std())
    kernel = np.zeros((f.shape[1], 2), np.float32)
    kernel[:, 1] = scale * direction
    tree["params"]["head"] = {
        "kernel": kernel,
        "bias": np.array([0.0, -scale * float(f.mean(0) @ direction)], np.float32),
    }


def _jax_logits(config, tree, x, dtype):
    model = JaxFasterViT(num_classes=2, num_heads=_heads(config),
                         pos_mode="cpb" if config == "official" else "table", dtype=dtype,
                         **NARROW)
    with jax.default_matmul_precision("highest"):
        out = model.apply(tree, jnp.asarray(x), train=False)
    return np.asarray(out, np.float32)


def _port_model(config, tree, dtype):
    model = FasterViT(2, num_heads=tpu_heads(16, OFFICIAL_HEADS) if config == "tpu"
                      else OFFICIAL_HEADS, official=config == "official", dtype=dtype,
                      **NARROW).eval()
    load_state_dict_strict(model, state_dict_from_jax(tree, "fastervit"))
    return model


def _port_logits(config, tree, x, dtype):
    model = _port_model(config, tree, dtype)
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).float().numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_f32_logits_match_jax(narrow):
    config, tree, x = narrow
    want = _jax_logits(config, tree, x, jnp.float32)
    got = _port_logits(config, tree, x, torch.float32)
    assert np.abs(want).max() > 0.1  # a live output, not a collapsed one
    assert _rel(got, want) < 5e-3, (config, got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bf16_logits_match_jax(narrow):
    config, tree, x = narrow
    want = _jax_logits(config, tree, x, jnp.bfloat16)
    before = window_attn.window_attention.launches
    got = _port_logits(config, tree, x, torch.bfloat16)
    assert window_attn.window_attention.launches == before  # the CPU runs the plain version
    assert _rel(got, want) < 1.5e-2, (config, got, want)
    # within the gate each logit moves by under 1.5e-2 of the scale, so a
    # margin wider than twice that keeps its sign
    wide = np.abs(want[:, 1] - want[:, 0]) > 3e-2 * np.abs(want).max()
    assert wide.sum() >= len(x) // 2
    np.testing.assert_array_equal(got.argmax(-1)[wide], want.argmax(-1)[wide])


def test_tpu_heads_match_jax():
    for variant_dim, heads in ((64, (2, 4, 8, 16)), (96, (2, 4, 8, 16)), (196, (4, 8, 16, 32))):
        assert tpu_heads(variant_dim, heads) == _tpu_heads(variant_dim, heads)


def test_official_full_width_takes_the_wheel_state_dict():
    port = create_faster_vit("2", head_config="official", dtype=torch.float32).state_dict()
    ref = FasterViT2(num_classes=2).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


@pytest.mark.parametrize("config", CONFIGS)
def test_full_width_launches_k5_thirteen_times_per_forward(config):
    model = create_faster_vit("2", head_config=config)
    assert model.kernel_launches_per_forward() == {"k5": 13, "k6": 0}
    # a fine-tune step runs the backward of each, the head-only warmup none
    assert model.kernel_launches_per_step() == {"k5": 13, "k5_bwd": 13, "k6": 0, "k6_bwd": 0}
    assert model.kernel_launches_per_step(head_only=True) == {"k5": 13, "k5_bwd": 0, "k6": 0,
                                                              "k6_bwd": 0}
    f32 = create_faster_vit("2", head_config=config, dtype=torch.float32)
    assert f32.kernel_launches_per_forward() == {"k5": 0, "k6": 0}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _one_head_v(attend):
    """Every head attends over head 0's values."""
    def wrong(qkv, bias, num_heads, scale):
        C = qkv.shape[-1] // 3
        v0 = qkv[..., 2 * C: 2 * C + C // num_heads].repeat(1, 1, num_heads)
        return attend(torch.cat([qkv[..., :2 * C], v0], -1), bias, num_heads=num_heads,
                      scale=scale)
    return wrong


WRONG = {
    "scale times 1.5": lambda attend: lambda qkv, b, num_heads, scale: attend(
        qkv, b, num_heads=num_heads, scale=1.5 * scale),
    "scale doubled": lambda attend: lambda qkv, b, num_heads, scale: attend(
        qkv, b, num_heads=num_heads, scale=2 * scale),
    "bias dropped": lambda attend: lambda qkv, b, num_heads, scale: attend(
        qkv, torch.zeros_like(b), num_heads=num_heads, scale=scale),
    "one head's v": _one_head_v,
}


@pytest.fixture(scope="module")
def gate_references():
    """Per configuration, computed once for the module: the seeded full-width
    FasterViT-2 of ``seeded_fastervit_state``, its 8 seeded images, its f32
    logits on the CPU (the reference) and the bf16 model that the sound run
    and every wrong variant go through."""
    smoke = _chip_smoke()
    cache = {}

    def get(config):
        if config not in cache:
            cpu = torch.device("cpu")
            state = smoke.seeded_fastervit_state(config, seed=11 if config == "official" else 13)
            x = smoke.seeded_images(8, torch.Generator().manual_seed(12))
            f32 = smoke.fastervit_logits(state, config, x, cpu, torch.float32).double()
            model = create_faster_vit("2", head_config=config, dtype=torch.bfloat16)
            model.load_state_dict(state)
            cache[config] = (smoke.FV_GATE[config], x, f32, model.eval())
        return cache[config]

    return get


@pytest.mark.parametrize("config,wrong", [
    ("official", ("scale times 1.5", "scale doubled", "bias dropped", "one head's v")),
    ("tpu", ("scale times 1.5", "scale doubled", "one head's v")),
])
def test_chip_smoke_gate_separates_wrong_attention(monkeypatch, gate_references, config, wrong):
    """``chip_smoke.FV_GATE[config]`` on the seeded full-width FasterViT-2 of
    ``seeded_fastervit_state``: the CPU's bf16 logits sit inside it against
    the f32 ones (measured 1.7e-3 official, 5.7e-4 tpu), and wrong variants
    of the window attention fall outside (scale times 1.5 3.0e-2 and 5.8e-3,
    doubled 6.7e-2 and 1.2e-2, bias dropped 8.0e-2 official, one head's
    values for all 0.83 and 0.17)."""
    from deepfakedetection_tpu_torch.models import fastervit

    gate, x, f32, model = gate_references(config)

    def rel():
        with torch.no_grad():
            out = model(x).double()
        return float((out - f32).abs().max() / f32.abs().max())

    assert rel() < gate
    attend = fastervit.window_attention
    for name in wrong:
        monkeypatch.setattr(fastervit, "window_attention", WRONG[name](attend))
        assert rel() > gate, name
