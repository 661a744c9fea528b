"""The port's EfficientFormerV2 (deepfakedetection_tpu_torch/models/
efficientformer_v2.py) against the JAX package's Flax model and timm's
module layout.

(a) A narrow EFv2 at 128 px (dims (16, 24, 32, 48), depths (1, 1, 3, 2), one
    attention block per attention stage: 4x4 tokens there, a 64 x 256 token
    downsample) and the full-width S1 at 224 px (7x7 tokens, the 196 x 784
    downsample), batch 2, built in both packages from one numpy-seeded tree
    (``jax.eval_shape`` gives its shapes) carried into the port by
    ``state_dict_from_jax``, which must load strictly; both heads fitted to
    spread the logits. float32: logits within 5e-3 of their scale (the
    cross-framework gate), equal argmax. bf16, the port through K7's plain
    version (the JAX kernel branch's rounding: K7's bf16 output, then the
    local-v sum) against the JAX model on its CPU einsum path (one rounding
    there): within 2.5e-2 of the scale, equal argmax where the margin is wider
    than twice that. Measured max|d|/scale: f32 6.0e-7 (narrow) and 3.6e-7
    (S1); bf16 3.0e-3 and 9.6e-3, where the JAX model's own bf16 run sits
    1.1e-2 and 1.3e-2 from its f32 one (the port's 1.2e-2 and 3.5e-3).
(b) The bilinear 2x upsample of the stride-2 attention equals
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, edges clamped.
(c) A timm-named state dict (tests/torch_refs/efficientformer_v2_torch.py,
    with the ``proj.1`` spelling) loads with no key left over and gives the
    reference's logits (erf GELU on both sides, f32: 1e-4 of the scale); a
    nonzero conv bias gives the logits of its folded form.
(d) ``chip_smoke.py``'s logit gate for EfficientFormerV2-S1 separates the
    seeded model's sound bf16 run from wrong variants of its attention.
(e) The port's EFv2 recipe selects, name by name through the converter's
    name map, the JAX package's training sets on S1: its ``unfreeze`` keys
    the 116 fine-tune tensors (stage 4's blocks, the final norm, both heads
    and every talking head), its head substrings the 20 warmup tensors.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepfakedetection_tpu.models.efficientformer_v2 import _VARIANTS
from deepfakedetection_tpu.models.efficientformer_v2 import EfficientFormerV2 as JaxEFv2
from deepfakedetection_tpu.registry import get_model_spec as jax_model_spec
from deepfakedetection_tpu.train import optim as jax_optim
from deepfakedetection_tpu_torch.models import efficientformer_v2 as efv2
from deepfakedetection_tpu_torch.models.efficientformer_v2 import (
    EfficientFormerV2,
    create_efficientformer_v2,
)
from deepfakedetection_tpu_torch.ops import attn4d as k7
from deepfakedetection_tpu_torch.registry import get_model_spec as port_model_spec
from deepfakedetection_tpu_torch.runtime.convert import (
    _MAPS,
    _flatten,
    load_state_dict_strict,
    state_dict_from_jax,
)
from deepfakedetection_tpu_torch.train import optim as port_optim
from tests.torch_refs.efficientformer_v2_torch import EfficientFormerV2S1

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(dims=(16, 24, 32, 48), depths=(1, 1, 3, 2), vit_num=1,
              e_ratios={0: [4], 1: [4], 2: [4, 3, 4], 3: [4, 4]})
S1 = {k: _VARIANTS["s1"][k] for k in ("dims", "depths", "vit_num", "e_ratios")}
CONFIGS = {"narrow": (NARROW, 128), "s1": (S1, 224)}


def seeded_tree(cfg, size, rng):
    """A JAX variables tree of the model: kernels N(0, 1/fan_in), talking
    heads N(0, 0.25), bias tables N(0, 0.25), BN scales U(0.8, 1.2) and
    variances U(0.5, 1.5), layer scales U(0.2, 0.5), other leaves N(0, 0.01)."""
    model = JaxEFv2(num_classes=2, dtype=jnp.float32, **cfg)
    shapes = jax.eval_shape(lambda key, x: model.init(key, x, train=False), jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("talking_head1", "talking_head2", "attention_biases"):
            v = rng.normal(size=shape) * 0.5
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "gamma":
            v = rng.uniform(0.2, 0.5, shape)
        else:
            v = rng.normal(size=shape) * 0.1
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def _port_model(cfg, size, tree, dtype):
    model = EfficientFormerV2(2, **cfg, img_size=size, dtype=dtype).eval()
    load_state_dict_strict(model, state_dict_from_jax(tree, "efficientformerv2"))
    return model


def _fit_heads(cfg, size, tree, x):
    """Both heads along the first principal direction of the f32 features
    of ``x``, the logit difference at a standard deviation of 2."""
    model = _port_model(cfg, size, tree, torch.float32)
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
    bias = np.array([0.0, -scale * float(f.mean(0) @ direction)], np.float32)
    for name in ("head", "head_dist"):
        tree["params"][name] = {"kernel": kernel, "bias": bias}


@pytest.fixture(scope="module", params=list(CONFIGS))
def model_case(request):
    cfg, size = CONFIGS[request.param]
    tree = seeded_tree(cfg, size, np.random.default_rng(0))
    x = np.random.default_rng(1).normal(size=(2 if request.param == "s1" else 4, size, size, 3))
    x = x.astype(np.float32)
    _fit_heads(cfg, size, tree, x)
    return cfg, size, tree, x


def _jax_logits(cfg, tree, x, dtype):
    with jax.default_matmul_precision("highest"):
        out = JaxEFv2(num_classes=2, dtype=dtype, **cfg).apply(tree, jnp.asarray(x), train=False)
    return np.asarray(out, np.float32)


def _port_logits(cfg, size, tree, x, dtype):
    with torch.no_grad():
        out = _port_model(cfg, size, tree, dtype)(torch.from_numpy(x).permute(0, 3, 1, 2))
    return out.float().numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_f32_logits_match_jax(model_case):
    cfg, size, tree, x = model_case
    want = _jax_logits(cfg, tree, x, jnp.float32)
    got = _port_logits(cfg, size, tree, x, torch.float32)
    assert np.abs(want).max() > 0.5  # a live, fitted output
    assert _rel(got, want) < 5e-3, (got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bf16_logits_match_jax(model_case):
    cfg, size, tree, x = model_case
    want = _jax_logits(cfg, tree, x, jnp.bfloat16)
    before = k7.attn4d.launches
    got = _port_logits(cfg, size, tree, x, torch.bfloat16)
    assert k7.attn4d.launches == before  # the CPU runs the plain version
    assert _rel(got, want) < 2.5e-2, (got, want)
    wide = np.abs(want[:, 1] - want[:, 0]) > 5e-2 * np.abs(want).max()
    assert wide.sum() >= len(x) // 2
    np.testing.assert_array_equal(got.argmax(-1)[wide], want.argmax(-1)[wide])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_upsample_matches_jax_resize(dtype):
    """The stride-2 attention's 7x7 -> 14x14 upsample (and an odd 5x6 ->
    10x12): exact in f32 up to summation order, within one bf16 step of each
    value in bf16 (both round once)."""
    rng = np.random.default_rng(3)
    for h, w in ((7, 7), (5, 6)):
        x = rng.normal(size=(2, h, w, 24)).astype(np.float32)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        want = np.asarray(jax.image.resize(jnp.asarray(tx.float().numpy(), dtype),
                                           (2, 2 * h, 2 * w, 24), "bilinear"), np.float32)
        got = F.interpolate(tx.permute(0, 3, 1, 2), size=(2 * h, 2 * w), mode="bilinear",
                            align_corners=False).permute(0, 2, 3, 1).float().numpy()
        atol, rtol = (1e-6, 1e-6) if dtype == "float32" else (2.0**-8, 2.0**-7)
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _perturbed_ref(seed):
    """The torch reference S1 with seeded BN statistics, biases, layer
    scales, talking heads and bias tables (its init leaves most trivial)."""
    g = torch.Generator().manual_seed(seed)
    ref = EfficientFormerV2S1(num_classes=2).eval()
    with torch.no_grad():
        for name, t in ref.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith(("running_mean", ".bias", "attention_biases")):
                t.copy_(0.2 * torch.randn(t.shape, generator=g))
            elif name.endswith("gamma"):
                t.copy_(0.2 + 0.3 * torch.rand(t.shape, generator=g))
            elif "talking_head" in name:
                t.copy_(0.5 * torch.randn(t.shape, generator=g))
    return ref


def test_timm_named_state_dict_loads_and_gives_the_references_logits(monkeypatch):
    monkeypatch.setenv("DFD_EXACT_GELU", "1")  # the reference's nn.GELU is the erf form
    ref = _perturbed_ref(4)
    state = ref.state_dict()
    assert any(".proj.1.conv." in k for k in state)
    port = create_efficientformer_v2("s1", dtype=torch.float32).eval()
    missing, unexpected = port.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want, got = ref(x), port(x)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4, (got, want)
    # the port's own spelling comes back out, and loads again
    assert not any(".proj.1." in k for k in port.state_dict())
    load_state_dict_strict(create_efficientformer_v2("s1", dtype=torch.float32),
                           port.state_dict())


def test_conv_bias_gives_the_logits_of_its_folded_form():
    """timm's ConvNorms may carry conv biases: conv(x) + c -> BN(mean) equals
    conv(x) -> BN(mean - c). Both dicts load strictly."""
    ref = _perturbed_ref(6)
    folded = {k: v.clone() for k, v in ref.state_dict().items()}
    with_bias = {k: v.clone() for k, v in folded.items()}
    g = torch.Generator().manual_seed(7)
    for key in [k for k in folded if k.endswith(".conv.weight")]:
        prefix = key[: -len("conv.weight")]
        c = 0.3 * torch.randn(folded[key].shape[0], generator=g)
        with_bias[prefix + "conv.bias"] = c
        with_bias[prefix + "bn.running_mean"] = folded[prefix + "bn.running_mean"] + c
    # the shifted means without the biases: what dropping them would give
    dropped = {k: v for k, v in with_bias.items() if not k.endswith(".conv.bias")}
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(8))
    out = {}
    for name, state in (("dropped", dropped), ("folded", folded), ("bias", with_bias)):
        model = create_efficientformer_v2("s1", dtype=torch.float32).eval()
        missing, unexpected = model.load_state_dict(state, strict=True)
        assert not missing and not unexpected
        with torch.no_grad():
            out[name] = model(x)
    convs = [m for m in model.modules() if isinstance(m, efv2.ConvNorm)]
    assert convs and all(m.conv.bias is not None for m in convs)
    scale = float(out["folded"].abs().max())
    assert float((out["bias"] - out["folded"]).abs().max()) < 1e-4 * scale
    assert float((out["dropped"] - out["folded"]).abs().max()) > 1e-2 * scale  # they matter


def test_full_width_launches_k7_four_times_per_forward():
    assert create_efficientformer_v2("s1").kernel_launches_per_forward() == {"k7": 4,
                                                                              "k7_long": 0}
    assert create_efficientformer_v2("s1", dtype=torch.float32).kernel_launches_per_forward() \
        == {"k7": 0, "k7_long": 0}
    # at 384 px stages 3 and 4 attend over 12 x 12 = 144 tokens: K7's long kernel
    assert create_efficientformer_v2("s1", img_size=384).kernel_launches_per_forward() == {
        "k7": 0, "k7_long": 4}
    assert [a.resolution for a in create_efficientformer_v2("s1").attentions()] == [7] * 4


def test_bias_index_is_timms():
    """slot = |dy|·W + |dx| on the attention's grid, |2qy - ky|·W + |2qx - kx|
    from the downsample's query grid."""
    ref = EfficientFormerV2S1(num_classes=2)
    blk = ref.stages[2].blocks[7].token_mixer
    down = ref.stages[2].downsample.attn
    assert np.array_equal(efv2.bias_index(7, 7), blk.attention_bias_idxs.numpy())
    assert np.array_equal(efv2.bias_index(14, 28, stride=2), down.attention_bias_idxs.numpy())


def test_training_forward_raises():
    """A training forward runs at the size the model was built for (its
    gradient checks are ``tests/test_torch_efficientformer_v2_train.py``'s)
    and raises, naming the size it was built for, at any other."""
    model = EfficientFormerV2(2, **NARROW, img_size=128).train()
    with pytest.raises(ValueError, match="built for 16x16"):
        model(torch.zeros(2, 3, 160, 160))
    logits = model(torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(0)))
    assert logits.shape == (2, 2) and logits.requires_grad and torch.isfinite(logits).all()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _th1_transposed(attend):
    def wrong(q, k, v, bias, th1, th1_b, th2, th2_b, *, num_heads, scale):
        return attend(q, k, v, bias, th1.t().contiguous(), th1_b, th2, th2_b,
                      num_heads=num_heads, scale=scale)
    return wrong


def _th2_bias_dropped(attend):
    def wrong(q, k, v, bias, th1, th1_b, th2, th2_b, *, num_heads, scale):
        return attend(q, k, v, bias, th1, th1_b, th2, torch.zeros_like(th2_b),
                      num_heads=num_heads, scale=scale)
    return wrong


def test_chip_smoke_gate_separates_wrong_attention(monkeypatch):
    """``chip_smoke.EFV2_GATE`` on the seeded full-width S1 of
    ``seeded_efficientformer_state``: the CPU's bf16 logits sit inside it
    against the f32 ones, and K7 with th1 transposed or th2's bias dropped
    falls outside."""
    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    state = smoke.seeded_efficientformer_state(seed=31)
    x = smoke.seeded_images(8, torch.Generator().manual_seed(32))
    f32 = smoke.efficientformer_logits(state, x, cpu, torch.float32).double()

    def rel():
        out = smoke.efficientformer_logits(state, x, cpu, torch.bfloat16).double()
        return float((out - f32).abs().max() / f32.abs().max())

    assert rel() < smoke.EFV2_GATE
    attend = efv2.attn4d
    for wrong in (_th1_transposed, _th2_bias_dropped):
        monkeypatch.setattr(efv2, "attn4d", wrong(attend))
        assert rel() > smoke.EFV2_GATE, wrong.__name__


def test_training_sets_match_the_jax_package():
    model = JaxEFv2(num_classes=2, dtype=jnp.float32, **S1)
    shapes = jax.eval_shape(lambda key, x: model.init(key, x, train=False), jax.random.key(0),
                            jnp.zeros((1, 224, 224, 3)))
    jax_paths = jax_optim.param_path_strings(shapes["params"])
    name_map = _MAPS["efficientformerv2"]({p[1] for p in _flatten(shapes)})
    names = [n for n, _ in efv2.create_efficientformer_v2("s1").named_parameters()]
    assert len(names) == len(jax_paths) == 357
    jax_recipe, recipe = (jax_model_spec("efficientformerv2_s1").recipe,
                          port_model_spec("efficientformerv2_s1").recipe)
    for jax_pred, pred, size in (
        (jax_optim.unfreeze_predicate(jax_recipe.unfreeze),
         port_optim.unfreeze_predicate(recipe.unfreeze), 116),
        (jax_optim.head_predicate(jax_recipe.head_param_substrings),
         port_optim.head_predicate(recipe.head_param_substrings), 20),
    ):
        want = {p for p in jax_paths if jax_pred(p)}
        got = {"/".join(name_map[n][0]) for n in names if pred(n)}
        assert len(want) == size and got == want, sorted(got ^ want)[:8]
