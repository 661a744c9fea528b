"""The port's FasterViT at the image sizes past and below 224 px against the
JAX package's Flax model, and what the port refuses there.

(a) A narrow FasterViT (dim 16, in_dim 8, depths (1, 1, 2, 1)) at 64 px
    (stage 3 a 4 x 4 map, stage 4 2 x 2) and 112 px (stage 3 one 7 x 7
    window: ``PlainBlock``s over its 49 tokens, no carrier tokens, as the JAX
    model's degenerate branch) in both head configurations, at 448 px
    (stage 3 4 x 4 windows with 64 carrier tokens, stage 4 14 x 14 = 196
    tokens) and at 560 px (stage 3 5 x 5 windows with 100 carrier tokens,
    stage 4 18 x 18 = 324 tokens: K5's long kernels past 256), built in
    both packages; the JAX init with numpy-seeded
    statistics, biases, layer scales and tables is carried over by
    ``state_dict_from_jax`` and loads strictly; the head is fitted to spread
    the logits. float32 logits within 5e-3 of their scale
    (``tests/test_cross_framework.py``'s gate), equal argmax. At 448 and 560
    also bf16 (the port through K5's plain versions, its long kernels' at
    stage 4) within ``tests/test_torch_fastervit.py``'s 1.5e-2.
(b) The launches a bf16 forward makes at each size, and the degenerate
    stage's names: ``levels.2.blocks.{b}.*`` with the suffixes of the stage-4
    ``PlainBlock``s.
(c) Under ``DFD_FUSED_ATTN`` a bf16 model whose attention exceeds K6's 128
    tokens is refused when it is built, and the trainer refuses its job
    before any work, both naming the ROADMAP item; at 224 px it builds.
(d) The JAX rule that refuses a stage 3 of more than one window that the
    window does not divide.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.models.fastervit import _tpu_heads
from deepfakedetection_tpu_torch.models.fastervit import K6_LONG_ITEM, FasterViT, tpu_heads
from deepfakedetection_tpu_torch.registry import get_model_spec
from deepfakedetection_tpu_torch.runtime.convert import (
    fastervit_head_config,
    load_state_dict_strict,
    state_dict_from_jax,
)
from deepfakedetection_tpu_torch.train.loop import TrainJob, unported_options
from tests.test_torch_fastervit import _perturbed

NARROW = dict(dim=16, in_dim=8, depths=(1, 1, 2, 1))
OFFICIAL_HEADS = (2, 4, 8, 16)
CASES = [(64, "official"), (64, "tpu"), (112, "official"), (112, "tpu"), (448, "official"),
         (448, "tpu"), (560, "official"), (560, "tpu")]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _jax_model(config, dtype):
    return JaxFasterViT(num_classes=2, num_heads=OFFICIAL_HEADS if config == "official"
                        else _tpu_heads(16, OFFICIAL_HEADS),
                        pos_mode="cpb" if config == "official" else "table", dtype=dtype,
                        **NARROW)


def _port_model(config, size, tree, dtype):
    model = FasterViT(2, num_heads=OFFICIAL_HEADS if config == "official"
                      else tpu_heads(16, OFFICIAL_HEADS), official=config == "official",
                      img_size=size, dtype=dtype, **NARROW).eval()
    load_state_dict_strict(model, state_dict_from_jax(tree, "fastervit"))
    return model


def _batch(size):
    return np.random.default_rng(size).normal(size=(4, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    """Each case's seeded JAX tree with a fitted head, by (size, config)."""
    out = {}
    for size, config in CASES:
        shapes = jax.eval_shape(
            lambda key, x, m=_jax_model(config, jnp.float32): m.init(key, x, train=False),
            jax.random.key(0), jnp.zeros((1, size, size, 3)))
        rng = np.random.default_rng(size)
        base = jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s.shape) / np.sqrt(max(np.prod(s.shape[:-1]), 1)))
            .astype(np.float32), shapes)
        tree = {"params": _perturbed(base["params"], rng),
                "batch_stats": _perturbed(base["batch_stats"], rng)}
        _fit_head(config, size, tree)
        out[size, config] = tree
    return out


def _fit_head(config, size, tree):
    """A head along the first principal direction of the f32 features, the
    logit difference at a standard deviation of 2."""
    model = _port_model(config, size, tree, torch.float32)
    feats = []
    hook = model.head.register_forward_hook(lambda _m, inp, _o: feats.append(inp[0]))
    with torch.no_grad():
        model(torch.from_numpy(_batch(size)).permute(0, 3, 1, 2))
    hook.remove()
    f = feats[0].double().numpy()
    centred = f - f.mean(0)
    direction = np.linalg.svd(centred, full_matrices=False)[2][0]
    scale = 2.0 / float((centred @ direction).std())
    kernel = np.zeros((f.shape[1], 2), np.float32)
    kernel[:, 1] = scale * direction
    tree["params"]["head"] = {
        "kernel": kernel, "bias": np.array([0.0, -scale * float(f.mean(0) @ direction)],
                                           np.float32)}


def _logits(config, size, tree, dtype):
    x = _batch(size)
    with torch.no_grad():
        got = _port_model(config, size, tree, torch.float32 if dtype == "f32" else
                          torch.bfloat16)(torch.from_numpy(x).permute(0, 3, 1, 2))
    with jax.default_matmul_precision("highest"):
        want = _jax_model(config, jnp.float32 if dtype == "f32" else jnp.bfloat16).apply(
            tree, jnp.asarray(x), train=False)
    return got.float().numpy(), np.asarray(want, np.float32)


def _check(got, want, gate):
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert np.abs(want).max() > 0.1 and rel < gate, (rel, got, want)
    wide = np.abs(want[:, 1] - want[:, 0]) > 2 * gate * np.abs(want).max()
    assert wide.sum() >= len(got) // 2
    np.testing.assert_array_equal(got.argmax(-1)[wide], want.argmax(-1)[wide])


@pytest.mark.parametrize("size, config", CASES)
def test_f32_logits_match_jax(trees, size, config):
    _check(*_logits(config, size, trees[size, config], "f32"), 5e-3)


@pytest.mark.parametrize("config", ["official", "tpu"])
def test_bf16_logits_at_448_match_jax(trees, config):
    _check(*_logits(config, 448, trees[448, config], "bf16"), 1.5e-2)


@pytest.mark.parametrize("config", ["official", "tpu"])
def test_bf16_logits_at_560_match_jax(trees, config):
    """Stage 4's 324 tokens: past the 256 that K5's earlier long kernels took.
    At 560 px the JAX model's own bf16 logits lie 6.1e-2 (official) and
    3.6e-2 (tpu) of their scale from its f32 ones on these seeded trees,
    where the port's bf16 lie 4.1e-2 and 2.6e-2 from them and the f32 logits
    agree to 1e-5 (``test_f32_logits_match_jax``): the gate is 1.5e-2 plus
    the JAX bf16 run's own drift, ``chip_smoke.check_logits``'s rule past
    224 px."""
    tree = trees[560, config]
    got, want = _logits(config, 560, tree, "bf16")
    _, exact = _logits(config, 560, tree, "f32")
    drift = float(np.abs(want - exact).max() / np.abs(exact).max())
    _check(got, want, 1.5e-2 + drift)
    # and the port's bf16 is no farther from the exact logits than the JAX one's
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


@pytest.mark.parametrize("size, launches", [
    (64, {"k5": 0, "k5_long": 0, "k6": 0}),  # 16 and 4 tokens: plain ops
    (112, {"k5": 2, "k5_long": 0, "k6": 0}),  # stage 3's 49 tokens; stage 4's 16 plain
    (224, {"k5": 3, "k5_long": 0, "k6": 0}),
    (448, {"k5": 4, "k5_long": 1, "k6": 0}),  # carrier tokens 64 and windows 53; stage 4 196
    (560, {"k5": 4, "k5_long": 1, "k6": 0}),  # carrier tokens 100, windows 53; stage 4 324
])
def test_launches_per_forward(size, launches):
    model = FasterViT(2, num_heads=OFFICIAL_HEADS, img_size=size, **NARROW)
    assert model.kernel_launches_per_forward() == launches


@pytest.mark.parametrize("size", [112, 448, 560])
def test_every_kernel_attention_goes_through_the_k5_wrapper(monkeypatch, size):
    """A bf16 forward calls ``window_attention`` (whose CUDA path launches
    the short or the long kernel by N) once for each launch
    ``kernel_launches_per_forward`` counts, at every token count it calls
    with, and the plain version for nothing else."""
    from deepfakedetection_tpu_torch.models import fastervit

    tokens = []
    wrapper = fastervit.window_attention
    monkeypatch.setattr(fastervit, "window_attention",
                        lambda qkv, *a, **kw: tokens.append(qkv.shape[1]) or wrapper(qkv, *a, **kw))
    model = FasterViT(2, num_heads=OFFICIAL_HEADS, img_size=size, **NARROW).eval()
    with torch.no_grad():
        model(torch.randn(1, 3, size, size))
    launches = model.kernel_launches_per_forward()
    assert len(tokens) == launches["k5"] + launches["k5_long"]
    assert sum(n > 128 for n in tokens) == launches["k5_long"]


def test_the_degenerate_stage_takes_the_stage_4_names():
    model = FasterViT(2, num_heads=OFFICIAL_HEADS, img_size=112, dtype=torch.float32, **NARROW)
    names = model.state_dict().keys()
    stage3 = {k.split(".", 4)[4] for k in names if k.startswith("levels.2.blocks.")}
    stage4 = {k.split(".", 4)[4] for k in names if k.startswith("levels.3.blocks.")}
    assert stage3 == stage4 and "pos_embed.cpb_mlp.0.weight" in stage3
    assert not any("global_tokenizer" in k or "hat_" in k for k in names)
    tpu = FasterViT(2, num_heads=tpu_heads(16, OFFICIAL_HEADS), official=False, img_size=112,
                    dtype=torch.float32, **NARROW).state_dict()
    assert fastervit_head_config(tpu) == "tpu" and "levels.2.ct_pos_embed" not in tpu


def test_fused_attention_past_128_tokens_is_refused_when_built(monkeypatch):
    monkeypatch.setenv("DFD_FUSED_ATTN", "1")
    assert FasterViT(2, num_heads=OFFICIAL_HEADS, img_size=224,
                     **NARROW).kernel_launches_per_forward()["k6"] == 5
    with pytest.raises(ValueError, match=re.escape(K6_LONG_ITEM)):
        FasterViT(2, num_heads=OFFICIAL_HEADS, img_size=448, **NARROW)
    # float32 ignores the flag, as at 224
    FasterViT(2, num_heads=OFFICIAL_HEADS, img_size=448, dtype=torch.float32, **NARROW)
    job = TrainJob(model_name="faster_vit_2_224", spec=get_model_spec("faster_vit_2_224"),
                   run_paths=None, data_root=None, img_size=448)
    assert [K6_LONG_ITEM in r for r in unported_options(job)] == [True]
    job.img_size = 224
    assert unported_options(job) == []


def test_a_stage_3_the_window_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="must be divisible by window_size 7"):
        FasterViT(2, num_heads=OFFICIAL_HEADS, img_size=160, **NARROW)  # 10 x 10
