"""The port's FasterViT with ``DFD_FUSED_ATTN`` set (every attention through
K6, ``ops/attn_block.py``) against the JAX package's Flax model with the same
flag, in both head configurations, on the CPU.

The JAX side runs its fused branch as the JAX package's own test runs it
(tests/test_attn_block.py): ``_on_tpu`` patched to true and
``DFD_ENABLE_PALLAS`` set, so ``use_pallas_for`` holds in every attention
(the tpu configuration's head_dim is 128), and ``window_attn_subblock``
patched to interpret mode. The narrow model and its weights are
``tests/test_torch_fastervit.py``'s (dim 16, depths (1, 1, 2, 1) at 224 px:
5 attentions a forward, the carrier tokens' included).

- bf16 eval logits within 1.5e-2 of their scale, the gate the unfused bf16
  path is held to (measured on the CPU, official / tpu: 6.1e-3 / 9.0e-3);
  K6's plain version serves all 5 attentions, K5's none.
- One bf16 train step's f32 gradients (drop-path 0, the port through
  ``AttnSubblock``, JAX through the kernel's custom_vjp), held per parameter
  group as max|dg| over the group's largest |g|: the attention Linears' and
  the bias tensors' to 0.1 [2.2e-2 / 9.3e-3 and 1.6e-2 / 2.4e-2], the head's
  to 5e-2 [8.9e-3 / 6.2e-3], the loss to 2e-2 relative [4.9e-3 / 3.0e-3].
  JAX's bf16 forward on the CPU is not one fixed rounding: the conv stages'
  gradients read 0.21 / 0.12 here and 0.23 / 0.12 with the flag off on both
  sides, so they are not held; tests/test_torch_attn_block.py holds the op
  itself to the JAX kernel.
- The flag changes no parameter name or shape, and ``orchestrate`` trains
  (warmup and fine-tune, K6's plain forward 5 times a step and its plain
  backward 5 times a fine-tune step) and evaluates with it on the tiny tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepfakedetection_tpu.ops.attention as jax_attention
import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.train.objectives import smoothed_cross_entropy as jax_ce
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch.models.fastervit import FasterViT, create_faster_vit
from deepfakedetection_tpu_torch.ops import attn_block as k6
from deepfakedetection_tpu_torch.ops import window_attn
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict, state_dict_from_jax
from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy
from tests.test_torch_fastervit import NARROW, SIZE, _fit_head, _heads, _perturbed, _rel
from tests.test_torch_train_loop_fastervit import FV, _fv_config, _fv_spec, _run_dir

CONFIGS = ["official", "tpu"]
LOGIT_GATE = 1.5e-2
LOSS_TOL = 2e-2
GROUPS = {  # (member, tolerance)
    "attention qkv/proj": (lambda n: ".attn.qkv." in n or ".attn.proj." in n, 0.1),
    "bias tensors": (lambda n: "rel_bias" in n or "pos_emb_funct" in n, 0.1),
    "head": (lambda n: n.startswith("head."), 5e-2),
}


@pytest.fixture
def fused(monkeypatch):
    """DFD_FUSED_ATTN on for both packages; the JAX kernel in interpret mode."""
    monkeypatch.setenv("DFD_FUSED_ATTN", "1")
    monkeypatch.setenv("DFD_ENABLE_PALLAS", "1")
    monkeypatch.setattr(jax_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(jax_attention, "window_attn_subblock",
                        functools.partial(jax_attention.window_attn_subblock, interpret=True))


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


def _jax_model(config, **kw):
    return JaxFasterViT(num_classes=2, num_heads=_heads(config), dtype=jnp.bfloat16,
                        pos_mode="cpb" if config == "official" else "table", **NARROW, **kw)


def _port_model(config, tree, **kw):
    model = FasterViT(2, num_heads=_heads(config), official=config == "official", **NARROW, **kw)
    load_state_dict_strict(model, state_dict_from_jax(tree, "fastervit"))
    return model


def _counting(monkeypatch, name):
    """Counts the calls of ``k6.<name>`` (the plain versions the CPU runs)."""
    calls = []
    real = getattr(k6, name)
    monkeypatch.setattr(k6, name, lambda *a, **kw: calls.append(a[0].shape[1]) or real(*a, **kw))
    return calls


def test_bf16_logits_match_the_jax_fused_path(fused, narrow, monkeypatch):
    config, tree, x = narrow
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_jax_model(config).apply(tree, jnp.asarray(x), train=False),
                          np.float32)
    model = _port_model(config, tree).eval()
    assert model.kernel_launches_per_forward() == {"k5": 0, "k6": 5}
    calls = _counting(monkeypatch, "attn_subblock_plain")
    before = (k6.attn_subblock.launches, window_attn.window_attention.launches)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).float().numpy()
    assert sorted(calls) == [16, 16, 49, 53, 53]  # every attention, none through K5
    assert (k6.attn_subblock.launches, window_attn.window_attention.launches) == before
    assert _rel(got, want) < LOGIT_GATE, (config, got, want)


def test_bf16_train_step_gradients_match_jax(fused, narrow):
    config, tree, _ = narrow
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    labels, mask = np.array([0, 1, 1, 0], np.int32), np.ones(4, bool)
    jmodel = _jax_model(config, drop_path_rate=0.0)
    stats = tree["batch_stats"]

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(labels), jnp.asarray(mask))

    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax({"params": jax.device_get(grads),
                                "batch_stats": jax.device_get(stats)}, "fastervit")

    model = _port_model(config, tree, drop_path_rate=0.0).train()
    named = list(model.named_parameters())
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    got_loss = smoothed_cross_entropy(out, torch.from_numpy(labels).long(),
                                      torch.from_numpy(mask))
    got = dict(zip((n for n, _ in named),
                   torch.autograd.grad(got_loss, [p for _, p in named])))
    assert abs(float(got_loss.detach()) - float(loss)) <= LOSS_TOL * abs(float(loss))
    for group, (member, tol) in GROUPS.items():
        names = [n for n in got if member(n)]
        assert names, group
        assert all(got[n].dtype == torch.float32 for n in names)
        top = max(float(want[n].abs().max()) for n in names)
        err = max(float((got[n] - want[n]).abs().max()) for n in names) / top
        assert err <= tol, (config, group, err)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_flag_changes_no_parameter(config, monkeypatch):
    def shapes():
        return {k: tuple(v.shape) for k, v in create_faster_vit("2", head_config=config)
                .state_dict().items()}

    monkeypatch.delenv("DFD_FUSED_ATTN", raising=False)
    plain = shapes()
    monkeypatch.setenv("DFD_FUSED_ATTN", "1")
    model = create_faster_vit("2", head_config=config)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == plain
    assert model.kernel_launches_per_forward() == {"k5": 0, "k6": 21}
    assert model.kernel_launches_per_step() == {"k5": 0, "k5_bwd": 0, "k6": 21, "k6_bwd": 21}
    assert model.kernel_launches_per_step(head_only=True) == {"k5": 0, "k5_bwd": 0, "k6": 21,
                                                              "k6_bwd": 0}
    # a float32 model attends through plain ops with or without the flag
    f32 = create_faster_vit("2", head_config=config, dtype=torch.float32)
    assert f32.kernel_launches_per_forward() == {"k5": 0, "k6": 0}


def test_orchestrate_trains_and_evaluates_with_the_flag(fused, tiny_image_tree, tmp_path,
                                                        monkeypatch):
    built = []
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: _fv_spec(built))
    fwd = _counting(monkeypatch, "attn_subblock_plain")
    bwd = _counting(monkeypatch, "attn_subblock_bwd_plain")
    result = port_orch.orchestrate(_fv_config(tmp_path / "t.yaml", tiny_image_tree,
                                              tmp_path / "fv"), mode="training")[FV]
    assert not result.interrupted and result.epochs_run == 1 and built == ["tpu"]
    assert np.isfinite(result.final_train_loss)
    # 16 train images at batch 8: two warmup steps and two fine-tune steps;
    # 12 val images: two batches after each phase; 5 attentions a forward
    assert (len(fwd), len(bwd)) == (5 * (2 + 2 + 2 * 2), 5 * 2)
    run = _run_dir(tmp_path / "fv")
    assert (run / "checkpoints" / f"{FV}.pth").exists()
    fwd.clear()
    cfg = _fv_config(tmp_path / "i.yaml", tiny_image_tree, tmp_path / "fv",
                     mode_block={"inference": {"weights": "auto", "batch_size": 8,
                                               "num_workers": 0, "img_size": 224}})
    res = port_orch.orchestrate(cfg, mode="inference")[FV]
    assert res.probs.shape == (12, 2) and np.isfinite(res.probs).all()
    assert len(fwd) == 5 * (2 + 2)  # the val sweep and the test pass, two batches each
