"""The port's EfficientNet (deepfakedetection_tpu_torch/models/efficientnet.py)
against the JAX package's Flax model and the efficientnet_pytorch-named torch
reference (tests/torch_refs/efficientnet_torch.py).

(a) f32, narrow model at 32 px, weights carried from a JAX init through
    ``state_dict_from_jax``: logits and stage outputs under the
    cross-framework gate (max|d| / scale < 5e-3, equal argmax).
(b) bf16 on both sides, with the JAX package's K1/K2 dispatch forced on in
    interpret mode and the port going through its kernel wrappers (their plain
    versions on the CPU): logits within 1.5e-2 of the output scale, tightened
    from the 2e-2 planned, with equal argmax where the margin is larger.
    Measured max|d|/scale: 6.6e-3; in (a) and (c) it is below 1e-6.
(c) full-width B3: the port's state dict keys are the reference's, and its
    224 px f32 CPU logits match the reference under the gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.models import common as jax_common
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.ops.pallas import depthwise_se as jax_k1
from deepfakedetection_tpu.ops.pallas import expand_dw as jax_k2
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch.models import common, efficientnet
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet, create_efficientnet
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict, state_dict_from_jax

NARROW = dict(num_classes=2, width_coefficient=0.25, depth_coefficient=0.5, native_resolution=32)
SIZE = 32


def _gate(name, got, want, tol=5e-3):
    scale = max(float(np.abs(want).max()), 1e-3)
    delta = float(np.abs(got - want).max())
    assert delta / scale < tol, f"{name}: max|d|={delta:.3e} scale={scale:.3e}"
    return delta / scale


def jax_variables(model, seed=0):
    """JAX init with randomized BatchNorm statistics, BN affine and biases,
    so BN folding is exercised (numpy-seeded)."""
    params, batch_stats = init_model_variables(model, jax.random.key(seed), (1, SIZE, SIZE, 3))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = perturb(v)
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k in ("mean", "bias"):
                v = rng.normal(0.0, 0.1, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return {"params": perturb(params), "batch_stats": perturb(batch_stats)}


def port_from_jax(variables, dtype):
    model = EfficientNet(**NARROW, dtype=dtype).eval()
    load_state_dict_strict(model, state_dict_from_jax(variables, "efficientnet"))
    return model


def _images(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _stage_ends(model):
    """(flax name, flat torch index) of each stage's last block."""
    ends, idx = {}, 0
    for s, (_, _, repeats, _, _) in enumerate(efficientnet._BASE_BLOCKS):
        n = model.round_repeats(repeats)
        idx += n
        ends[f"stage{s}_block{n - 1}"] = idx - 1
    return ends


def test_narrow_f32_matches_jax_logits_and_stages():
    jmodel = JaxEfficientNet(**NARROW, dtype=jnp.float32)
    variables = jax_variables(jmodel)
    model = port_from_jax(variables, torch.float32)
    x = _images(4)
    ends = _stage_ends(model)
    with jax.default_matmul_precision("highest"):
        jlogits, inter = jmodel.apply(
            variables, jnp.asarray(x), train=False,
            capture_intermediates=lambda m, method: method == "__call__" and m.name in ends,
        )
    acts = {}
    hooks = [
        model._blocks[i].register_forward_hook(
            lambda _m, _i, out, name=name: acts.__setitem__(name, out.float().numpy())
        )
        for name, i in ends.items()
    ]
    with torch.no_grad():
        logits = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    for h in hooks:
        h.remove()
    for name in ends:
        want = np.asarray(inter["intermediates"][name]["__call__"][0])
        _gate(name, acts[name].transpose(0, 2, 3, 1), want)
    jlogits = np.asarray(jlogits)
    _gate("logits", logits, jlogits)
    assert (logits.argmax(-1) == jlogits.argmax(-1)).all()


def _counting(fn, calls, key):
    def wrapped(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)

    return wrapped


def test_narrow_bf16_kernel_dispatch_matches_jax_interpret_kernels(monkeypatch):
    jmodel = JaxEfficientNet(**NARROW, dtype=jnp.bfloat16)
    variables = jax_variables(jmodel, seed=1)
    model = port_from_jax(variables, torch.bfloat16)
    jax_calls = {"k1": 0, "k2": 0}
    monkeypatch.setattr(jax_common, "use_pallas_dwse", lambda: True)
    monkeypatch.setattr(jax_k2, "use_pallas_expdw", lambda *a: True)
    k1_orig, k2_orig = jax_k1.depthwise_silu_pool, jax_k2.expand_dw_silu_pool

    def interpret(orig, key):
        def call(*args, **kwargs):
            if "interpret" not in kwargs:  # a model dispatch, not the wrapper's own recursion
                jax_calls[key] += 1
            return orig(*args, **{**kwargs, "interpret": True})

        return call

    monkeypatch.setattr(jax_k1, "depthwise_silu_pool", interpret(k1_orig, "k1"))
    monkeypatch.setattr(jax_k2, "expand_dw_silu_pool", interpret(k2_orig, "k2"))
    port_calls = {"k1": 0, "k2": 0}
    monkeypatch.setattr(
        common, "depthwise_silu_pool", _counting(common.depthwise_silu_pool, port_calls, "k1")
    )
    monkeypatch.setattr(
        efficientnet, "expand_dw_silu_pool",
        _counting(efficientnet.expand_dw_silu_pool, port_calls, "k2"),
    )

    x = _images(4, seed=2)
    jlogits = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        logits = model(torch.from_numpy(x).permute(0, 3, 1, 2)).float().numpy()

    assert port_calls == jax_calls == {"k1": 1, "k2": 5}
    assert model.kernel_launches_per_forward() == {"k1": 1, "k2": 5, "k3": 0}
    _gate("bf16 logits", logits, jlogits, tol=1.5e-2)
    scale = float(np.abs(jlogits).max())
    decided = np.abs(jlogits[:, 1] - jlogits[:, 0]) > 3e-2 * scale
    assert (logits.argmax(-1) == jlogits.argmax(-1))[decided].all()


def test_dispatch_serves_b3_stride1_blocks_in_bf16_only():
    bf16 = create_efficientnet("b3", num_classes=2, dtype=torch.bfloat16).eval()
    f32 = create_efficientnet("b3", num_classes=2, dtype=torch.float32).eval()
    assert bf16.kernel_launches_per_forward() == {"k1": 2, "k2": 20, "k3": 0}
    assert f32.kernel_launches_per_forward() == {"k1": 0, "k2": 0, "k3": 0}
    # at 224 the two k5/stride-2 depthwise convs keep the frozen (2, 2) pads
    pads = [b.args.dw_pads for b in bf16._blocks if b.args.stride == 2 and b.args.kernel == 5]
    assert pads == [((2, 2), (2, 2))] * 2


def _seeded_reference_state(model, seed):
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = v
        elif k.endswith("running_var"):
            state[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k.endswith("running_mean") or k.endswith("bias"):
            state[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
        elif v.dim() == 1:  # BN gamma
            state[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        else:
            fan_in = v[0].numel()
            arr = rng.normal(0, np.sqrt(1.0 / fan_in), v.shape).astype(np.float32)
            state[k] = torch.from_numpy(arr)
    return state


def test_b3_loads_reference_state_dict_strictly_and_matches_its_logits():
    from torch_refs.efficientnet_torch import EfficientNetB3

    ref = EfficientNetB3(num_classes=2).eval()
    model = create_efficientnet("b3", num_classes=2, dtype=torch.float32).eval()
    assert list(model.state_dict()) == list(ref.state_dict())
    state = _seeded_reference_state(ref, seed=0)
    ref.load_state_dict(state, strict=True)
    model.load_state_dict(state, strict=True)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 224, 224)).astype(np.float32))
    with torch.no_grad():
        want = ref(x).numpy()
        got = model(x).numpy()
    _gate("B3 logits", got, want)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_training_mode_raises():
    """A training forward with nonzero dropout or drop-path rates draws its
    masks from the generator it is given; without one it raises rather than
    draw from the global RNG. With one it runs."""
    model = EfficientNet(**NARROW, dtype=torch.float32).train()
    x = torch.randn(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model(x)
    out = model(x, torch.Generator().manual_seed(1))
    assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
