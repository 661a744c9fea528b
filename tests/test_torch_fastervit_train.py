"""The port's FasterViT train forward (deepfakedetection_tpu_torch/models/
fastervit.py in training) against the JAX package's ``train=True`` path, in
both head configurations.

The narrow FasterViT of ``tests/test_torch_fastervit.py`` (dim 16, in_dim 8,
depths (1, 1, 2, 1) at 224 px: stage 3 keeps 2x2 windows with carrier tokens)
gets a JAX init with numpy-seeded statistics, biases, layer scales and
tables (``_perturbed``), carried into the port by ``state_dict_from_jax``,
drop-path at 0 on both sides. A batch of 4 with its last row masked as
padding goes through both.

f32 (the algorithm), with JAX at "highest" matmul precision (the readings
measured on the CPU, official / tpu, in brackets):
- the loss to 1e-5 relative [5.9e-7 / 1.0e-6] and the logits to 1e-5 of
  their scale [2.7e-6 / 5.8e-6];
- every parameter's gradient: over all tensors but the stem's
  ||dg|| / ||g|| to 1e-4 [6.5e-6 / 5.2e-6], and per group (attention
  qkv/proj, the bias tensors, the conv stages, the head) max|dg| over the
  group's largest |g| to 1e-4 [at most 6.5e-6 / 8.9e-6] (a per-tensor ratio
  means nothing for the official conv biases, which a BatchNorm follows:
  their gradient is rounding noise around zero). The stem's to 5e-2 of its
  scale [2.7e-3 / 1.7e-2]: one pre-ReLU value of the second stem conv sits
  9.5e-7 from zero in the tpu run, so f32 summation order decides its ReLU,
  and the one flipped element moves the stem's gradients that far (the
  port's own run on the batch in another order moves them as far, while
  every later layer's gradient moves by under 1e-5);
- the running statistics after the forward, ConvBN's and ``norm``'s, to 1e-5
  [1.0e-6 / 9.5e-7];
- one ``train_step`` (the fine-tune phase, AdamW at 1e-4 over every tensor)
  against the JAX ``make_train_step_fn``: the loss to 1e-5 relative, each
  updated weight within 2.01 lr (a gradient whose sign differs moves a
  weight by 2 lr) and at most 1% of them beyond 0.1 lr [loss 6.7e-7 / 1.0e-6;
  2.9e-4 / 2.2e-4 of the weights beyond 0.1 lr].
bf16 (the working type, the port through K5's plain versions, JAX through
its CPU einsum path) held loosely, as ``tests/test_torch_train_step.py`` holds
B3: the JAX bf16 forward on the CPU is not one fixed rounding. The loss to
5e-2 relative [1.0e-3 / 3.9e-3], every weight within 2.01 lr and at most 25%
beyond 0.5 lr [0.80% / 0.84%].

Separately: the ``Downsample``
convs get a gradient, and the drop-path masks are per window in the window
sub-block and per image elsewhere, keep 1 - rate of the rows and scale them
by 1 / (1 - rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.models.fastervit import _tpu_heads
from deepfakedetection_tpu.train import optim as jax_optim
from deepfakedetection_tpu.train import steps as jax_steps
from deepfakedetection_tpu.train.objectives import smoothed_cross_entropy as jax_ce
from deepfakedetection_tpu_torch.models import common
from deepfakedetection_tpu_torch.models.fastervit import FasterViT
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict, state_dict_from_jax
from deepfakedetection_tpu_torch.train import optim
from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy
from deepfakedetection_tpu_torch.train.steps import train_step
from tests.test_torch_fastervit import _perturbed

NARROW = dict(dim=16, in_dim=8, depths=(1, 1, 2, 1))
SIZE, B = 224, 4
CONFIGS = ["official", "tpu"]
HEADS = {"official": (2, 4, 8, 16), "tpu": _tpu_heads(16, (2, 4, 8, 16))}
LR, WD = 1e-4, 5e-2
GROUPS = {
    "attention qkv/proj": lambda n: ".attn.qkv." in n or ".attn.proj." in n,
    "bias tensors": lambda n: "rel_bias" in n or "pos_emb_funct" in n,
    "conv stages": lambda n: n.startswith(("levels.0.", "levels.1.")),
    "head": lambda n: n.startswith("head."),
    "stem": lambda n: n.startswith("patch_embed."),
}
GROUP_TOL = {"stem": 5e-2}  # one ReLU kink (module docstring); the rest 1e-4


def _jax_model(config, dtype):
    return JaxFasterViT(num_classes=2, num_heads=HEADS[config], drop_path_rate=0.0,
                        pos_mode="cpb" if config == "official" else "table", dtype=dtype,
                        **NARROW)


def _port_model(config, tree, dtype):
    model = FasterViT(2, num_heads=HEADS[config], official=config == "official",
                      drop_path_rate=0.0, dtype=dtype, **NARROW)
    load_state_dict_strict(model, state_dict_from_jax(tree, "fastervit"))
    return model.train()


def _batch():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0], np.int32)
    mask = np.array([True, True, True, False])
    return x, labels, mask


def _to_port(t):
    return torch.from_numpy(np.asarray(t)).permute(0, 3, 1, 2)


def _jax_step(params, stats, config, dtype, batch):
    tx, _, _ = jax_optim.make_phase_optimizer(
        params, lr=LR, weight_decay=WD, trainable=jax_optim.unfreeze_predicate("all"))
    state = jax_steps.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                                 step=jnp.asarray(0, jnp.int32))
    step = jax_steps.make_train_step_fn(_jax_model(config, dtype), tx)
    with jax.default_matmul_precision("highest"):
        new, metrics = jax.jit(step)(state, *map(jnp.asarray, batch), jax.random.key(0))
    tree = {"params": jax.device_get(new.params), "batch_stats": jax.device_get(new.batch_stats)}
    return float(metrics["loss"]), {k: v.numpy() for k, v in
                                    state_dict_from_jax(tree, "fastervit").items()}


@pytest.fixture(scope="module", params=CONFIGS)
def case(request):
    """One JAX init per configuration, its f32 train-mode loss, gradients and
    running statistics, and its f32 and bf16 train steps."""
    config = request.param
    params, stats = jax_steps.init_model_variables(_jax_model(config, jnp.float32),
                                                   jax.random.key(0), (1, SIZE, SIZE, 3))
    rng = np.random.default_rng(1)
    tree = {"params": _perturbed(jax.device_get(params), rng),
            "batch_stats": _perturbed(jax.device_get(stats), rng)}
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"])
    batch = _batch()
    x, labels, mask = map(jnp.asarray, batch)
    model = _jax_model(config, jnp.float32)

    def loss_fn(p):
        logits, mutated = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                      mutable=["batch_stats"])
        return jax_ce(logits, labels, mask), (logits, mutated["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (loss, (logits, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jax.device_get(grads)}, "fastervit").items()}
    after = state_dict_from_jax({"params": tree["params"],
                                 "batch_stats": jax.device_get(new_stats)}, "fastervit")
    return {"config": config, "tree": tree, "batch": batch, "loss": float(loss),
            "logits": np.asarray(logits), "grads": grads,
            "stats": {k: v.numpy() for k, v in after.items() if "running" in k},
            "step": {name: _jax_step(params, stats, config, dt, batch)
                     for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}}


@pytest.fixture(scope="module")
def port_f32(case):
    """The port's f32 train forward and gradients on the same batch."""
    model = _port_model(case["config"], case["tree"], torch.float32)
    x, labels, mask = case["batch"]
    logits = model(_to_port(x))
    loss = smoothed_cross_entropy(logits, torch.from_numpy(labels).long(),
                                  torch.from_numpy(mask))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {"model": model, "logits": logits.detach().numpy(), "loss": float(loss.detach()),
            "grads": {n: g.numpy() for (n, _), g in zip(named, grads)}}


def test_f32_train_forward_and_gradients_match_jax(case, port_f32):
    want, got = case["grads"], port_f32["grads"]
    assert set(got) <= set(want) and len(got) > 50
    assert abs(port_f32["loss"] - case["loss"]) <= 1e-5 * abs(case["loss"])
    scale = np.abs(case["logits"]).max()
    assert np.abs(port_f32["logits"] - case["logits"]).max() <= 1e-5 * scale
    rest = [n for n in got if not GROUPS["stem"](n)]
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in rest)
    den = sum(float((want[n] ** 2).sum()) for n in rest)
    assert (num / den) ** 0.5 <= 1e-4, (num / den) ** 0.5
    for group, member in GROUPS.items():
        names = [n for n in got if member(n)]
        if case["config"] == "tpu" and group == "bias tensors":
            assert all(n.endswith("rel_bias") for n in names)
        assert names, group
        top = max(float(np.abs(want[n]).max()) for n in names)
        err = max(float(np.abs(got[n] - want[n]).max()) for n in names)
        assert top > 0 and err <= GROUP_TOL.get(group, 1e-4) * top, (group, err, top)


def test_downsample_convs_get_a_gradient(case, port_f32):
    for s in range(3):
        name = f"levels.{s}.downsample.reduction.0.weight"
        g = port_f32["grads"][name]
        assert float(np.abs(g).max()) > 0
        np.testing.assert_allclose(g, case["grads"][name], rtol=0,
                                   atol=1e-4 * float(np.abs(case["grads"][name]).max()))


def test_running_statistics_after_the_train_forward_match_jax(case, port_f32):
    got = {k: v.numpy() for k, v in port_f32["model"].state_dict().items() if "running" in k}
    assert got.keys() == case["stats"].keys() and "norm.running_var" in got
    for k, want in case["stats"].items():
        assert float(np.abs(got[k] - want).max()) <= 1e-5, k
    before = state_dict_from_jax(case["tree"], "fastervit")
    moved = got["norm.running_mean"] - before["norm.running_mean"].numpy()
    assert float(np.abs(moved).max()) > 1e-3  # the decay-0.9 update happened


def _port_step(case, dtype):
    model = _port_model(case["config"], case["tree"], dtype)
    opt = optim.PhaseOptimizer(list(model.named_parameters()), lr=LR, weight_decay=WD,
                               trainable=optim.unfreeze_predicate("all"))
    x, labels, mask = case["batch"]
    out = train_step(model, opt, _to_port(x), torch.from_numpy(labels).long(),
                     torch.from_numpy(mask), None)
    return float(out["loss"]), {k: v.float().numpy() for k, v in model.state_dict().items()}


def _param_units(jax_sd, port_sd):
    d = np.concatenate([np.abs(port_sd[k] - v).ravel() / LR for k, v in jax_sd.items()
                        if "running" not in k])
    return float(d.max()), float((d > 0.1).mean()), float((d > 0.5).mean())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_step_matches_jax(case, dtype):
    j_loss, j_sd = case["step"][dtype]
    p_loss, p_sd = _port_step(case, torch.float32 if dtype == "f32" else torch.bfloat16)
    worst, over_01, over_05 = _param_units(j_sd, p_sd)
    if dtype == "f32":
        assert abs(p_loss - j_loss) <= 1e-5 * abs(j_loss), (p_loss, j_loss)
        assert worst <= 2.01 and over_01 <= 1e-2, (worst, over_01)
    else:
        assert abs(p_loss - j_loss) <= 5e-2 * abs(j_loss), (p_loss, j_loss)
        assert worst <= 2.01 and over_05 <= 0.25, (worst, over_05)


def test_drop_path_masks_per_window_and_per_image():
    """Rate 0.5 in every block: each DropPath call's mask is one draw per
    row of its input (windows in the window sub-block, images elsewhere),
    rows kept whole and scaled by 1 / keep or zeroed."""
    model = FasterViT(2, num_heads=HEADS["tpu"], official=False, drop_path_rate=0.5, **NARROW,
                      dtype=torch.float32, generator=torch.Generator().manual_seed(0)).train()
    seen = []
    real = common.DropPath.forward

    def spy(self, x, generator=None):
        out = real(self, x, generator)
        seen.append((self.rate, x.detach(), out.detach()))
        return out

    x = torch.randn(B, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common.DropPath, "forward", spy)
        with torch.no_grad():
            model(x, torch.Generator().manual_seed(3))
    rows = [t.shape[0] for _, t, _ in seen]
    # 2 conv blocks, 2 HAT blocks (CT sub-block x2, window sub-block x2), 1 stage-4 block x2
    assert rows == [B, B] + [B, B, 4 * B, 4 * B] * 2 + [B, B]
    for rate, inp, out in seen:
        keep = 1.0 - rate
        for r in range(inp.shape[0]):
            kept = torch.allclose(out[r], inp[r] / keep)
            assert kept or bool((out[r] == 0).all())
    fractions = [rate for rate, _, _ in seen]
    assert fractions[0] == 0.0 and fractions[-1] == pytest.approx(0.5)
    big = torch.ones(20000, 3)
    out = common.DropPath(0.3).train()(big, torch.Generator().manual_seed(4))
    kept = (out[:, 0] != 0).float().mean()
    assert abs(float(kept) - 0.7) < 0.02 and torch.allclose(out[out != 0], big[0, 0] / 0.7)
