"""The port's EfficientFormerV2 train forward (deepfakedetection_tpu_torch/
models/efficientformer_v2.py in training) against the JAX package's
``train=True`` path: the narrow EFv2 of ``tests/test_torch_efficientformer_v2.py``
(dims (16, 24, 32, 48), depths (1, 1, 3, 2), 128 px) here, batch 4 with its
last row masked as padding; the full-width S1 at 224 px, batch 2, in
``tests/test_torch_efficientformer_v2_train_s1.py`` with the same checks.

Both packages get one numpy-seeded tree (``seeded_tree``: BN statistics,
layer scales, talking heads and bias tables drawn), carried into the port by
``state_dict_from_jax``. The JAX model attends through its XLA branch in
training (``use_pallas_attn4d(train)`` is False), the port through
``attn4d_plain`` at that branch's rounding; neither has drop path.

f32 (the algorithm), with JAX at "highest" matmul precision (the readings
measured on the CPU, narrow / S1, in brackets):
- the loss to 1e-5 relative [3.0e-7 / 1.8e-7];
- every parameter's gradient: over all tensors ||dg|| / ||g|| to 1e-4
  [4.0e-6 / 7.2e-6], and per group (the attention projections, the talking
  heads and bias tables, the conv stages, the heads and final norm) max|dg|
  over the group's largest |g| to 1e-4 [at most 4.8e-6 / 7.1e-6];
- the running statistics after the forward, every ConvNorm's and ``norm``'s,
  to 1e-5 [1.2e-6 / 1.5e-6];
- one ``train_step`` (AdamW at 1e-4 over every tensor) against the JAX
  ``make_train_step_fn``: the loss to 1e-5 relative, each updated weight
  within 2.01 lr (a gradient whose sign differs moves a weight by 2 lr), at
  most 1% beyond 0.1 lr [loss 3.0e-7 / 1.8e-7; the largest 0.70 / 1.18 lr,
  3.3e-4 / 1.7e-4 of the weights beyond 0.1 lr].
bf16 (the working type; JAX's bf16 forward on the CPU is not one fixed
rounding, so it is held loosely, as the B3 and FasterViT steps are): the loss
to 5e-2 relative [2.8e-3 / 5.9e-3], every weight within 2.01 lr and at most
25% beyond 0.5 lr [1.5% / 2.2%].

Also here: ``orchestrate(mode="training")`` runs the shipped recipe on S1 at
64 px end to end (the run dir, the recipe's warmup and fine-tune sets, resume,
the inference handoff); the train forward never reaches K7's wrapper (its counter stays
at 0 and a patched wrapper that raises is never called), and the train step
moves the talking heads and bias tables (all but talking_head1's bias, which
the softmax cancels).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import deepfakedetection_tpu_torch.orchestrator as port_orch

from deepfakedetection_tpu.models.efficientformer_v2 import EfficientFormerV2 as JaxEFv2
from deepfakedetection_tpu.train import optim as jax_optim
from deepfakedetection_tpu.train import steps as jax_steps
from deepfakedetection_tpu.train.objectives import smoothed_cross_entropy as jax_ce
from deepfakedetection_tpu_torch.models import efficientformer_v2 as efv2
from deepfakedetection_tpu_torch.models.efficientformer_v2 import (
    EfficientFormerV2,
    create_efficientformer_v2,
)
from deepfakedetection_tpu_torch.ops import attn4d as k7
from deepfakedetection_tpu_torch.registry import get_model_spec as port_model_spec
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict, state_dict_from_jax
from deepfakedetection_tpu_torch.train import optim
from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy
from deepfakedetection_tpu_torch.train.steps import train_step
from tests.test_torch_efficientformer_v2 import NARROW, S1, seeded_tree

LR, WD = 1e-4, 5e-2
FAMILY = "efficientformerv2"
GROUPS = {
    "attention": lambda n: (".token_mixer." in n or ".downsample.attn." in n)
    and "talking_head" not in n and "attention_biases" not in n,
    "talking heads and bias tables": lambda n: "talking_head" in n or "attention_biases" in n,
    "conv stages": lambda n: n.startswith(("stem.", "stages.0.", "stages.1.")),
    "heads": lambda n: n.startswith(("head.", "head_dist.", "norm.")),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs one file a
    worker on a few cores, and the port's many small CPU ops slow down by
    an order of magnitude when every worker's pool spans every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _batch(size, rows):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(rows, size, size, 3)).astype(np.float32)
    labels = (np.arange(rows) % 2).astype(np.int32)
    mask = np.arange(rows) < max(rows - 1, 2)  # the last row padding when there are 3 or more
    return x, labels, mask


def _to_port(t):
    return torch.from_numpy(np.asarray(t)).permute(0, 3, 1, 2)


def _port_model(cfg, size, tree, dtype):
    model = EfficientFormerV2(2, **cfg, img_size=size, dtype=dtype)
    load_state_dict_strict(model, state_dict_from_jax(tree, FAMILY))
    return model.train()


def _jax_step(cfg, params, stats, dtype, batch):
    tx, _, _ = jax_optim.make_phase_optimizer(
        params, lr=LR, weight_decay=WD, trainable=jax_optim.unfreeze_predicate("all"))
    state = jax_steps.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                                 step=jnp.asarray(0, jnp.int32))
    step = jax_steps.make_train_step_fn(JaxEFv2(num_classes=2, dtype=dtype, **cfg), tx)
    with jax.default_matmul_precision("highest"):
        new, metrics = jax.jit(step)(state, *map(jnp.asarray, batch), jax.random.key(0))
    tree = {"params": jax.device_get(new.params), "batch_stats": jax.device_get(new.batch_stats)}
    return float(metrics["loss"]), {k: v.numpy() for k, v in
                                    state_dict_from_jax(tree, FAMILY).items()}


def make_case(name):
    """The JAX side of one configuration: its f32 train-mode loss,
    gradients and running statistics, and its f32 and bf16 train steps, from
    one seeded tree."""
    cfg, size = {"narrow": (NARROW, 128), "s1": (S1, 224)}[name]
    tree = seeded_tree(cfg, size, np.random.default_rng(0))
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"])
    batch = _batch(size, 4 if name == "narrow" else 2)
    x, labels, mask = map(jnp.asarray, batch)
    model = JaxEFv2(num_classes=2, dtype=jnp.float32, **cfg)

    def loss_fn(p):
        logits, mutated = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                                      mutable=["batch_stats"])
        return jax_ce(logits, labels, mask), mutated["batch_stats"]

    with jax.default_matmul_precision("highest"):
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jax.device_get(grads)}, FAMILY).items()}
    after = state_dict_from_jax({"params": tree["params"],
                                 "batch_stats": jax.device_get(new_stats)}, FAMILY)
    return {"cfg": cfg, "size": size, "tree": tree, "batch": batch, "loss": float(loss),
            "grads": grads, "stats": {k: v.numpy() for k, v in after.items() if "running" in k},
            "step": {n: _jax_step(cfg, params, stats, dt, batch)
                     for n, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}}


def make_port(case):
    """The port's f32 train forward and gradients on the same batch, with
    K7's wrapper replaced by one that raises."""
    model = _port_model(case["cfg"], case["size"], case["tree"], torch.float32)
    x, labels, mask = case["batch"]

    def refuse(*args, **kw):
        raise AssertionError("the train forward reached K7's wrapper")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(efv2, "attn4d", refuse)
        before = k7.attn4d.launches
        logits = model(_to_port(x), None)
        assert k7.attn4d.launches == before
    loss = smoothed_cross_entropy(logits, torch.from_numpy(labels).long(),
                                  torch.from_numpy(mask))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {"model": model, "loss": float(loss.detach()),
            "grads": {n: g.numpy() for (n, _), g in zip(named, grads)}}


def check_gradients(case, port):
    want, got = case["grads"], port["grads"]
    assert set(got) == set(want) and len(got) > 100
    assert abs(port["loss"] - case["loss"]) <= 1e-5 * abs(case["loss"]), (port["loss"],
                                                                           case["loss"])
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in got)
    den = sum(float((want[n] ** 2).sum()) for n in got)
    assert (num / den) ** 0.5 <= 1e-4, (num / den) ** 0.5
    for group, member in GROUPS.items():
        names = [n for n in got if member(n)]
        assert names, group
        top = max(float(np.abs(want[n]).max()) for n in names)
        err = max(float(np.abs(got[n] - want[n]).max()) for n in names)
        assert top > 0 and err <= 1e-4 * top, (group, err, top)


def check_running_statistics(case, port):
    got = {k: v.numpy() for k, v in port["model"].state_dict().items() if "running" in k}
    assert got.keys() == case["stats"].keys() and "norm.running_var" in got
    for k, want in case["stats"].items():
        assert float(np.abs(got[k] - want).max()) <= 1e-5, k
    before = state_dict_from_jax(case["tree"], FAMILY)
    moved = got["norm.running_mean"] - before["norm.running_mean"].numpy()
    assert float(np.abs(moved).max()) > 1e-3  # the decay-0.9 update happened


def _port_step(case, dtype):
    model = _port_model(case["cfg"], case["size"], case["tree"], dtype)
    opt = optim.PhaseOptimizer(list(model.named_parameters()), lr=LR, weight_decay=WD,
                               trainable=optim.unfreeze_predicate("all"))
    x, labels, mask = case["batch"]
    out = train_step(model, opt, _to_port(x), torch.from_numpy(labels).long(),
                     torch.from_numpy(mask), None)
    return float(out["loss"]), {k: v.float().numpy() for k, v in model.state_dict().items()}


def check_train_step(case, dtype):
    j_loss, j_sd = case["step"][dtype]
    p_loss, p_sd = _port_step(case, torch.float32 if dtype == "f32" else torch.bfloat16)
    d = np.concatenate([np.abs(p_sd[k] - v).ravel() / LR for k, v in j_sd.items()
                        if "running" not in k])
    worst, over_01, over_05 = float(d.max()), float((d > 0.1).mean()), float((d > 0.5).mean())
    if dtype == "f32":
        assert abs(p_loss - j_loss) <= 1e-5 * abs(j_loss), (p_loss, j_loss)
        assert worst <= 2.01 and over_01 <= 1e-2, (worst, over_01)
    else:
        assert abs(p_loss - j_loss) <= 5e-2 * abs(j_loss), (p_loss, j_loss)
        assert worst <= 2.01 and over_05 <= 0.25, (worst, over_05)
    # the softmax cancels talking_head1's bias (a shift of every score of a
    # row): its gradient is zero, and only the weight decay moves it
    before = state_dict_from_jax(case["tree"], FAMILY)
    moved = [k for k in p_sd if ("talking_head" in k or "attention_biases" in k)
             and not k.endswith("talking_head1.bias")]
    assert moved
    for key in moved:
        assert float(np.abs(p_sd[key] - before[key].numpy()).max()) > 0.5 * LR, key


@pytest.fixture(scope="module")
def case():
    return make_case("narrow")


@pytest.fixture(scope="module")
def port_f32(case):
    return make_port(case)


def test_f32_train_forward_and_gradients_match_jax(case, port_f32):
    check_gradients(case, port_f32)


def test_running_statistics_after_the_train_forward_match_jax(case, port_f32):
    check_running_statistics(case, port_f32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_step_matches_jax(case, dtype):
    check_train_step(case, dtype)


EF = "efficientformerv2_s1"


def _loop_config(path, root, out_dir, **training):
    block = {"output_dir": str(out_dir),
             "training": {"epochs": 2, "batch_size": 8, "num_workers": 0, "resume": "continue",
                          **training},
             "inference": {"weights": "auto", "batch_size": 8, "num_workers": 0}}
    cfg = {"seed": 7, "device": "cpu", "data": {"root": str(root), "num_classes": 2,
                                                 "img_size": 64, "test_split": "test"},
           "models": {EF: block}, "selection": [EF]}
    path.write_text(yaml.safe_dump(cfg))
    return path


def _ckpt(out_dir):
    (run,) = sorted(p for p in out_dir.iterdir() if p.is_dir())
    return run, torch.load(run / "checkpoints" / "latest.ckpt", weights_only=True)


def test_run_training_trains_the_recipe_sets_resumes_and_hands_over(tiny_image_tree, tmp_path):
    """S1 at 64 px (attention grids of 2 x 2) through the shipped recipe on a
    tiny tree: 2 warmup steps over the 20 head tensors, 2 fine-tune steps an
    epoch over the 116 of the unfreeze set (no other parameter moves but a
    zero-initialised talking_head1 bias, whose gradient the softmax
    cancels), the run dir and checkpoints, a resume from ``latest.ckpt``
    bit-identical to the uninterrupted run, and ``weights: auto``
    inference on the export."""
    result = port_orch.orchestrate(_loop_config(tmp_path / "a.yaml", tiny_image_tree,
                                                tmp_path / "a"), mode="training")[EF]
    assert not result.interrupted and result.epochs_run == 2
    run, latest = _ckpt(tmp_path / "a")
    log = "".join((run / "logs" / "train.log").read_text().split())
    assert "head-only(20/357paramtensors)" in log and "trainable=116/357tensors" in log
    records = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in records)
    for name in ("latest.ckpt", "best.ckpt", f"{EF}.pth"):
        assert (run / "checkpoints" / name).is_file(), name

    init = create_efficientformer_v2("s1", generator=torch.Generator().manual_seed(7),
                                     img_size=64)
    trainable = {n for n, _ in init.named_parameters()
                 if optim.unfreeze_predicate(port_model_spec(EF).recipe.unfreeze)(n)}
    before = init.state_dict()
    moved = {n for n, _ in init.named_parameters()
             if not torch.equal(latest["model"][n], before[n])}
    assert len(trainable) == 116 and moved <= trainable
    assert all(n.endswith("talking_head1.bias") for n in trainable - moved), trainable - moved

    port_orch.orchestrate(_loop_config(tmp_path / "b1.yaml", tiny_image_tree, tmp_path / "b",
                                       epochs=1), mode="training")
    resumed = port_orch.orchestrate(_loop_config(tmp_path / "b2.yaml", tiny_image_tree,
                                                 tmp_path / "b"), mode="training")[EF]
    assert resumed.epochs_run == 1
    run_b, latest_b = _ckpt(tmp_path / "b")
    assert "resumed from" in (run_b / "logs" / "train.log").read_text()
    assert latest_b["counters"] == latest["counters"]
    for k, v in latest["model"].items():
        assert torch.equal(v, latest_b["model"][k]), k

    res = port_orch.orchestrate(_loop_config(tmp_path / "a.yaml", tiny_image_tree,
                                             tmp_path / "a"), mode="inference")[EF]
    assert res.probs.shape == (12, 2) and np.isfinite(res.probs).all()


def test_chip_smoke_trains_at_the_shipped_batch(tmp_path):
    """``chip_smoke.py`` phase 10 trains at ``config/train.yaml``'s batch and
    transforms for EfficientFormerV2-S1."""
    import importlib.util
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shipped = yaml.safe_load((repo / "config" / "train.yaml").read_text())["models"][EF]
    assert smoke.EF_TRAIN_BATCH == shipped["training"]["batch_size"] == 128
    cfg = yaml.safe_load(smoke.ef_train_config(tmp_path, tmp_path / "data", "cpu").read_text())
    block = cfg["models"][EF]
    assert block["transforms"] == shipped["transforms"]
    assert block["training"]["batch_size"] == 128 and cfg["data"]["img_size"] == 224
