"""One training step of the port against the JAX package's, from the same
weights on the same batch.

A narrow EfficientNet-B3 (width 0.25, depth 0.5, 32 px) with dropout and
drop-path at 0 gets a JAX init, carried to the port through
``state_dict_from_jax``. A batch of 8 with its last two rows masked as padding
goes through the JAX ``make_train_step_fn`` (optax AdamW in
``multi_transform``) and the port's ``train_step`` with ``PhaseOptimizer``, in
the warmup phase (head only, lr 3e-4) and the fine-tune phase (every tensor,
the per-epoch cosine schedule), plus class weights, mixup and CutMix at the
JAX step's own draws, and global-norm clipping.

Bounds, f32 (the algorithm):
- the loss to 1e-5 relative (measured <= 1.8e-6);
- the logits to 1e-5 of their scale and the gradients to 1e-4 as
  ||dg|| / ||g|| over all tensors (measured 2.6e-6 and 1.8e-5; per tensor
  the bias of a BN that another BN follows has a gradient of pure rounding
  noise, so a per-tensor ratio means nothing there);
- the running statistics to 1e-5 absolute (measured 2.4e-7);
- the updated parameters in units of lr. Adam's first step moves each
  weight by about lr whatever the gradient's size, so a gradient near zero
  whose sign differs between the frameworks moves its weight by 2 lr: no
  element may differ by more than 2.01 lr, and at most 1% of them by more
  than 0.1 lr (measured 0.13% in the fine-tune step, none in the warmup).

bf16 (the working type): the JAX package's bf16 forward on the CPU is not one
fixed rounding: XLA keeps excess precision where its fusions allow, and the
same forward gives a loss 2.4% apart in the warmup and the fine-tune step's
compilations. The random narrow net in train mode also amplifies rounding:
the port's own bf16 logits sit 8.0e-2 of their scale from its f32 logits.
So bf16 holds the loss to 5e-2 relative (measured 3.6e-3 and 2.8e-2), the
logits to 0.2 of their scale (measured 0.10), every parameter within 2.01 lr
and at most 25% of them beyond 0.5 lr (measured 11%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.runtime.torch_convert import export_torch_state_dict
from deepfakedetection_tpu.train import mixup as jax_mixup
from deepfakedetection_tpu.train import optim as jax_optim
from deepfakedetection_tpu.train import steps as jax_steps
from deepfakedetection_tpu.train.objectives import smoothed_cross_entropy as jax_ce
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict, state_dict_from_jax
from deepfakedetection_tpu_torch.train import optim
from deepfakedetection_tpu_torch.train.mixup import MixDraw, apply_mix
from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy
from deepfakedetection_tpu_torch.train.steps import EMA, recalibrate_bn, train_step

NARROW = dict(width_coefficient=0.25, depth_coefficient=0.5, native_resolution=32,
              dropout_rate=0.0, drop_connect_rate=0.0)
B, S = 8, 32
HEAD = ("classifier", "_fc", "fc")  # the B3 recipe's head substrings
KEY = jax.random.key(5)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
PHASES = {
    # lr for the bound, JAX lr, port lr, JAX predicate, port predicate
    "warmup": (3e-4, 3e-4, 3e-4, jax_optim.head_predicate(HEAD), optim.head_predicate(HEAD)),
    "finetune": (1e-4, jax_optim.epoch_cosine_schedule(1e-4, 5, 3),
                 optim.epoch_cosine_schedule(1e-4, 5, 3), jax_optim.unfreeze_predicate("all"),
                 optim.unfreeze_predicate("all")),
}
WD = 5e-2


@pytest.fixture(scope="module")
def init():
    model = JaxEfficientNet(num_classes=2, dtype=jnp.float32, **NARROW)
    params, stats = jax_steps.init_model_variables(model, jax.random.key(0), (1, S, S, 3))
    return params, stats, {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    labels = rng.integers(0, 2, B).astype(np.int32)
    mask = np.ones(B, bool)
    mask[-2:] = False  # padding rows
    return x, labels, mask


def _port_model(tree, dtype):
    model = EfficientNet(num_classes=2, dtype=dtype, **NARROW)
    load_state_dict_strict(model, state_dict_from_jax(tree, "efficientnet"))
    return model.train()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _jax_step(init, dtype, phase, batch, *, class_weights=None, mixup=None, clip=None):
    params, stats, _ = init
    _, lr, _, pred, _ = PHASES[phase]
    tx, _, _ = jax_optim.make_phase_optimizer(params, lr=lr, weight_decay=WD, trainable=pred,
                                              grad_clip_norm=clip)
    state = jax_steps.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                                 step=jnp.asarray(0, jnp.int32))
    step = jax_steps.make_train_step_fn(
        JaxEfficientNet(num_classes=2, dtype=DTYPES[dtype][0], **NARROW), tx,
        mixup=mixup, class_weights=class_weights,
    )
    with jax.default_matmul_precision("highest"):
        new, metrics = jax.jit(step)(state, *map(jnp.asarray, batch), KEY)
    tree = {"params": jax.device_get(new.params), "batch_stats": jax.device_get(new.batch_stats)}
    return float(metrics["loss"]), export_torch_state_dict(tree, "efficientnet")


def _port_step(init, dtype, phase, batch, *, class_weights=None, mix=None, clip=None):
    model = _port_model(init[2], DTYPES[dtype][1])
    _, _, lr, _, pred = PHASES[phase]
    opt = optim.PhaseOptimizer(list(model.named_parameters()), lr=lr, weight_decay=WD,
                               trainable=pred, grad_clip_norm=clip)
    x, labels, mask = batch
    cw = None if class_weights is None else torch.tensor(class_weights)
    out = train_step(model, opt, _nchw(x), torch.from_numpy(labels).long(),
                     torch.from_numpy(mask), None, class_weights=cw, mix=mix)
    return float(out["loss"]), {k: v.float().numpy() for k, v in model.state_dict().items()}


def _param_units(jax_sd, port_sd, lr):
    """|d| / lr over every parameter element: (max, share > 0.1 lr, share > 0.5 lr)."""
    d = np.concatenate([np.abs(port_sd[k] - v).ravel() / lr for k, v in jax_sd.items()
                        if "running" not in k])
    return float(d.max()), float((d > 0.1).mean()), float((d > 0.5).mean())


def _stats_gap(jax_sd, port_sd):
    return max(float(np.abs(port_sd[k] - v).max()) for k, v in jax_sd.items() if "running" in k)


@pytest.mark.parametrize("phase", ["warmup", "finetune"])
def test_f32_step_matches_jax(init, phase):
    batch = _batch()
    j_loss, j_sd = _jax_step(init, "f32", phase, batch)
    p_loss, p_sd = _port_step(init, "f32", phase, batch)
    assert abs(p_loss - j_loss) <= 1e-5 * abs(j_loss)
    assert _stats_gap(j_sd, p_sd) <= 1e-5
    worst, share, _ = _param_units(j_sd, p_sd, PHASES[phase][0])
    assert worst <= 2.01 and share <= 1e-2, (worst, share)
    if phase == "warmup":  # frozen tensors stay as they were
        before = {k: v.numpy() for k, v in state_dict_from_jax(init[2], "efficientnet").items()}
        frozen = [k for k in j_sd if "running" not in k and not k.startswith("_fc.")]
        assert frozen and all(np.array_equal(p_sd[k], before[k]) for k in frozen)


@pytest.mark.parametrize("phase", ["warmup", "finetune"])
def test_bf16_step_matches_jax(init, phase):
    batch = _batch()
    j_loss, j_sd = _jax_step(init, "bf16", phase, batch)
    p_loss, p_sd = _port_step(init, "bf16", phase, batch)
    assert abs(p_loss - j_loss) <= 5e-2 * abs(j_loss)
    worst, _, share = _param_units(j_sd, p_sd, PHASES[phase][0])
    assert worst <= 2.01 and share <= 0.25, (worst, share)


def test_forward_and_gradients_match_jax(init):
    params, stats, tree = init
    x, labels, mask = _batch()
    out = {}
    for name, (jdt, tdt) in DTYPES.items():
        jmodel = JaxEfficientNet(num_classes=2, dtype=jdt, **NARROW)

        def loss_fn(p, jmodel=jmodel):
            logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                     train=True, mutable=["batch_stats"])
            return jax_ce(logits, jnp.asarray(labels), jnp.asarray(mask)), logits

        with jax.default_matmul_precision("highest"):
            (_, j_logits), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        j_g = {k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(
            {"params": jax.device_get(j_grads), "batch_stats": stats}, "efficientnet").items()}
        model = _port_model(tree, tdt)
        logits = model(_nchw(x))
        loss = smoothed_cross_entropy(logits, torch.from_numpy(labels).long(),
                                      torch.from_numpy(mask))
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
        j_logits = np.asarray(j_logits, np.float32)
        rel_logits = float(np.abs(logits.detach().numpy() - j_logits).max()
                           / np.abs(j_logits).max())
        num = sum(float(((g - j_g[n]) ** 2).sum()) for (n, _), g in zip(named, grads))
        den = sum(float((j_g[n] ** 2).sum()) for n, _ in named)
        out[name] = (rel_logits, (num / den) ** 0.5)
    assert out["f32"][0] <= 1e-5 and out["f32"][1] <= 1e-4, out
    assert out["bf16"][0] <= 0.2, out


def test_padded_rows_do_not_count(init):
    """Rows the mask drops change neither the loss nor the update through
    their labels (their images still enter the BN statistics, as in JAX)."""
    x, labels, mask = _batch()
    flipped = labels.copy()
    flipped[~mask] = 1 - flipped[~mask]
    a_loss, a_sd = _port_step(init, "f32", "finetune", (x, labels, mask))
    b_loss, b_sd = _port_step(init, "f32", "finetune", (x, flipped, mask))
    assert a_loss == b_loss
    assert all(np.array_equal(a_sd[k], b_sd[k]) for k in a_sd)


def test_class_weighted_step_matches_jax(init):
    batch, cw = _batch(2), (0.25, 1.75)
    j_loss, j_sd = _jax_step(init, "f32", "finetune", batch, class_weights=cw)
    p_loss, p_sd = _port_step(init, "f32", "finetune", batch, class_weights=cw)
    unweighted, _ = _port_step(init, "f32", "finetune", batch)
    assert abs(p_loss - j_loss) <= 1e-5 * abs(j_loss) and abs(p_loss - unweighted) > 1e-3
    worst, share, _ = _param_units(j_sd, p_sd, 1e-4)
    assert worst <= 2.01 and share <= 1e-2, (worst, share)


def _jax_mix_draw(spec):
    """The draws ``mix_batch`` makes inside the JAX step at step 0."""
    k_mix = jax.random.fold_in(jax.random.fold_in(KEY, 0), 0x303)
    k_mode, k_lam, k_box = jax.random.split(k_mix, 3)
    cutmix = spec.cutmix_alpha > 0.0
    lam = float(jax.random.beta(k_lam, *(2 * (spec.cutmix_alpha if cutmix else spec.mixup_alpha,)),
                                dtype=jnp.float32))
    ky, kx = jax.random.split(k_box)
    center = (int(jax.random.randint(ky, (), 0, S)), int(jax.random.randint(kx, (), 0, S)))
    return MixDraw(cutmix=cutmix, lam=lam, center=center)


@pytest.mark.parametrize("spec", [jax_mixup.MixupSpec(mixup_alpha=0.4),
                                  jax_mixup.MixupSpec(cutmix_alpha=1.0)], ids=["mixup", "cutmix"])
def test_mixed_step_matches_jax_at_its_lambda(init, spec):
    batch = _batch(3)
    draw = _jax_mix_draw(spec)
    j_loss, j_sd = _jax_step(init, "f32", "finetune", batch, mixup=spec)
    p_loss, p_sd = _port_step(init, "f32", "finetune", batch, mix=draw)
    assert abs(p_loss - j_loss) <= 1e-5 * abs(j_loss)
    worst, share, _ = _param_units(j_sd, p_sd, 1e-4)
    assert worst <= 2.01 and share <= 1e-2, (worst, share)
    images = jnp.asarray(batch[0])
    j_mixed, j_lam = jax_mixup.mix_batch(
        jax.random.fold_in(jax.random.fold_in(KEY, 0), 0x303), images, spec)
    p_mixed, p_lam = apply_mix(_nchw(batch[0]), draw)
    assert p_lam == pytest.approx(float(j_lam), abs=1e-7)
    np.testing.assert_array_equal(p_mixed.permute(0, 2, 3, 1).numpy(), np.asarray(j_mixed))


def test_clipped_step_matches_jax(init):
    batch = _batch(4)
    j_loss, j_sd = _jax_step(init, "f32", "finetune", batch, clip=1e-3)
    p_loss, p_sd = _port_step(init, "f32", "finetune", batch, clip=1e-3)
    assert abs(p_loss - j_loss) <= 1e-5 * abs(j_loss)
    worst, share, _ = _param_units(j_sd, p_sd, 1e-4)
    assert worst <= 2.01 and share <= 1e-2, (worst, share)


def test_recalibrate_bn_matches_jax(init):
    params, stats, tree = init
    batches = [_batch(10 + i)[0] for i in range(3)]
    jmodel = JaxEfficientNet(num_classes=2, dtype=jnp.float32, **NARROW)
    with jax.default_matmul_precision("highest"):
        j_stats = jax_steps.recalibrate_bn(jmodel, params, stats, map(jnp.asarray, batches),
                                           jax.random.key(1))
    j_sd = export_torch_state_dict({"params": tree["params"], "batch_stats": j_stats},
                                   "efficientnet")
    model = _port_model(tree, torch.float32)
    assert recalibrate_bn(model, map(_nchw, batches), lambda i: None) == 3
    p_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert _stats_gap(j_sd, p_sd) <= 1e-5
    # the pooled variance carries the between-batch term: not the mean of the batches' vars
    assert max(float(np.abs(p_sd[k] - 1.0).max()) for k in p_sd if "running_var" in k) > 1e-2


def test_ema_update_matches_jax(init):
    _, _, tree = init
    rng = np.random.default_rng(6)
    sd = {k: v for k, v in state_dict_from_jax(tree, "efficientnet").items()
          if "running" not in k}
    names = sorted(sd)
    shadow0 = [sd[n].clone() for n in names]
    ema = EMA(shadow0, 0.999)
    j_ema = {n: jnp.asarray(sd[n].numpy()) for n in names}
    update = jax_steps.make_ema_update(0.999)
    for step in range(1, 4):
        live = [sd[n] + torch.from_numpy(rng.normal(size=sd[n].shape).astype(np.float32))
                for n in names]
        ema.update(live, step)
        j_ema = update(j_ema, {n: jnp.asarray(t.numpy()) for n, t in zip(names, live)},
                       jnp.asarray(step, jnp.int32))
    for n, t in zip(names, ema.shadow):
        np.testing.assert_allclose(t.numpy(), np.asarray(j_ema[n]), rtol=1e-6, atol=1e-6)
    assert not torch.equal(ema.shadow[0], shadow0[0])


def test_freeze_predicates_select_the_jax_tensors(init):
    """The recipe's predicates on the port's names pick exactly the tensors
    the JAX predicates pick on the JAX paths, through the converter's name map."""
    params, stats, tree = init
    port_names = [n for n, _ in _port_model(tree, torch.float32).named_parameters()]
    for jax_pred, port_pred in ((jax_optim.head_predicate(HEAD), optim.head_predicate(HEAD)),
                                (jax_optim.unfreeze_predicate("all"), optim.unfreeze_predicate("all"))):
        paths = jax_optim.param_path_strings(params)
        leaves, treedef = jax.tree_util.tree_flatten(params)
        marked = jax.tree_util.tree_unflatten(treedef, [
            np.full(np.shape(v), float(jax_pred(p)), np.float32) for p, v in zip(paths, leaves)
        ])
        as_torch = export_torch_state_dict({"params": marked, "batch_stats": stats}, "efficientnet")
        want = {n for n in port_names if as_torch[n].min() == 1.0}
        got = {n for n in port_names if port_pred(n)}
        assert got == want and got


def test_optimizer_takes_gradients_in_another_layout():
    """A conv weight's gradient can come back channels_last while the weight
    is contiguous; the fused AdamW walks both in memory order, so the step
    must match the one on the same gradient made contiguous."""
    g = torch.Generator().manual_seed(7)
    w = torch.randn(8, 4, 3, 3, generator=g)
    grad = torch.randn(8, 4, 3, 3, generator=g)
    out = []
    for layout in (torch.channels_last, torch.contiguous_format):
        p = torch.nn.Parameter(w.clone())
        opt = optim.PhaseOptimizer([("conv.weight", p)], lr=1e-2, weight_decay=WD,
                                   trainable=optim.unfreeze_predicate("all"))
        opt.step([grad.contiguous(memory_format=layout)])
        out.append(p.detach())
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    assert (out[0] - w).abs().max() > 5e-3


def test_cosine_schedule_matches_jax():
    j = jax_optim.epoch_cosine_schedule(1e-4, 5, 3)
    p = optim.epoch_cosine_schedule(1e-4, 5, 3)
    for step in range(0, 20):
        assert p(step) == pytest.approx(float(j(jnp.asarray(step))), rel=1e-6)
