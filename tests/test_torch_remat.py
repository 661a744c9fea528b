"""``training.remat`` and FasterViT's conv-stage remat (``models/common.remat``)
on the CPU.

- A remat step is a plain step, exactly: a narrow EfficientNet and a narrow
  FasterViT in f32 with dropout and drop-path on (and a narrow
  EfficientFormerV2, which has neither), two ``train_step`` calls
  from one generator with and without ``remat``: the losses, the gradients,
  the parameters after the optimizer step, the BatchNorm running statistics
  and ``num_batches_tracked`` and the generator's state all ``torch.equal``.
  The same for FasterViT's ``conv_remat`` "full" and "save-conv" (and with
  both remats at once); "full" recomputes the conv stages' convolutions in
  the backward, "save-conv" none of them.
- The attention Functions under remat: in a bf16 FasterViT (K5's, or K6's
  with ``DFD_FUSED_ATTN``) every attention's forward runs twice a step, the
  backward once, and the backward receives the recompute's inputs, not the
  first forward's; the step still equals the plain one.
- Each guard is needed: a plain ``torch.utils.checkpoint`` around the
  forward without the generator replay gets other gradients (the recompute
  draws new drop-path masks), and one without the BatchNorm guard moves the
  running statistics twice.
- Against JAX: the port's remat step against the JAX ``make_train_step_fn(
  remat=True)`` on the same narrow B3 weights (dropout and drop-path at 0),
  under ``tests/test_torch_train_step.py``'s f32 gates: the loss to 1e-5
  relative, the running statistics to 1e-5, every weight within 2.01 lr and
  at most 1% of them beyond 0.1 lr.
- ``conv_stage_dims``: a narrow official FasterViT with its conv stages at
  (24, 40) against the JAX model built with the same dims, f32 eval logits
  within 5e-3 of their scale (the cross-framework gate), equal argmax.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.runtime.torch_convert import export_torch_state_dict
from deepfakedetection_tpu.train import optim as jax_optim
from deepfakedetection_tpu.train import steps as jax_steps
from deepfakedetection_tpu_torch.models import common
from deepfakedetection_tpu_torch.models.efficientformer_v2 import EfficientFormerV2
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
from deepfakedetection_tpu_torch.models.fastervit import FasterViT
from deepfakedetection_tpu_torch.ops import attn_block, window_attn
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict, state_dict_from_jax
from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy
from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
from deepfakedetection_tpu_torch.train.steps import train_step
from tests.test_torch_efficientformer_v2 import NARROW as EF_NARROW
from tests.test_torch_fastervit import _perturbed

B3_NARROW = dict(width_coefficient=0.25, depth_coefficient=0.5, native_resolution=32)
FV_NARROW = dict(dim=16, in_dim=8, depths=(1, 1, 2, 1), num_heads=(2, 4, 8, 16))
DROP = 0.3
LR, WD = 1e-3, 5e-2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (as tests/test_torch_cam.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _b3(**kw):
    return EfficientNet(num_classes=2, dtype=torch.float32, dropout_rate=DROP,
                        drop_connect_rate=DROP, generator=torch.Generator().manual_seed(0),
                        **B3_NARROW, **kw)


def _fastervit(**kw):
    return FasterViT(2, official=True, drop_path_rate=DROP, dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0), **FV_NARROW, **kw)


def _efficientformer():
    return EfficientFormerV2(2, **EF_NARROW, img_size=128, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(0))


MODELS = {"efficientnet": (_b3, 32, 8), "fastervit": (_fastervit, 224, 4),
          "efficientformerv2": (_efficientformer, 128, 4)}


class _Recording(PhaseOptimizer):
    """A PhaseOptimizer that keeps a copy of every step's gradients."""

    def step(self, grads):
        self.grads.append([g.clone() for g in grads])
        super().step(grads)


def _batch(size, n):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(n, 3, size, size, generator=g), torch.arange(n) % 2,
            torch.ones(n, dtype=torch.bool))


def _two_steps(model, size, n, remat):
    """Losses, gradients, state dict and generator state after two steps."""
    opt = _Recording(list(model.named_parameters()), lr=LR, weight_decay=WD,
                     trainable=unfreeze_predicate("all"))
    opt.grads = []
    g = torch.Generator().manual_seed(3)
    x, labels, mask = _batch(size, n)
    losses = [train_step(model, opt, x, labels, mask, g, remat=remat)["loss"]
              for _ in range(2)]
    return losses, opt.grads, model.state_dict(), g.get_state()


def _assert_equal_runs(a, b):
    (la, ga, sa, gen_a), (lb, gb, sb, gen_b) = a, b
    assert all(torch.equal(x, y) for x, y in zip(la, lb)), (la, lb)
    assert len(ga) == len(gb) == 2
    for step_a, step_b in zip(ga, gb):
        assert all(torch.equal(x, y) for x, y in zip(step_a, step_b))
    assert sa.keys() == sb.keys()
    for k in sa:  # parameters, running statistics and num_batches_tracked
        assert torch.equal(sa[k], sb[k]), k
    assert any(k.endswith("num_batches_tracked") and int(v) == 2 for k, v in sa.items())
    assert torch.equal(gen_a, gen_b)


@pytest.mark.parametrize("family", list(MODELS))
def test_remat_step_equals_the_plain_step(family):
    build, size, n = MODELS[family]
    _assert_equal_runs(_two_steps(build(), size, n, False), _two_steps(build(), size, n, True))


@pytest.mark.parametrize("conv_remat,remat", [("full", False), ("save-conv", False),
                                              ("save-conv", True)])
def test_conv_remat_equals_the_plain_step(conv_remat, remat):
    _, size, n = MODELS["fastervit"]
    _assert_equal_runs(_two_steps(_fastervit(), size, n, False),
                       _two_steps(_fastervit(conv_remat=conv_remat), size, n, remat))


ATTENTIONS = {  # module, the plain forward and backward the CPU runs
    "k5": (window_attn, "window_attention_plain", "window_attention_bwd_plain"),
    "k6": (attn_block, "attn_subblock_plain", "attn_subblock_bwd_plain"),
}


@pytest.mark.parametrize("kernel", list(ATTENTIONS))
def test_the_attention_backward_takes_the_recomputed_inputs(kernel, monkeypatch):
    """The CPU runs each kernel wrapper's plain version; its inputs are kept
    alive here, so storage is not reused and a data pointer names one call."""
    module, fwd, bwd = ATTENTIONS[kernel]
    if kernel == "k6":
        monkeypatch.setenv("DFD_FUSED_ATTN", "1")
    calls = {"fwd": [], "bwd": []}
    for name, key in ((fwd, "fwd"), (bwd, "bwd")):
        real = getattr(module, name)

        def spy(x, *a, _real=real, _key=key, **kw):
            calls[_key].append(x)
            return _real(x, *a, **kw)

        monkeypatch.setattr(module, name, spy)
    _, size, n = MODELS["fastervit"]
    runs = {}
    for remat in (False, True):
        calls["fwd"].clear(), calls["bwd"].clear()
        model = FasterViT(2, official=True, drop_path_rate=DROP, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0), **FV_NARROW)
        opt = _Recording(list(model.named_parameters()), lr=LR, weight_decay=WD,
                         trainable=unfreeze_predicate("all"))
        opt.grads = []
        x, labels, mask = _batch(size, n)
        loss = train_step(model, opt, x, labels, mask, torch.Generator().manual_seed(3),
                          remat=remat)["loss"]
        runs[remat] = (loss, opt.grads[0], model.state_dict())
        attentions = 3 if kernel == "k5" else 5  # K6 also takes the carrier tokens'
        assert (len(calls["fwd"]), len(calls["bwd"])) == (attentions * (1 + remat), attentions)
        first, recompute = calls["fwd"][:attentions], calls["fwd"][attentions:]
        ptrs = {t.data_ptr() for t in calls["bwd"]}
        if remat:
            assert ptrs <= {t.data_ptr() for t in recompute}
            assert not ptrs & {t.data_ptr() for t in first}
        else:
            assert ptrs <= {t.data_ptr() for t in first}
    (la, ga, sa), (lb, gb, sb) = runs[False], runs[True]
    assert torch.equal(la, lb) and all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


class _Convolutions(TorchDispatchMode):
    """Counts ``aten.convolution`` calls."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("conv_remat,recomputed", [(False, 0), ("full", 4), ("save-conv", 0)])
def test_conv_remat_recomputes_the_convolutions_of_full_only(conv_remat, recomputed):
    """The narrow model's two conv blocks hold two convs each: "full" runs
    them again in the backward, "save-conv" keeps their outputs."""
    model = _fastervit(conv_remat=conv_remat).train()
    x, _, _ = _batch(224, 2)
    out = model(x, torch.Generator().manual_seed(2)).sum()
    with _Convolutions() as convs:
        torch.autograd.grad(out, list(model.parameters()))
    assert convs.count == recomputed


def test_conv_remat_takes_the_jax_values_only():
    with pytest.raises(ValueError, match="conv_remat"):
        _fastervit(conv_remat="all")


def _grads_and_stats(model, g, forward):
    """One forward through ``forward(model, x, g)``, the loss's gradients and
    the running statistics after it."""
    x, labels, mask = _batch(224, 4)
    loss = smoothed_cross_entropy(forward(model.train(), x, g), labels, mask)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k
             or k.endswith("num_batches_tracked")}
    return grads, stats


def _plain(model, x, g):
    return model(x, g)


def _naive(context_fn):
    def forward(model, x, g):
        return torch.utils.checkpoint.checkpoint(model, x, g, use_reentrant=False,
                                                 context_fn=lambda: context_fn(g))
    return forward


def test_a_checkpoint_without_the_generator_replay_gets_other_gradients():
    base = _fastervit()
    want, want_stats = _grads_and_stats(copy.deepcopy(base), torch.Generator().manual_seed(5),
                                        _plain)
    got, got_stats = _grads_and_stats(
        copy.deepcopy(base), torch.Generator().manual_seed(5),
        _naive(lambda g: (contextlib.nullcontext(), common.recomputation())))
    assert not all(torch.equal(a, b) for a, b in zip(got, want))
    # with the replay (common.remat) they are equal
    again, _ = _grads_and_stats(copy.deepcopy(base), torch.Generator().manual_seed(5),
                                lambda m, x, g: common.remat(m, x, g, generator=g))
    assert all(torch.equal(a, b) for a, b in zip(again, want))


def test_a_checkpoint_without_the_batchnorm_guard_moves_the_statistics_twice():
    base = _fastervit()
    _, want = _grads_and_stats(copy.deepcopy(base), torch.Generator().manual_seed(5), _plain)
    grads, got = _grads_and_stats(copy.deepcopy(base), torch.Generator().manual_seed(5),
                                  _naive(common.generator_replay))
    assert {int(v) for k, v in got.items() if k.endswith("num_batches_tracked")} == {2}
    assert {int(v) for k, v in want.items() if k.endswith("num_batches_tracked")} == {1}
    moved = [k for k in want if "running" in k and not torch.equal(want[k], got[k])]
    assert moved


def test_remat_step_matches_jax():
    """f32, the fine-tune phase: the gates of tests/test_torch_train_step.py."""
    model = JaxEfficientNet(num_classes=2, dtype=jnp.float32, dropout_rate=0.0,
                            drop_connect_rate=0.0, **B3_NARROW)
    params, stats = jax_steps.init_model_variables(model, jax.random.key(0), (1, 32, 32, 3))
    tree = {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 2, 8).astype(np.int32)
    mask = np.array([True] * 6 + [False] * 2)
    lr = 1e-4
    tx, _, _ = jax_optim.make_phase_optimizer(params, lr=lr, weight_decay=WD,
                                              trainable=jax_optim.unfreeze_predicate("all"))
    state = jax_steps.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                                 step=jnp.asarray(0, jnp.int32))
    step = jax_steps.make_train_step_fn(model, tx, remat=True)
    with jax.default_matmul_precision("highest"):
        new, metrics = jax.jit(step)(state, jnp.asarray(x), jnp.asarray(labels),
                                     jnp.asarray(mask), jax.random.key(5))
    want = export_torch_state_dict({"params": jax.device_get(new.params),
                                    "batch_stats": jax.device_get(new.batch_stats)},
                                   "efficientnet")

    port = EfficientNet(num_classes=2, dtype=torch.float32, dropout_rate=0.0,
                        drop_connect_rate=0.0, **B3_NARROW)
    load_state_dict_strict(port, state_dict_from_jax(tree, "efficientnet"))
    opt = PhaseOptimizer(list(port.named_parameters()), lr=lr, weight_decay=WD,
                         trainable=unfreeze_predicate("all"))
    out = train_step(port.train(), opt, torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(labels).long(), torch.from_numpy(mask), None, remat=True)
    got = {k: v.numpy() for k, v in port.state_dict().items()}
    j_loss = float(metrics["loss"])
    assert abs(float(out["loss"]) - j_loss) <= 1e-5 * abs(j_loss)
    assert max(float(np.abs(got[k] - v).max()) for k, v in want.items() if "running" in k) <= 1e-5
    d = np.concatenate([np.abs(got[k] - v).ravel() / lr for k, v in want.items()
                        if "running" not in k])
    assert d.max() <= 2.01 and (d > 0.1).mean() <= 1e-2, (d.max(), (d > 0.1).mean())


def test_padded_conv_stages_match_jax():
    dims = (24, 40)
    jmodel = JaxFasterViT(num_classes=2, num_heads=FV_NARROW["num_heads"], pos_mode="cpb",
                          dtype=jnp.float32, conv_stage_dims=dims,
                          **{k: v for k, v in FV_NARROW.items() if k != "num_heads"})
    params, stats = jax_steps.init_model_variables(jmodel, jax.random.key(0), (1, 224, 224, 3))
    rng = np.random.default_rng(1)
    tree = {"params": _perturbed(jax.device_get(params), rng),
            "batch_stats": _perturbed(jax.device_get(stats), rng)}
    x = np.random.default_rng(2).normal(size=(4, 224, 224, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmodel.apply(tree, jnp.asarray(x), train=False), np.float32)
    port = FasterViT(2, official=True, dtype=torch.float32, conv_stage_dims=dims, **FV_NARROW)
    load_state_dict_strict(port, state_dict_from_jax(tree, "fastervit"))
    assert port.levels[0].blocks[0].conv1.weight.shape[0] == 24
    assert port.levels[1].blocks[0].conv1.weight.shape[0] == 40
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(want).max() > 0.1
    assert float(np.abs(got - want).max() / np.abs(want).max()) < 5e-3, (got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
