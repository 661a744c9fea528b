"""``chip_smoke.py``'s FasterViT-2 gates hold for K6 (``DFD_FUSED_ATTN``) as
they do for K5, on the CPU, with the seeded full-width weights phase 8 uses.

- ``FV_GATE``: the fused model's bf16 logits sit inside it against the f32
  ones (measured 1.4e-3 official, 6.9e-4 tpu), and wrong variants of K6's
  forward fall outside: scale doubled (6.7e-2, 1.4e-2) and the official
  configuration's bias dropped (8.0e-2; the tpu one reads 7.8e-4, inside).
- ``FV_STEP_BOUNDS["bf16"]``, set between K5's sound and wrong readings on
  the card: one full-width bf16 step through K6's plain forward and backward
  held against the unfused path's (K5's plain versions) reads inside them
  (official / tpu: loss 5.1e-5 / 4.8e-5, attention 3.2e-3 / 3.7e-3, bias
  tensors 6.8e-3 / 1.4e-2, conv stages 8.1e-3 / 4.2e-3, head 6.9e-3 /
  3.5e-3), and wrong variants of K6's backward fall outside: dbias the
  windows' mean rather than their sum (bias tensors 0.94), dWqkv halved
  (attention 0.50). (dbqkv dropped reads attention 0.28 / 0.43.)
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from deepfakedetection_tpu_torch.models import fastervit
from deepfakedetection_tpu_torch.ops import attn_block as k6
from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ["official", "tpu"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


@pytest.fixture(scope="module")
def states(smoke):
    """The seeded full-width states of phase 8's logit and step checks, per
    configuration, made once for the module."""
    cache = {}

    def get(config, seed):
        if (config, seed) not in cache:
            cache[config, seed] = smoke.seeded_fastervit_state(config, seed=seed)
        return cache[config, seed]

    return get


def _model(smoke, state, config, fused, **kw):
    with smoke.fused_attn(fused):
        model = fastervit.create_faster_vit("2", head_config=config, **kw)
    model.load_state_dict(state)
    return model


def _grads(smoke, state, config, x, labels, fused):
    model = _model(smoke, state, config, fused, dtype=torch.bfloat16, drop_path_rate=0.0).train()
    loss, grads = smoke._loss_and_grads(model, x, labels, smoothed_cross_entropy)
    return float(loss), {n: g.float() for n, g in grads.items()}


@pytest.mark.parametrize("config", CONFIGS)
def test_logit_gate_catches_wrong_k6_forwards(smoke, states, monkeypatch, config):
    state = states(config, 11 if config == "official" else 13)
    x = smoke.seeded_images(8, torch.Generator().manual_seed(12))
    cpu = torch.device("cpu")
    f32 = smoke.fastervit_logits(state, config, x, cpu, torch.float32).double()
    model = _model(smoke, state, config, True).eval()
    assert model.kernel_launches_per_forward() == {"k5": 0, "k5_long": 0, "k6": 21}

    def rel():
        with torch.no_grad():
            out = model(x).double()
        return float((out - f32).abs().max() / f32.abs().max())

    gate = smoke.FV_GATE[config]
    assert rel() < gate
    real = fastervit.attn_subblock
    wrong = {"scale doubled": lambda *a, num_heads, scale: real(
        *a, num_heads=num_heads, scale=2 * scale)}
    if config == "official":
        wrong["bias dropped"] = lambda x_, w, b, bias, wp, bp, **kw: real(
            x_, w, b, torch.zeros_like(bias), wp, bp, **kw)
    for name, attend in wrong.items():
        monkeypatch.setattr(fastervit, "attn_subblock", attend)
        assert rel() > gate, name
    monkeypatch.setattr(fastervit, "attn_subblock", real)


def _dbias_mean(grads, x):
    return grads[:3] + (grads[3] / x.shape[0],) + grads[4:]


def _dwqkv_halved(grads, x):
    return (grads[0], grads[1] * 0.5) + grads[2:]


@pytest.mark.parametrize("config", CONFIGS)
def test_step_bounds_catch_wrong_k6_backwards(smoke, states, monkeypatch, config):
    state = states(config, 21 if config == "official" else 23)
    x = smoke.seeded_images(smoke.FV_STEP_BATCH, torch.Generator().manual_seed(24))
    labels = torch.arange(smoke.FV_STEP_BATCH) % 2
    bounds = smoke.FV_STEP_BOUNDS["bf16"]
    unfused = _grads(smoke, state, config, x, labels, False)

    def over():
        row = smoke.fv_step_readings(_grads(smoke, state, config, x, labels, True), unfused)
        return {k: row[k] for k, b in bounds.items() if not row[k] <= b}

    assert over() == {}
    real = k6.attn_subblock_bwd_plain
    for wrong, reading in ((_dbias_mean, "bias tensors"), (_dwqkv_halved, "attention")):
        monkeypatch.setattr(k6, "attn_subblock_bwd_plain",
                            lambda *a, w=wrong, **kw: w(real(*a, **kw), a[0]))
        assert reading in over(), wrong.__name__
    monkeypatch.setattr(k6, "attn_subblock_bwd_plain", real)
