"""The port's batch-job ensemble (deepfakedetection_tpu_torch/evaluate/
ensemble.py and ``orchestrate``'s routing) against the JAX package's.

- ``combine_probs`` equal to the JAX function's on seeded arrays, bit for bit.
- ``run_ensemble`` on the same member results in both packages: the same
  record and plots; the skip cases (fewer than two members, different
  splits, misaligned targets) skip in both.
- ``orchestrate(mode="inference")`` with a top-level ``ensemble:`` in both
  packages on the narrow B3 and EfficientFormerV2 of
  ``tests/test_torch_serve.py`` (64 px, float32, one ``.pth`` each) over one
  JPEG tree with val and test splits: the ensemble record's members, split,
  accuracy, threshold, weights and confusion matrix equal, ROC-AUC within
  1e-6, the same plots, its own run dir with a config snapshot. With one
  evaluated model neither package makes an ensemble run dir.
"""

import json

import jax
import numpy as np
import pytest
import torch
import yaml

import deepfakedetection_tpu.orchestrator as jax_orch
import deepfakedetection_tpu.runtime.compile_cache as jax_compile_cache
import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu.evaluate import ensemble as jax_ensemble
from deepfakedetection_tpu.evaluate.job import EvalResult as JaxEvalResult
from deepfakedetection_tpu.runtime.paths import ensure_run_dirs as jax_run_dirs
from deepfakedetection_tpu_torch.evaluate import ensemble as port_ensemble
from deepfakedetection_tpu_torch.evaluate.job import EvalResult as PortEvalResult
from deepfakedetection_tpu_torch.runtime.paths import ensure_run_dirs as port_run_dirs
from tests.test_torch_predict import B3, EF, _specs
from tests.test_torch_serve import model_block, write_jpegs, write_models

PACKAGES = {"jax": (jax_ensemble, JaxEvalResult, jax_run_dirs),
            "port": (port_ensemble, PortEvalResult, port_run_dirs)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (see
    ``tests/test_torch_predict.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _results(cls, rng, names, n=24, n_val=16, split="test", targets=None):
    """Seeded binary member results of ``cls`` (a package's EvalResult)."""
    targets = np.asarray(targets if targets is not None else np.arange(n) % 2, np.int64)
    val_targets = (np.arange(n_val) // 2) % 2
    out = {}
    for name in names:
        p1 = np.clip(0.5 + 0.35 * (2 * targets - 1) + rng.normal(0, 0.25, n), 0.01, 0.99)
        v1 = np.clip(0.6 + 0.3 * (2 * val_targets - 1) + rng.normal(0, 0.25, n_val), 0.01, 0.99)
        out[name] = cls(
            metrics={"model": name, "split": split, "accuracy": 0.0},
            probs=np.stack([1 - p1, p1], 1).astype(np.float32), targets=targets,
            preds=(p1 >= 0.5).astype(np.int64), classes=["fake", "real"],
            val_probs=np.stack([1 - v1, v1], 1).astype(np.float32), val_targets=val_targets)
    return out


@pytest.mark.parametrize("weights", [None, {"a": 2.0}, {"a": 1.0, "b": 3.0, "c": 0.5}])
@pytest.mark.parametrize("attr", ["probs", "val_probs"])
def test_combine_probs_equals_the_jax_function(weights, attr):
    want = jax_ensemble.combine_probs(
        _results(JaxEvalResult, np.random.default_rng(0), "abc"), weights, attr)
    got = port_ensemble.combine_probs(
        _results(PortEvalResult, np.random.default_rng(0), "abc"), weights, attr)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_combine_probs_none_when_a_member_lacks_the_array():
    results = _results(PortEvalResult, np.random.default_rng(0), "ab")
    results["b"].val_probs = None
    assert port_ensemble.combine_probs(results, None, "val_probs") is None
    results["b"].val_probs = np.zeros((3, 2))
    assert port_ensemble.combine_probs(results, None, "val_probs") is None


def _run(package, tmp_path, **kw):
    ensemble, cls, run_dirs = PACKAGES[package]
    results = _results(cls, np.random.default_rng(1), "ab", **kw)
    paths = run_dirs(tmp_path / package)
    return ensemble.run_ensemble(results, paths, num_classes=2, weights={"a": 2.0}), paths


def test_run_ensemble_record_and_plots_equal_the_jax_package(tmp_path):
    (want, wpaths), (got, gpaths) = (_run(p, tmp_path) for p in ("jax", "port"))
    assert want is not None and got is not None
    for rec in (want, got):
        rec.pop("timestamp")
    assert got == want
    assert got["members"] == ["a", "b"] and got["weights"] == {"a": 2.0, "b": 1.0}
    logged = json.loads((gpaths.logs / "metrics.jsonl").read_text().splitlines()[-1])
    assert logged["model"] == "ensemble" and logged["threshold"] == got["threshold"]
    assert sorted(p.name for p in gpaths.plots.iterdir()) == \
        sorted(p.name for p in wpaths.plots.iterdir()) == ["confusion_matrix.png", "roc_curve.png"]


@pytest.mark.parametrize("case", ["one member", "different splits", "misaligned targets"])
def test_run_ensemble_skips_in_both_packages(tmp_path, case):
    for package, (ensemble, cls, run_dirs) in PACKAGES.items():
        rng = np.random.default_rng(2)
        if case == "one member":
            results = _results(cls, rng, "a")
        else:
            results = {**_results(cls, rng, "a"),
                       **_results(cls, rng, "b", split="val" if case == "different splits"
                                  else "test",
                                  targets=None if case == "different splits"
                                  else 1 - np.arange(24) % 2)}
        paths = run_dirs(tmp_path / package)
        assert ensemble.run_ensemble(results, paths, num_classes=2) is None, (package, case)
        assert not (paths.logs / "metrics.jsonl").exists()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JPEG tree (val 12, test 16 images) and the two ``.pth`` files."""
    tmp = tmp_path_factory.mktemp("ensemble")
    write_jpegs(tmp / "data", {"val": 12, "test": 16}, seed=5)
    return tmp, write_models(tmp, tmp / "data" / "test")


def _config(tmp, weights, selection, out, ensemble):
    cfg = {"seed": 3, "device": "cpu", "precision": "float32",
           "data": {"root": str(tmp / "data"), "num_classes": 2, "img_size": 64,
                    "test_split": "test", "val_split": "val"},
           "models": {name: model_block(tmp / out, name, weights[name], batch_size=8)
                      for name in (B3, EF)},
           "selection": selection,
           "ensemble": ensemble}
    path = tmp / f"{out}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture()
def both_specs(monkeypatch):
    jax_specs, port_specs = _specs()
    monkeypatch.setattr(jax_orch, "get_model_spec", lambda name: jax_specs[name])
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: port_specs[name])
    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)


def _ensemble_runs(tmp, out):
    root = tmp / out / "ensemble"
    return sorted(root.iterdir()) if root.exists() else []


def test_orchestrate_runs_the_ensemble_as_the_jax_package_does(tree, both_specs):
    tmp, weights = tree
    recs, plots = {}, {}
    for package, orchestrate in (("jax", jax_orch.orchestrate), ("port", port_orch.orchestrate)):
        out = f"runs_{package}"
        cfg = _config(tmp, weights, [B3, EF], out,
                      {"weights": {B3: 2.0}, "output_dir": str(tmp / out / "ensemble")})
        with jax.default_matmul_precision("highest"):
            orchestrate(cfg, mode="inference")
        (run,) = _ensemble_runs(tmp, out)
        recs[package] = json.loads((run / "logs" / "metrics.jsonl").read_text().splitlines()[-1])
        plots[package] = sorted(p.name for p in (run / "plots").iterdir())
        snapshot = yaml.safe_load((run / "config_snapshot.yaml").read_text())
        assert snapshot["model"]["name"] == "ensemble"
    got, want = recs["port"], recs["jax"]
    for key in ("model", "members", "split", "accuracy", "threshold", "confusion_matrix",
                "weights"):
        assert got[key] == want[key], key
    assert got["members"] == [B3, EF] and got["weights"] == {B3: 2.0, EF: 1.0}
    assert abs(got["roc_auc"] - want["roc_auc"]) <= 1e-6
    assert set(got) == set(want)
    assert plots["port"] == plots["jax"] == ["confusion_matrix.png", "roc_curve.png"]


def test_orchestrate_with_one_evaluated_model_makes_no_ensemble(tree, both_specs, monkeypatch):
    """Fewer than two evaluated models: both packages warn and make no
    ensemble run dir (the members' evaluation is stubbed)."""
    tmp, weights = tree
    for package, module, cls in (("jax", jax_orch, JaxEvalResult),
                                 ("port", port_orch, PortEvalResult)):
        result = _results(cls, np.random.default_rng(3), "a")["a"]
        monkeypatch.setattr(module, "run_eval_job", lambda job, r=result: r)
        out = f"one_{package}"
        cfg = _config(tmp, weights, [B3], out, {"output_dir": str(tmp / out / "ensemble")})
        module.orchestrate(cfg, mode="inference")
        assert _ensemble_runs(tmp, out) == [], package
