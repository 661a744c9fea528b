"""The port's eval job with ``precision: int8``: the behaviours that
tests/test_quant.py holds the JAX package's job to, on the port's job (CPU,
the int8 depthwise kernel's plain version).

- the end-to-end run (calibrate, sweep, test metrics labelled int8, the
  context not leaking out of the job);
- an existing but empty val split: calibration falls back to the test split;
- a model with no quantizable conv: nothing calibrated, the run stays bf16
  and is not labelled int8;
- int8 with hflip TTA and temperature calibration together;
- the mode plumbing from the YAML through ``build_eval_job``, including
  ``int8_calibration: Percentile``: the JAX orchestrator passes the value on
  as written and calibrates by absmax; the port lower-cases it first.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch
import yaml
from torch import nn

import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu_torch.evaluate.job import EvalJob, run_eval_job
from deepfakedetection_tpu_torch.ops import quant
from deepfakedetection_tpu_torch.registry import ModelSpec, TrainRecipe
from deepfakedetection_tpu_torch.registry import get_model_spec as port_model_spec
from deepfakedetection_tpu_torch.runtime.paths import ensure_run_dirs
from tests.test_torch_quant import PortConvBNNet

SIZE = 32


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (as tests/test_torch_cam.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


class PlainConvNet(nn.Module):
    """A conv net with no ConvBN: nothing for int8 to calibrate."""

    def __init__(self, num_classes: int = 2, generator=None, **_kw) -> None:
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.head = nn.Linear(4, num_classes)

    def forward(self, x, generator=None):
        return self.head(torch.relu(self.conv(x.float())).mean(dim=(2, 3)))


def _spec(plain: bool = False) -> ModelSpec:
    def build(num_classes, dtype=torch.float32, generator=None, **_kw):
        if plain:
            return PlainConvNet(num_classes)
        return PortConvBNNet(num_classes, dtype=dtype, generator=generator)

    return ModelSpec(name="convbn_net", family="tiny", variant="t", weights_key="convbn_net",
                     default_image_size=SIZE, recipe=TrainRecipe(), builder=build)


def _job(root, tmp_path, run_id, **kw) -> EvalJob:
    fields = dict(model_name="convbn_net", spec=_spec(), device=torch.device("cpu"),
                  run_paths=ensure_run_dirs(tmp_path / "convbn_net", run_id=run_id),
                  data_root=root, split="test", num_classes=2, img_size=SIZE, batch_size=8,
                  num_workers=0, compute_dtype=torch.float32, precision="int8")
    fields.update(kw)
    return EvalJob(**fields)


def test_eval_job_int8_end_to_end(tiny_image_tree, tmp_path):
    result = run_eval_job(_job(tiny_image_tree, tmp_path, "q0"))
    assert result is not None
    assert result.metrics.get("precision") == "int8"
    assert 0.0 <= result.metrics["accuracy"] <= 1.0
    assert result.probs.shape == (12, 2) and np.isfinite(result.probs).all()
    assert set(result.int8_scales) == {"c1", "dw", "c2"}
    lines = (tmp_path / "convbn_net" / "q0" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["precision"] == "int8"
    assert quant.current_ctx() is None  # the context does not leak out of the job
    bf16 = run_eval_job(_job(tiny_image_tree, tmp_path, "q0b", precision="bf16"))
    assert "precision" not in bf16.metrics and bf16.int8_scales is None
    # the int8 probabilities stay near the float ones on this small net
    # (measured 2.2e-3)
    assert np.abs(result.probs - bf16.probs).max() < 2e-2


def test_eval_job_int8_empty_val_falls_back_to_test_split(tiny_image_tree, tmp_path, capsys):
    root = tmp_path / "data"
    shutil.copytree(tiny_image_tree / "test", root / "test")
    (root / "val").mkdir()  # exists but empty
    result = run_eval_job(_job(root, tmp_path, "q1"))
    assert result is not None
    assert result.metrics.get("precision") == "int8"
    assert "on 2 'test' batches" in capsys.readouterr().out


def test_eval_job_int8_zero_scales_not_mislabeled(tiny_image_tree, tmp_path, capsys):
    job = _job(tiny_image_tree, tmp_path, "q2", spec=_spec(plain=True))
    result = run_eval_job(job)
    assert result is not None
    assert "precision" not in result.metrics and result.int8_scales is None
    assert "nothing calibrated (no quantizable conv layers)" in capsys.readouterr().out


def test_eval_job_int8_tta_calibration_composition(tiny_image_tree, tmp_path):
    result = run_eval_job(_job(tiny_image_tree, tmp_path, "q_comp", tta="hflip",
                               calibration="temperature"))
    assert result is not None
    m = result.metrics
    assert m.get("precision") == "int8"
    assert m.get("temperature", 0.0) > 0.0
    assert "ece" in m and "ece_uncalibrated" in m
    assert "threshold" in m
    assert 0.0 <= m["accuracy"] <= 1.0
    np.testing.assert_allclose(result.probs.sum(axis=1), 1.0, atol=1e-6)
    assert quant.current_ctx() is None


def _config(path, root, out_dir, inference):
    cfg = {
        "device": "cpu", "precision": "float32",
        "data": {"root": str(root), "num_classes": 2, "img_size": SIZE},
        "models": {"efficientnet_b3": {
            "output_dir": str(out_dir),
            "inference": {"batch_size": 8, "num_workers": 0, "precision": "int8", **inference},
        }},
        "selection": ["efficientnet_b3"],
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("written", ["percentile", "Percentile", "PERCENTILE"])
def test_eval_job_int8_calibration_mode_plumbing(tiny_image_tree, tmp_path, monkeypatch,
                                                 capsys, written):
    """``inference.int8_calibration`` reaches the calibration pass in any
    case: the scales of a "Percentile" run are the percentile ones (tighter
    than absmax on c1's raw input), not the absmax ones the JAX orchestrator
    falls back to."""
    monkeypatch.setattr(port_orch, "get_model_spec",
                        lambda name: dataclasses.replace(_spec(), name=name))
    cfg = _config(tmp_path / "c.yaml", tiny_image_tree, tmp_path / "runs",
                  {"int8_calibration": written, "int8_percentile": 0.995})
    data = yaml.safe_load(cfg.read_text())
    job = port_orch.build_eval_job(data, "efficientnet_b3", data["models"]["efficientnet_b3"],
                                   ensure_run_dirs(tmp_path / "jobdir", run_id="j"),
                                   torch.device("cpu"))
    assert (job.int8_calibration, job.int8_percentile) == ("percentile", 0.995)
    pct = port_orch.orchestrate(cfg, mode="inference")["efficientnet_b3"]
    assert "batches (percentile at 0.995)" in capsys.readouterr().out
    _config(cfg, tiny_image_tree, tmp_path / "runs_abs", {})
    absmax = port_orch.orchestrate(cfg, mode="inference")["efficientnet_b3"]
    assert pct.metrics["precision"] == absmax.metrics["precision"] == "int8"
    assert set(pct.int8_scales) == set(absmax.int8_scales) == {"c1", "dw", "c2"}
    assert all(pct.int8_scales[k] <= absmax.int8_scales[k] for k in absmax.int8_scales)
    assert pct.int8_scales["c1"] < absmax.int8_scales["c1"]


def test_int8_calibration_is_validated(tmp_path, tiny_image_tree):
    from deepfakedetection_tpu_torch.config import load_config

    cfg = _config(tmp_path / "c.yaml", tiny_image_tree, tmp_path / "runs",
                  {"int8_calibration": "minmax"})
    with pytest.raises(Exception, match="int8_calibration"):
        load_config(cfg)
    assert port_model_spec("efficientnet_b3").family == "efficientnet"
