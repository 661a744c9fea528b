"""``profile_dir``: a short run of the narrow EfficientNet of
``tests/test_torch_train_loop.py`` (one epoch: two warmup and two fine-tune
steps) writes one ``torch.profiler`` TensorBoard trace under it, which parses
as JSON and holds the train step's operators; without ``profile_dir``
nothing is written there."""

import json

import pytest
import torch
import yaml

from tests.test_torch_train_loop import _config, _run_dir, _train


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (as tests/test_torch_cam.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _with_profile_dir(cfg, profile_dir):
    data = yaml.safe_load(cfg.read_text())
    data["profile_dir"] = str(profile_dir)
    cfg.write_text(yaml.safe_dump(data))
    return cfg


def test_a_run_writes_a_trace_under_profile_dir(tiny_image_tree, tmp_path, monkeypatch):
    traces = tmp_path / "traces"
    cfg = _with_profile_dir(
        _config(tmp_path / "p.yaml", tiny_image_tree, tmp_path / "p", epochs=1), traces)
    result = _train(monkeypatch, cfg)
    assert result.epochs_run == 1 and not result.interrupted
    (trace,) = traces.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names and "Optimizer.step#AdamW.step" in names
    assert (_run_dir(tmp_path / "p") / "checkpoints" / "latest.ckpt").exists()


def test_no_trace_without_profile_dir(tiny_image_tree, tmp_path, monkeypatch):
    cfg = _config(tmp_path / "n.yaml", tiny_image_tree, tmp_path / "n", epochs=1)
    _train(monkeypatch, cfg)
    assert not list(tmp_path.rglob("*.pt.trace.json"))
