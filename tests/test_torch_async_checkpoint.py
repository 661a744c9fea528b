"""``training.async_checkpoint``: ``runtime/checkpoint.AsyncSaver`` and the
train loop's epoch-end writes through it.

- A submit snapshots the tree: tensors changed in place after the submit
  (while the worker is held back) leave the written file as submitted; two
  submits to one path leave the newer; a queued call runs after the writes
  before it; ``wait()`` re-raises a failing write, and a run whose write
  fails raises.
- A short run (the narrow EfficientNet of ``tests/test_torch_train_loop.py``,
  two epochs) with ``async_checkpoint`` writes the same files as a sync run
  with equal tensors, and a resume from them repeats the sync run.
- A preemption mid-epoch drains the saver before the mid-epoch save, so
  ``latest.ckpt`` holds the mid-epoch state and the sidecar stays.
"""

import threading

import pytest
import torch

from deepfakedetection_tpu_torch.runtime import checkpoint as ckpt
from deepfakedetection_tpu_torch.runtime import preempt
from tests.test_torch_train_loop import (
    _assert_same_state,
    _config,
    _latest,
    _records,
    _run_dir,
    _train,
)

FILES = ("latest.ckpt", "best.ckpt", "efficientnet_b3.pth")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (as tests/test_torch_cam.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _held(saver):
    """Holds the saver's worker until the returned event is set."""
    go = threading.Event()
    saver.submit_call(lambda: go.wait(timeout=30))
    return go


def test_the_written_tree_is_the_one_submitted(tmp_path):
    live = {"w": torch.arange(6.0).reshape(2, 3), "rows": [torch.ones(2)], "count": 3}
    saver = ckpt.AsyncSaver()
    go = _held(saver)
    saver.submit_tree(tmp_path / "a.ckpt", live)
    live["w"].add_(100.0)  # the next optimizer step, in place
    live["rows"][0].zero_()
    live["count"] = 4
    go.set()
    saver.close()
    got = ckpt.load(tmp_path / "a.ckpt")
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(got["rows"][0], torch.ones(2)) and got["count"] == 3


def test_latest_holds_the_newer_submit_and_calls_run_after_writes(tmp_path):
    path, order = tmp_path / "latest.ckpt", []
    saver = ckpt.AsyncSaver()
    go = _held(saver)
    saver.submit_tree(path, {"epoch": 0, "w": torch.zeros(3)})
    saver.submit_tree(path, {"epoch": 1, "w": torch.ones(3)})
    saver.submit_call(lambda: order.append(ckpt.load(path)["epoch"]))
    go.set()
    saver.wait()
    assert order == [1] and torch.equal(ckpt.load(path)["w"], torch.ones(3))
    saver.close()
    saver.close()  # idempotent


def test_wait_reraises_a_failing_write(tmp_path, monkeypatch):
    def fail(path, obj):
        raise OSError(f"disk full writing {path.name}")

    saver = ckpt.AsyncSaver()
    monkeypatch.setattr(ckpt, "save", fail)
    saver.submit_tree(tmp_path / "a.ckpt", {"w": torch.ones(1)})
    with pytest.raises(OSError, match="disk full writing a.ckpt"):
        saver.wait()
    monkeypatch.undo()
    saver.submit_tree(tmp_path / "b.ckpt", {"w": torch.ones(1)})  # the saver goes on
    saver.close()
    assert (tmp_path / "b.ckpt").exists() and not (tmp_path / "a.ckpt").exists()


def test_a_run_whose_async_write_fails_raises(tiny_image_tree, tmp_path, monkeypatch):
    def fail(path, obj):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save", fail)
    cfg = _config(tmp_path / "f.yaml", tiny_image_tree, tmp_path / "f", epochs=1,
                  async_checkpoint=True)
    with pytest.raises(OSError, match="disk full"):
        _train(monkeypatch, cfg)


@pytest.fixture(scope="module")
def sync_run(tiny_image_tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync")
    mp = pytest.MonkeyPatch()
    try:
        _train(mp, _config(tmp / "s.yaml", tiny_image_tree, tmp / "s"))
    finally:
        mp.undo()
    return _run_dir(tmp / "s")


def _assert_same_files(a, b):
    for name in FILES:
        sa = torch.load(a / "checkpoints" / name, weights_only=True)
        sb = torch.load(b / "checkpoints" / name, weights_only=True)
        if name.endswith(".pth"):
            assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
        else:
            _assert_same_state(sa, sb)


def test_async_run_writes_the_sync_files_and_resumes(sync_run, tiny_image_tree, tmp_path,
                                                     monkeypatch):
    run = _train(monkeypatch, _config(tmp_path / "a.yaml", tiny_image_tree, tmp_path / "a",
                                      async_checkpoint=True))
    assert run.epochs_run == 2 and not run.interrupted
    run_a = _run_dir(tmp_path / "a")
    assert "async checkpointing" in (run_a / "logs" / "train.log").read_text()
    _assert_same_files(sync_run, run_a)
    assert _records(sync_run)[-1]["train_loss"] == _records(run_a)[-1]["train_loss"]

    first = _train(monkeypatch, _config(tmp_path / "b1.yaml", tiny_image_tree, tmp_path / "b",
                                        epochs=1, async_checkpoint=True))
    resumed = _train(monkeypatch, _config(tmp_path / "b2.yaml", tiny_image_tree, tmp_path / "b",
                                          async_checkpoint=True))
    assert first.epochs_run == resumed.epochs_run == 1
    _assert_same_state(_latest(sync_run), _latest(_run_dir(tmp_path / "b")))


def test_preemption_drains_the_saver_before_the_mid_epoch_save(sync_run, tiny_image_tree,
                                                               tmp_path, monkeypatch):
    events = []
    real_save, real_wait = ckpt.save, ckpt.AsyncSaver.wait

    def save(path, obj):
        real_save(path, obj)
        events.append(("save", path.name, threading.current_thread().name.startswith("ckpt")))

    def wait(self):
        real_wait(self)
        events.append(("wait",))

    calls = {"n": 0}

    def stop_after_the_first_step_of_epoch_two():
        calls["n"] += 1  # two warmup steps, then two a fine-tune epoch
        return calls["n"] >= 5

    monkeypatch.setattr(ckpt, "save", save)
    monkeypatch.setattr(ckpt.AsyncSaver, "wait", wait)
    monkeypatch.setattr(preempt, "requested", stop_after_the_first_step_of_epoch_two)
    cfg = _config(tmp_path / "p.yaml", tiny_image_tree, tmp_path / "p", async_checkpoint=True)
    stopped = _train(monkeypatch, cfg)
    assert stopped.interrupted
    # epoch 1's writes on the worker, the drain, then the mid-epoch save here
    worker = [e for e in events if e[0] == "save" and e[2]]
    assert {e[1] for e in worker} == set(FILES)
    last_worker = events.index(worker[-1])
    drain = events.index(("wait",), last_worker)
    assert events[drain + 1] == ("save", "latest.ckpt", False)
    run_p = _run_dir(tmp_path / "p")
    assert _latest(run_p)["counters"]["epoch"] == 0
    assert preempt.read_progress(run_p / "checkpoints") == {
        "epoch": 1, "batches_done": 1, "batch_size": 8}
    monkeypatch.undo()
    resumed = _train(monkeypatch, cfg)
    assert not resumed.interrupted and resumed.epochs_run == 1
    assert preempt.read_progress(run_p / "checkpoints") is None
    _assert_same_state(_latest(sync_run), _latest(run_p))
