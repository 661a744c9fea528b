"""Tar shards in the port (``deepfakedetection_tpu_torch/data/shards.py``): the
cases of the JAX package's ``tests/test_shards.py`` on the port's functions,
the two packages' shards read by each other, and the eval job and the
training run over shards.

- Round trip: the tiny tree's splits packed into 5-image shards scan to the
  folder scan's classes and samples, in its order; ``read_bytes`` returns
  the file's bytes; a split of ``*.tar`` files without class directories
  scans as shards.
- Loaders: an eval loader over shards gives the folder loader's images,
  labels and masks, through PIL and through the native library's buffer
  decode; a train loader over shards gives the folder loader's canvases,
  the same order for an epoch read twice and another for another epoch;
  with ``cache_decoded`` its second epoch reads no bytes.
- Across packages: shards the JAX ``write_shards`` packed scan in the port
  to the same samples and bytes, and the port's in the JAX package.
- Jobs: the port's eval job over shards equals its job over the folder tree,
  and holds to the JAX eval job over the same shards per image under
  ``tests/test_torch_eval_job.py``'s gate (probabilities within 1e-4, the
  same threshold, accuracy, confusion matrix and decisions); a two-phase
  training run over shards repeats the run over the folder tree exactly.
- ``python -m deepfakedetection_tpu_torch.data.shards`` packs a tree.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import deepfakedetection_tpu.orchestrator as jax_orch
import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu.data import folder as jax_folder
from deepfakedetection_tpu.data import shards as jax_shards
from deepfakedetection_tpu_torch.data.folder import scan_image_folder
from deepfakedetection_tpu_torch.data.pipeline import make_eval_loader, make_train_loader
from deepfakedetection_tpu_torch.data.shards import (
    TarShardDataset,
    scan_tar_shards,
    write_shards,
)
from deepfakedetection_tpu_torch.data.transforms import build_eval_plan, build_train_plan
from tests.test_torch_eval_job import _config as eval_config
from tests.test_torch_eval_job import _jax_spec, _port_spec, checkpoint  # noqa: F401
from tests.test_torch_train_loop import _assert_same_state, _latest, _records, _run_dir, _train
from tests.test_torch_train_loop import _config as train_config

REPO = Path(__file__).resolve().parents[1]
SPLITS = ("train", "val", "test")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (as tests/test_torch_cam.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def shard_tree(tiny_image_tree, tmp_path_factory):
    """Every split of the tiny tree packed by the port into 5-image shards."""
    out = tmp_path_factory.mktemp("shards")
    for split in SPLITS:
        write_shards(scan_image_folder(tiny_image_tree / split), out / split,
                     images_per_shard=5)
    return out


def test_write_scan_round_trip_matches_the_folder_scan(tiny_image_tree, shard_tree):
    for split in SPLITS:
        folder = scan_image_folder(tiny_image_tree / split)
        ds = scan_tar_shards(shard_tree / split)
        assert len(ds.shards) == -(-len(folder) // 5) > 1
        assert ds.classes == folder.classes and ds.class_to_idx == folder.class_to_idx
        assert [label for _, label in ds.samples] == [label for _, label in folder.samples]
        assert [name for name, _ in ds.samples] == [
            f"{folder.classes[label]}/{path.name}" for path, label in folder.samples]


def test_read_bytes_returns_the_file(tiny_image_tree, shard_tree):
    folder = scan_image_folder(tiny_image_tree / "test")
    ds = scan_tar_shards(shard_tree / "test")
    for i in range(len(ds)):
        assert ds.read_bytes(i) == folder.samples[i][0].read_bytes()


def test_the_folder_scan_detects_the_shard_layout(shard_tree, tmp_path):
    assert isinstance(scan_image_folder(shard_tree / "val"), TarShardDataset)
    with pytest.raises(FileNotFoundError, match="no \\*.tar shards"):
        scan_tar_shards(tmp_path)


@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_eval_loader_over_shards_gives_the_folder_batches(tiny_image_tree, shard_tree,
                                                          monkeypatch, decoder):
    if decoder == "native":
        monkeypatch.setenv("DFD_NATIVE_EVAL", "1")
    plan = build_eval_plan(32, {})
    loaders = [make_eval_loader(ds, plan, batch_size=5, num_workers=2)
               for ds in (scan_image_folder(tiny_image_tree / "test"),
                          scan_image_folder(shard_tree / "test"))]
    assert [loader.use_native for loader in loaders] == [decoder == "native"] * 2
    folder, shards = (list(loader) for loader in loaders)
    assert len(folder) == len(shards) == 3
    for bf, bs in zip(folder, shards):
        np.testing.assert_array_equal(bf.images, bs.images)
        np.testing.assert_array_equal(bf.labels, bs.labels)
        np.testing.assert_array_equal(bf.mask, bs.mask)
    assert not shards[-1].mask.all()  # the padded last batch


def test_train_loader_over_shards_is_the_folder_loader(tiny_image_tree, shard_tree):
    plan = build_train_plan(32, {})
    folder = make_train_loader(scan_image_folder(tiny_image_tree / "train"), plan,
                               batch_size=4, seed=7)
    shards = make_train_loader(scan_tar_shards(shard_tree / "train"), plan, batch_size=4,
                               seed=7)

    def epoch(loader, e):
        loader.set_epoch(e)
        return [b.images.copy() for b in loader]

    e0 = epoch(shards, 0)
    assert len(e0) == 4 and all(b.shape[0] == 4 for b in e0)
    for a, b in zip(e0, epoch(folder, 0)):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(e0, epoch(shards, 1)))
    for a, b in zip(e0, epoch(shards, 0)):
        np.testing.assert_array_equal(a, b)


def test_cache_decoded_reads_no_bytes_in_the_second_epoch(shard_tree, monkeypatch):
    loader = make_eval_loader(scan_tar_shards(shard_tree / "val"), build_eval_plan(32, {}),
                              batch_size=4, cache_decoded=True)
    first = [b.images.copy() for b in loader]
    reads = []
    real = TarShardDataset.read_bytes
    monkeypatch.setattr(TarShardDataset, "read_bytes",
                        lambda self, i: reads.append(i) or real(self, i))
    second = [b.images.copy() for b in loader]
    assert not reads
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_jax_shards_scan_in_the_port(tiny_image_tree, tmp_path):
    jax_shards.write_shards(jax_folder.scan_image_folder(tiny_image_tree / "test"), tmp_path,
                            images_per_shard=4)
    want = jax_shards.scan_tar_shards(tmp_path)
    got = scan_tar_shards(tmp_path)
    assert got.samples == want.samples and got.classes == want.classes
    assert [got.read_bytes(i) for i in range(len(got))] == [
        want.read_bytes(i) for i in range(len(want))]


def test_port_shards_scan_in_the_jax_package(tiny_image_tree, shard_tree):
    want = scan_tar_shards(shard_tree / "test")
    got = jax_folder.scan_image_folder(shard_tree / "test")  # the JAX auto-detection
    assert isinstance(got, jax_shards.TarShardDataset)
    assert got.samples == want.samples and got.classes == want.classes
    assert [got.read_bytes(i) for i in range(len(got))] == [
        want.read_bytes(i) for i in range(len(want))]


def test_eval_job_over_shards(tiny_image_tree, shard_tree, checkpoint, tmp_path,  # noqa: F811
                              monkeypatch):
    captured = {}
    real_run = jax_orch.run_eval_job
    monkeypatch.setattr(jax_orch, "get_model_spec", lambda name: _jax_spec())
    monkeypatch.setattr(jax_orch, "run_eval_job",
                        lambda job: captured.setdefault("r", real_run(job)))
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: _port_spec())
    with jax.default_matmul_precision("highest"):
        jax_orch.orchestrate(eval_config(tmp_path / "jax.yaml", shard_tree, tmp_path / "jax",
                                         checkpoint), mode="inference")
    want = captured["r"]

    def port(root, name):
        cfg = eval_config(tmp_path / f"{name}.yaml", root, tmp_path / name, checkpoint)
        return port_orch.orchestrate(cfg, mode="inference")["efficientnet_b3"]

    got, folder = port(shard_tree, "shards"), port(tiny_image_tree, "folder")
    np.testing.assert_array_equal(got.probs, folder.probs)
    np.testing.assert_array_equal(got.val_probs, folder.val_probs)
    t = want.metrics["threshold"]
    assert got.probs.shape == want.probs.shape == (12, 2)
    np.testing.assert_array_equal(got.targets, want.targets)
    np.testing.assert_allclose(got.probs, want.probs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.val_probs, want.val_probs, atol=1e-4, rtol=0)
    assert got.metrics["threshold"] == t
    far = np.abs(want.probs[:, 1] - t) > 1e-4
    np.testing.assert_array_equal(got.preds[far], want.preds[far])
    assert got.metrics["accuracy"] == want.metrics["accuracy"]
    assert got.metrics["confusion_matrix"] == want.metrics["confusion_matrix"]


def test_training_over_shards_repeats_the_folder_run(tiny_image_tree, shard_tree, tmp_path,
                                                     monkeypatch):
    runs = {}
    for name, root in (("folder", tiny_image_tree), ("shards", shard_tree)):
        result = _train(monkeypatch, train_config(tmp_path / f"{name}.yaml", root,
                                                  tmp_path / name))
        assert result.epochs_run == 2 and not result.interrupted
        runs[name] = _run_dir(tmp_path / name)
    _assert_same_state(_latest(runs["folder"]), _latest(runs["shards"]))
    assert _records(runs["folder"]) != [] and [
        (r["train_loss"], r["accuracy"]) for r in _records(runs["folder"])] == [
        (r["train_loss"], r["accuracy"]) for r in _records(runs["shards"])]


def test_the_cli_packs_a_tree(tiny_image_tree, tmp_path):
    out = tmp_path / "packed"
    proc = subprocess.run(
        [sys.executable, "-m", "deepfakedetection_tpu_torch.data.shards", "--root",
         str(tiny_image_tree), "--out", str(out), "--splits", "train", "test", "missing",
         "--images-per-shard", "7"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "train: 16 images (2 classes) → 3 shard(s)" in proc.stdout
    assert "skipping missing split" in proc.stdout
    assert sorted(p.name for p in (out / "test").iterdir()) == [
        "shard-00000.tar", "shard-00001.tar"]
    assert not (out / "val").exists()
    folder = scan_image_folder(tiny_image_tree / "train")
    packed = scan_image_folder(out / "train")
    assert [packed.read_bytes(i) for i in range(len(packed))] == [
        p.read_bytes() for p, _ in folder.samples]
