"""The training slice as a whole: the port's ``orchestrate(mode="training")``
on a tiny image tree, against itself (run dir, checkpoints, exact resume) and
against the JAX package's run on the same data.

Both stacks train a narrow EfficientNet (width 0.25, depth 0.5) at 32 px with
``get_model_spec`` monkeypatched, and the recipe cut to a fine-tune batch of 8
(micro 8 x accum 1) so the 16 training images give two steps per epoch.

- Run dir: ``config_snapshot.yaml``, ``logs/train.log`` with the warmup and
  epoch lines and img/s, ``metrics.jsonl`` with one record per epoch,
  ``latest.ckpt``, ``best.ckpt`` and ``efficientnet_b3.pth``, a plain state
  dict under efficientnet_pytorch names that the inference job loads through
  ``weights: auto``.
- Resume on the CPU is bit-identical: 2 epochs against 1 epoch and a
  resumed second, and against a run stopped after its first fine-tune step
  (the sidecar) and resumed; the final model and optimizer tensors are equal.
- With augmentation, dropout and drop-path off and the same initial weights
  (a JAX init exported to a ``.pth`` and loaded by both through
  ``training.init_weights``), the per-epoch train loss agrees with the JAX
  ``run_training`` to 1e-4 relative in f32 (measured 7.3e-6 at the second
  epoch) and the val accuracy is equal (the tree's noise images carry no
  signal, so it stays at chance). The exported best weights agree too: Adam
  moves a weight whose gradient sign differs between the frameworks by 2 lr,
  so no element may differ by more than 2 lr summed over the steps, and at
  most 1% by more than 1e-5 (measured max 3.4e-4, 0.15%); the running
  statistics to 1e-4 (measured 1.5e-5).
- ``train_random_rotation: true`` sends every train batch through K4's
  plain version inside the loop (the default turns rotation off at 32 px).

FasterViT's training slice is ``tests/test_torch_train_loop_fastervit.py``.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import deepfakedetection_tpu.orchestrator as jax_orch
import deepfakedetection_tpu_torch.orchestrator as port_orch
import deepfakedetection_tpu_torch.train.loop as port_loop
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.registry import get_model_spec as jax_model_spec
from deepfakedetection_tpu.runtime.torch_convert import export_torch_state_dict
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch.data import augment
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
from deepfakedetection_tpu_torch.ops import shear_rotate
from deepfakedetection_tpu_torch.registry import get_model_spec as port_model_spec
from deepfakedetection_tpu_torch.runtime import preempt
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict

NARROW = dict(width_coefficient=0.25, depth_coefficient=0.5, native_resolution=32)
OFF = dict(dropout_rate=0.0, drop_connect_rate=0.0)
SIZE = 32
NO_AUG = {"train_random_crop": False, "train_random_horizontal_flip": False,
          "train_random_rotation": False, "train_color_jitter": False,
          "train_random_erasing": False}


def _recipe(spec):
    return dataclasses.replace(
        spec, recipe=dataclasses.replace(spec.recipe, finetune_micro_batch=8, accum_steps=1)
    )


def _port_spec(**model):
    return _recipe(dataclasses.replace(
        port_model_spec("efficientnet_b3"),
        builder=lambda num_classes, dtype=torch.bfloat16, generator=None, **kw: EfficientNet(
            num_classes=num_classes, dtype=dtype, generator=generator, **NARROW, **model
        ),
    ))


def _jax_spec():
    return _recipe(dataclasses.replace(
        jax_model_spec("efficientnet_b3"),
        builder=lambda num_classes, dtype=jnp.bfloat16, **kw: JaxEfficientNet(
            num_classes=num_classes, dtype=dtype, **NARROW, **OFF
        ),
    ))


def _config(path, root, out_dir, *, precision="bfloat16", train=None, mode_block=None, **training):
    block = {"output_dir": str(out_dir),
             "training": {"epochs": 2, "batch_size": 8, "num_workers": 0, "resume": "continue",
                          **training}}
    if train is not None:
        block["transforms"] = {"train": train}
    block.update(mode_block or {})
    cfg = {"seed": 7, "device": "cpu", "precision": precision,
           "data": {"root": str(root), "num_classes": 2, "img_size": SIZE,
                    "test_split": "test"},
           "models": {"efficientnet_b3": block}, "selection": ["efficientnet_b3"]}
    path.write_text(yaml.safe_dump(cfg))
    return path


def _train(monkeypatch, cfg, spec=None):
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: spec or _port_spec())
    return port_orch.orchestrate(cfg, mode="training")["efficientnet_b3"]


def _run_dir(out_dir):
    (run,) = sorted(p for p in out_dir.iterdir() if p.is_dir())
    return run


def _records(run):
    return [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text().splitlines()]


def _latest(run):
    return torch.load(run / "checkpoints" / "latest.ckpt", weights_only=True)


def _assert_same_state(a, b):
    assert a["counters"] == b["counters"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["optimizer"]["count"] == b["optimizer"]["count"]
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


@pytest.fixture(scope="module")
def two_epochs(tiny_image_tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    mp = pytest.MonkeyPatch()
    try:
        result = _train(mp, _config(tmp / "a.yaml", tiny_image_tree, tmp / "a"))
    finally:
        mp.undo()
    return result, _run_dir(tmp / "a")


def test_training_writes_the_run_dir(two_epochs):
    result, run = two_epochs
    assert not result.interrupted and result.epochs_run == 2
    assert (run / "config_snapshot.yaml").exists()
    log = (run / "logs" / "train.log").read_text()
    for line in ("→ training efficientnet_b3", "warmup 1/1: loss=", "warmup val acc=",
                 "fine-tune: epochs=2 batch=8 (micro 8 × accum 1)", "epoch 1/2: loss=",
                 "epoch 2/2: loss=", "img/s"):
        assert line in log, line
    records = _records(run)
    assert [r["epoch"] for r in records] == [1, 2]
    assert set(records[0]) == {"model", "split", "epoch", "train_loss", "train_img_s",
                               "accuracy", "best", "timestamp"}
    assert all(np.isfinite(r["train_loss"]) and r["train_loss"] > 0 for r in records)
    ckpts = run / "checkpoints"
    assert (ckpts / "latest.ckpt").exists() and (ckpts / "best.ckpt").exists()
    state = torch.load(ckpts / "efficientnet_b3.pth", weights_only=True)
    model = EfficientNet(num_classes=2, **NARROW)
    load_state_dict_strict(model, state)  # a plain efficientnet_pytorch state dict
    assert _latest(run)["counters"]["epoch"] == 1


def test_trained_weights_hand_over_to_inference(two_epochs, tiny_image_tree, tmp_path,
                                                monkeypatch, capsys):
    _, trained = two_epochs
    run = tmp_path / "out" / trained.name  # a copy: the job's own run dir goes beside it
    shutil.copytree(trained, run)
    cfg = _config(tmp_path / "i.yaml", tiny_image_tree, run.parent,
                  mode_block={"inference": {"weights": "auto", "batch_size": 8,
                                            "num_workers": 0, "img_size": SIZE}})
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: _port_spec())
    res = port_orch.orchestrate(cfg, mode="inference")["efficientnet_b3"]
    printed = "".join(capsys.readouterr().out.split())  # the console wraps long lines
    assert f"weights:auto→{run / 'checkpoints' / 'efficientnet_b3.pth'}" in printed
    assert res.probs.shape == (12, 2) and np.isfinite(res.probs).all()


def test_resume_at_an_epoch_boundary_is_bit_identical(two_epochs, tiny_image_tree, tmp_path,
                                                      monkeypatch):
    _, run_a = two_epochs
    first = _train(monkeypatch, _config(tmp_path / "b1.yaml", tiny_image_tree, tmp_path / "b",
                                        epochs=1))
    assert first.epochs_run == 1
    resumed = _train(monkeypatch, _config(tmp_path / "b2.yaml", tiny_image_tree, tmp_path / "b"))
    assert resumed.epochs_run == 1  # only the second epoch ran
    run_b = _run_dir(tmp_path / "b")
    assert "resumed from" in (run_b / "logs" / "train.log").read_text()
    _assert_same_state(_latest(run_a), _latest(run_b))
    assert [r["train_loss"] for r in _records(run_a)] == [r["train_loss"] for r in _records(run_b)]


def test_mid_epoch_resume_is_bit_identical(two_epochs, tiny_image_tree, tmp_path, monkeypatch):
    _, run_a = two_epochs
    calls = {"n": 0}

    def stop_after_first_finetune_step():
        calls["n"] += 1  # the warmup takes two steps
        return calls["n"] >= 3

    cfg = _config(tmp_path / "c.yaml", tiny_image_tree, tmp_path / "c")
    monkeypatch.setattr(preempt, "requested", stop_after_first_finetune_step)
    stopped = _train(monkeypatch, cfg)
    monkeypatch.undo()
    assert stopped.interrupted
    run_c = _run_dir(tmp_path / "c")
    assert preempt.read_progress(run_c / "checkpoints") == {
        "epoch": 0, "batches_done": 1, "batch_size": 8}
    resumed = _train(monkeypatch, cfg)
    assert not resumed.interrupted and resumed.epochs_run == 2
    assert preempt.read_progress(run_c / "checkpoints") is None
    _assert_same_state(_latest(run_a), _latest(run_c))
    a_pth = torch.load(run_a / "checkpoints" / "efficientnet_b3.pth", weights_only=True)
    c_pth = torch.load(run_c / "checkpoints" / "efficientnet_b3.pth", weights_only=True)
    assert all(torch.equal(a_pth[k], c_pth[k]) for k in a_pth)


def test_rotation_runs_k4_plain_inside_the_loop(tiny_image_tree, tmp_path, monkeypatch):
    calls = []
    real = augment.rotate_batch

    def spy(imgs, thetas, **kw):
        calls.append((tuple(imgs.shape), float(thetas.abs().max()), kw["max_theta"]))
        return real(imgs, thetas, **kw)

    monkeypatch.setattr(augment, "rotate_batch", spy)
    before = shear_rotate.rotate_batch.launches
    result = _train(monkeypatch, _config(
        tmp_path / "r.yaml", tiny_image_tree, tmp_path / "r", epochs=1,
        train={"train_random_rotation": True},
    ))
    assert not result.interrupted
    # 2 warmup + 2 fine-tune steps, each batch of 8 canvases at 36 px
    assert [c[0] for c in calls] == [(8, 36, 36, 3)] * 4
    assert all(0.0 < c[1] <= c[2] for c in calls) and calls[0][2] == pytest.approx(0.17453, 1e-4)
    assert shear_rotate.rotate_batch.launches == before  # plain version: no kernel launch


def test_unported_options_refuse_before_any_work(tiny_image_tree, tmp_path, monkeypatch):
    """A model axis in the mesh (ROADMAP Queue 1 item 14, tensor
    parallelism) is what the trainer still refuses."""
    cfg = _config(tmp_path / "u.yaml", tiny_image_tree, tmp_path / "u")
    cfg.write_text(yaml.safe_dump({**yaml.safe_load(cfg.read_text()),
                                   "mesh": {"data": -1, "model": 2}}))
    with pytest.raises(NotImplementedError, match="item 14"):
        _train(monkeypatch, cfg)
    assert not (tmp_path / "u").exists()


@pytest.mark.parametrize("option", [{"remat": True}, {"async_checkpoint": True},
                                    {"profile_dir": "traces"}], ids=lambda o: next(iter(o)))
def test_training_options_reach_the_trainer(tiny_image_tree, tmp_path, monkeypatch, option):
    """``training.remat``, ``training.async_checkpoint`` and the top-level
    ``profile_dir`` pass the orchestrator's checks into the job."""
    cfg = _config(tmp_path / "o.yaml", tiny_image_tree, tmp_path / "o",
                  **{k: v for k, v in option.items() if k != "profile_dir"})
    if "profile_dir" in option:
        data = yaml.safe_load(cfg.read_text())
        data["profile_dir"] = str(tmp_path / option["profile_dir"])
        cfg.write_text(yaml.safe_dump(data))
    jobs = []
    monkeypatch.setattr(port_orch, "run_training",
                        lambda job: jobs.append(job) or port_loop.TrainResult(0.0, -1, 0, 0.0))
    _train(monkeypatch, cfg)
    (job,) = jobs
    assert port_loop.unported_options(job) == []
    assert (job.remat, job.async_checkpoint, job.profile_dir) == (
        option.get("remat", False), option.get("async_checkpoint", False),
        option.get("profile_dir") and str(tmp_path / option["profile_dir"]))


@pytest.fixture(scope="module")
def jax_init_weights(tmp_path_factory):
    model = JaxEfficientNet(num_classes=2, dtype=jnp.float32, **NARROW, **OFF)
    params, stats = init_model_variables(model, jax.random.key(3), (1, SIZE, SIZE, 3))
    sd = export_torch_state_dict(
        {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}, "efficientnet")
    path = tmp_path_factory.mktemp("init") / "init.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return path


def test_loop_matches_jax_without_augmentation(tiny_image_tree, tmp_path, monkeypatch,
                                               jax_init_weights):
    def cfg(name):
        return _config(tmp_path / f"{name}.yaml", tiny_image_tree, tmp_path / name,
                       precision="float32", train=NO_AUG, resume=False,
                       init_weights=str(jax_init_weights))

    monkeypatch.setattr(jax_orch, "get_model_spec", lambda name: _jax_spec())
    with jax.default_matmul_precision("highest"):
        jax_orch.orchestrate(cfg("jax"), mode="training")
    _train(monkeypatch, cfg("port"), spec=_port_spec(**OFF))
    want, got = _records(_run_dir(tmp_path / "jax")), _records(_run_dir(tmp_path / "port"))
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-4)
        assert g["accuracy"] == w["accuracy"]
    # the exported best weights (epoch 1: 2 warmup steps at 3e-4 over the head,
    # 2 fine-tune steps at 1e-4), the JAX export through the converter's names
    blob = (_run_dir(tmp_path / "jax") / "checkpoints" / "efficientnet_b3.pth").read_bytes()
    jax_sd = export_torch_state_dict(serialization.msgpack_restore(bytearray(blob)),
                                     "efficientnet")
    port_sd = torch.load(_run_dir(tmp_path / "port") / "checkpoints" / "efficientnet_b3.pth",
                         weights_only=True)
    d = {k: np.abs(port_sd[k].numpy() - v) for k, v in jax_sd.items()}
    params = np.concatenate([v.ravel() for k, v in d.items() if "running" not in k])
    stats = max(float(v.max()) for k, v in d.items() if "running" in k)
    assert params.max() <= 2 * (2 * 3e-4 + 2 * 1e-4)  # every step's sign flipped
    assert (params > 1e-5).mean() <= 1e-2 and stats <= 1e-4
