"""FasterViT's training slice: the port's ``orchestrate(mode="training")`` on
a tiny image tree with a narrow FasterViT.

A narrow tpu-configuration FasterViT (dim 16, depths (1, 1, 2, 1)) at 224 px
with the FasterViT recipe cut to micro 8 x accum 1 trains one epoch through
K5's plain versions, forward and backward (a warmup and a fine-tune,
validation after each) and writes the run dir; ``weights: auto`` inference
on its ``faster_vit_2_224.pth`` builds the tpu configuration again. A
FasterViT ``init_weights`` picks the head configuration its tensors were
made in (a wheel-named official file gives official, the port's tpu export
tpu) unless the config pins one. (The EfficientNet cases are
``tests/test_torch_train_loop.py``'s.)
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import yaml

import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu_torch.models.fastervit import FasterViT
from deepfakedetection_tpu_torch.ops import window_attn
from deepfakedetection_tpu_torch.registry import get_model_spec as port_model_spec


def _recipe(spec):
    return dataclasses.replace(
        spec, recipe=dataclasses.replace(spec.recipe, finetune_micro_batch=8, accum_steps=1)
    )


def _run_dir(out_dir):
    (run,) = sorted(p for p in out_dir.iterdir() if p.is_dir())
    return run


def _records(run):
    return [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text().splitlines()]


FV = "faster_vit_2_224"
FV_NARROW = dict(dim=16, in_dim=8, depths=(1, 1, 2, 1))
FV_HEADS = {"official": (2, 4, 8, 16), "tpu": (1, 1, 1, 1)}


class _Built(Exception):
    """Stops a run right after the model's head configuration is chosen."""


def _fv_spec(built, stop=False):
    """The port's FasterViT spec with a narrow builder that records the
    head_config it is given (and, with ``stop``, ends the run there)."""
    def builder(num_classes, dtype=torch.bfloat16, generator=None, head_config="tpu", **kw):
        built.append(head_config)
        if stop:
            raise _Built(head_config)
        return FasterViT(num_classes, num_heads=FV_HEADS[head_config],
                         official=head_config == "official", dtype=dtype, generator=generator,
                         **FV_NARROW)

    return _recipe(dataclasses.replace(port_model_spec(FV), builder=builder))


def _fv_config(path, root, out_dir, mode_block=None, **training):
    block = {"output_dir": str(out_dir),
             "training": {"epochs": 1, "batch_size": 8, "num_workers": 0, **training}}
    block.update(mode_block or {})
    cfg = {"seed": 7, "device": "cpu", "data": {"root": str(root), "num_classes": 2,
                                                 "img_size": 224, "test_split": "test"},
           "models": {FV: block}, "selection": [FV]}
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_fastervit_trains_and_hands_over_to_inference(tiny_image_tree, tmp_path, monkeypatch,
                                                      capsys):
    built = []
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: _fv_spec(built))
    before = (window_attn.window_attention.launches, window_attn.window_attention_bwd.launches)
    result = port_orch.orchestrate(_fv_config(tmp_path / "t.yaml", tiny_image_tree,
                                              tmp_path / "fv"), mode="training")[FV]
    assert not result.interrupted and result.epochs_run == 1
    assert built == ["tpu"]
    run = _run_dir(tmp_path / "fv")
    log = (run / "logs" / "train.log").read_text()
    for line in ("→ training faster_vit_2_224", "warmup 1/1: loss=", "warmup val acc=",
                 "fine-tune: epochs=1 batch=8 (micro 8 × accum 1)", "epoch 1/1: loss="):
        assert line in log, line
    (record,) = _records(run)
    assert record["epoch"] == 1 and np.isfinite(record["train_loss"]) and record["train_loss"] > 0
    ckpts = run / "checkpoints"
    assert (ckpts / "latest.ckpt").exists() and (ckpts / "best.ckpt").exists()
    state = torch.load(ckpts / f"{FV}.pth", weights_only=True)
    assert "levels.2.blocks.0.attn.rel_bias" in state  # the tpu configuration's export
    # the CPU ran K5's plain versions: no launch of either kernel
    assert (window_attn.window_attention.launches,
            window_attn.window_attention_bwd.launches) == before

    capsys.readouterr()
    cfg = _fv_config(tmp_path / "i.yaml", tiny_image_tree, tmp_path / "fv",
                     mode_block={"inference": {"weights": "auto", "batch_size": 8,
                                               "num_workers": 0, "img_size": 224}})
    res = port_orch.orchestrate(cfg, mode="inference")[FV]
    assert built == ["tpu", "tpu"]
    assert "head_config='tpu'" in "".join(capsys.readouterr().out.split())
    assert res.probs.shape == (12, 2) and np.isfinite(res.probs).all()


@pytest.mark.parametrize("source,pinned,want", [
    ("official", None, "official"), ("tpu", None, "tpu"), ("tpu", "official", "official"),
])
def test_fastervit_init_weights_pick_the_head_configuration(tiny_image_tree, tmp_path,
                                                            monkeypatch, source, pinned, want):
    weights = tmp_path / "init.pth"
    model = FasterViT(2, num_heads=FV_HEADS[source], official=source == "official", **FV_NARROW)
    torch.save(model.state_dict(), weights)
    built = []
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: _fv_spec(built, stop=True))
    cfg = _fv_config(tmp_path / "p.yaml", tiny_image_tree, tmp_path / "p",
                     init_weights=str(weights))
    if pinned:
        data = yaml.safe_load(cfg.read_text())
        data["models"][FV]["head_config"] = pinned
        cfg.write_text(yaml.safe_dump(data))
    with pytest.raises(_Built):
        port_orch.orchestrate(cfg, mode="training")
    assert built == [want]
