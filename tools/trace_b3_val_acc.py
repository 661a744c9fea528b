"""Traces B3's val accuracy in ``chip_smoke.py`` phase 4 through both packages on the CPU.

Phase 4 trains the full-width B3 with the shipped recipe over a seeded
two-class JPEG tree (``chip_smoke.write_jpeg_tree``, seed 5: 1,024 train and
128 val images whose classes differ in mean intensity) and sees val accuracy
0.5000 after the warmup and every epoch. This script runs the same recipe,
tree, transforms and step counts (16 warmup steps at batch 64, then 8
fine-tune steps at 32 x 4 = 128 an epoch, two epochs) through the JAX
package's ``orchestrate(mode="training")`` and the port's, each on a narrow
B3 (width 0.25, depth 0.5) at 64 px, both from one numpy-seeded weight tree
handed to both as ``training.init_weights``. Then, for the weights each
package exported, it reads with the port's f32 model on the CPU:

- every BatchNorm's running statistics, the two packages against each other;
- how far the running means moved from their init (0) toward the batch
  means of the train split under the exported weights ("moved share", 1 -
  ||running - batch|| / ||batch||: 1 - 0.99^steps for a stationary batch
  mean);
- the val accuracy with the running statistics (what the trainer logs) and
  with each BatchNorm's statistics recalibrated on eight train batches
  (``train.steps.recalibrate_bn``, what ``training.bn_recalc_batches`` does).

Run from the repository root::

    JAX_PLATFORMS=cpu python tools/trace_b3_val_acc.py [--out DIR]

It prints one JSON object (also written to ``DIR/trace.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

NARROW = dict(width_coefficient=0.25, depth_coefficient=0.5, native_resolution=64)
SIZE = 64


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seeded_init(path: Path) -> None:
    """A numpy-seeded narrow B3 tree (kernels N(0, 2/fan_in), dense N(0,
    0.01), zero biases, identity BatchNorms) exported to a torch ``.pth``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from deepfakedetection_tpu.models.efficientnet import EfficientNet
    from deepfakedetection_tpu.runtime.torch_convert import export_torch_state_dict

    model = EfficientNet(num_classes=2, dtype=jnp.float32, **NARROW)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False), jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(0)

    def fill(p, leaf):
        name, shape = p[-1].key, leaf.shape
        if name == "kernel":
            v = rng.normal(size=shape) * np.sqrt((1.0 if len(shape) == 2 else 2.0)
                                                 / np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = np.ones(shape)
        else:
            v = np.zeros(shape)
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    sd = export_torch_state_dict({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                                 "efficientnet")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)


def config(path: Path, data: Path, out: Path, init: Path, smoke) -> Path:
    import yaml

    cfg = {"seed": 1, "device": "cpu",
           "data": {"root": str(data), "train_split": "train", "val_split": "val",
                    "test_split": "test", "num_classes": 2, "img_size": SIZE},
           "models": {"efficientnet_b3": {
               "output_dir": str(out),
               "transforms": {"train": smoke.TRAIN_TF, "eval": smoke.EVAL_TF},
               "training": {"epochs": 2, "batch_size": 64, "num_workers": 8, "resume": False,
                            "init_weights": str(init)}}},
           "selection": ["efficientnet_b3"]}
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_both(work: Path, data: Path, init: Path, smoke) -> dict[str, Path]:
    import jax.numpy as jnp
    import torch

    import deepfakedetection_tpu.orchestrator as jax_orch
    import deepfakedetection_tpu_torch.orchestrator as port_orch
    from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxB3
    from deepfakedetection_tpu.registry import get_model_spec as jax_spec
    from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet as PortB3
    from deepfakedetection_tpu_torch.registry import get_model_spec as port_spec

    jax_orch.get_model_spec = lambda name: dataclasses.replace(
        jax_spec(name), builder=lambda num_classes, dtype=jnp.bfloat16, **kw: JaxB3(
            num_classes=num_classes, dtype=dtype, **NARROW))
    port_orch.get_model_spec = lambda name: dataclasses.replace(
        port_spec(name), builder=lambda num_classes, dtype=torch.bfloat16, generator=None, **kw:
        PortB3(num_classes=num_classes, dtype=dtype, generator=generator, **NARROW))
    runs = {}
    for name, orch in (("jax", jax_orch), ("port", port_orch)):
        orch.orchestrate(config(work / f"{name}.yaml", data, work / name, init, smoke),
                         mode="training")
        (runs[name],) = sorted(p for p in (work / name).iterdir() if p.is_dir())
    return runs


def logged(run: Path) -> dict:
    text = (run / "logs" / "train.log").read_text()
    records = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    return {"warmup_loss": [float(x) for x in re.findall(r"warmup \d+/\d+: loss=(\S+) ", text)],
            "warmup_val_acc": [float(x) for x in re.findall(r"warmup val acc=(\S+)", text)],
            "epoch_loss": [r["train_loss"] for r in records],
            "epoch_val_acc": [r["accuracy"] for r in records],
            "best_epoch": [r["epoch"] for r in records if r["best"]][-1]}


def exported(run: Path, family_is_jax: bool):
    import torch

    path = run / "checkpoints" / "efficientnet_b3.pth"
    if not family_is_jax:
        return torch.load(path, weights_only=True)
    import numpy as np
    from flax import serialization

    from deepfakedetection_tpu.runtime.torch_convert import export_torch_state_dict

    tree = serialization.msgpack_restore(bytearray(path.read_bytes()))
    return {k: torch.from_numpy(np.array(v)) for k, v in
            export_torch_state_dict(tree, "efficientnet").items()}


def readings(states: dict, data: Path, smoke) -> dict:
    import torch

    from deepfakedetection_tpu_torch.data.augment import normalize_batch
    from deepfakedetection_tpu_torch.data.pipeline import (
        build_eval_plan,
        make_eval_loader,
        scan_image_folder,
    )
    from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
    from deepfakedetection_tpu_torch.train.steps import recalibrate_bn

    plan = build_eval_plan(SIZE, smoke.EVAL_TF, trainer_val=True)

    def images(split, n_batches):
        loader = make_eval_loader(scan_image_folder(data / split), plan, batch_size=64)
        out = []
        for i, batch in enumerate(loader):
            if i == n_batches:
                break
            out.append((normalize_batch(torch.from_numpy(batch.images), plan),
                        torch.from_numpy(batch.labels), torch.from_numpy(batch.mask)))
        return out

    train, val = images("train", 8), images("val", 10**6)

    def model_of(state):
        model = EfficientNet(num_classes=2, dtype=torch.float32, dropout_rate=0.0,
                             drop_connect_rate=0.0, **NARROW)
        model.load_state_dict(state)
        return model.eval()

    def val_acc(model):
        right = total = 0
        with torch.no_grad():
            for x, y, m in val:
                right += int((model(x).argmax(-1) == y)[m].sum())
                total += int(m.sum())
        return right / total

    out = {}
    for name, state in states.items():
        model = model_of(state)
        acc_running = val_acc(model)
        recal = model_of(state)
        recalibrate_bn(recal, (x for x, _, _ in train), lambda i: None)
        bns = [k[: -len("running_mean")] for k in state if k.endswith("running_mean")]
        rsd = recal.state_dict()
        moved = [1.0 - float((state[b + "running_mean"] - rsd[b + "running_mean"]).norm()
                             / rsd[b + "running_mean"].norm()) for b in bns]
        out[name] = {"val_acc_running_stats": acc_running, "val_acc_recalibrated": val_acc(recal),
                     "moved_share_median": sorted(moved)[len(moved) // 2],
                     "moved_share_min": min(moved), "moved_share_max": max(moved)}
    a, b = states["jax"], states["port"]
    gaps = {k: float((a[k] - b[k]).abs().max() / a[k].abs().max().clamp_min(1e-12))
            for k in a if "running" in k}
    worst = max(gaps, key=gaps.get)
    out["running_stats_jax_vs_port"] = {"max_rel_gap": gaps[worst], "where": worst,
                                        "median_rel_gap": sorted(gaps.values())[len(gaps) // 2]}
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=REPO / "build" / "trace_b3_val_acc")
    args = parser.parse_args()
    smoke = _chip_smoke()
    work = args.out
    data = work / "data"
    if not (data / "train").is_dir():
        smoke.write_jpeg_tree(data, smoke.TRAIN_SPLITS, seed=5)
    init = work / "init.pth"
    seeded_init(init)
    for name in ("jax", "port"):
        import shutil

        shutil.rmtree(work / name, ignore_errors=True)
    runs = run_both(work, data, init, smoke)
    result = {name: logged(run) for name, run in runs.items()}
    states = {name: exported(run, name == "jax") for name, run in runs.items()}
    result["readings"] = readings(states, data, smoke)
    text = json.dumps(result, indent=1)
    (work / "trace.json").write_text(text)
    print(text)


if __name__ == "__main__":
    main()
