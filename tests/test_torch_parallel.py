"""Data parallelism across two real processes over gloo on the CPU
(``deepfakedetection_tpu_torch/parallel/{mesh,multihost}.py``).

The workers are this file run as a module, two at a time, each on two torch
threads and a free local port::

    python -m tests.test_torch_parallel <role> <rank> <port> <workdir>

Role ``steps`` (its rank 0 and 1 against one process in this one):

(a) a narrow EfficientNet-B3 in f32 (width 0.25, depth 0.5, 32 px) with
    BatchNorm in training, class weights, mixup and CutMix, the shear
    rotation, colour jitter, erasing, dropout and drop-path on and gradient
    clipping takes 3 steps of a global batch of 8, 4 rows a rank. Params and
    BatchNorm running statistics are bit-equal across the ranks, and both
    hold to one process's 3 steps on the same global batches: the loss to
    1e-5 relative, the running statistics to 1e-5 absolute, no parameter
    beyond 2.01 lr and at most 1% beyond 0.1 lr (the bounds of
    ``tests/test_torch_train_step.py``'s f32 step against JAX; measured
    loss 3.7e-6, statistics 5.2e-6, parameters 1.19 lr at most and 0.06%
    beyond 0.1 lr: Adam moves a weight whose near-zero gradient changes
    sign with the summation order by 2 lr);
(b) one such step of a narrow FasterViT (tpu heads, 224 px, a global batch
    of 4, drop-path 0.2): its final norm is ``batch_norm_train``'s two
    passes, and in bf16 its attentions take K5's plain forward and backward.
    f32 to the bounds of (a) (measured loss 8.6e-8, statistics 1.7e-6,
    parameters 0.11 lr); bf16 to ``test_torch_train_step``'s bf16 bounds
    (the loss to 5e-2, no parameter beyond 2.01 lr, at most 25% beyond 0.5
    lr; measured loss 0, 2.00 lr, 0.03%);
(c) the gate's teeth: (a) again with BatchNorm's statistics left per rank
    (``mesh.sum_over_data`` the identity) misses (a)'s bounds (measured
    loss 0.10, statistics 0.31, 87% of the parameters beyond 0.1 lr);
(d) a ragged split (13 images, a global batch of 4: 7 and 6 rows) through
    ``collect_probs``: both ranks hold the same probabilities and targets,
    the split's in order, as one process (measured bit-equal; held to
    1e-6);
(e) the JAX package's case: from the same weights (a JAX init carried over
    by ``runtime/convert.py``), f32, augmentation and dropout off, the
    two-process port step on a global batch of 8 (2 rows masked) against
    the JAX train step on a ``data=2`` mesh of the 8 CPU devices, run here,
    to ``test_torch_train_step``'s f32 bounds (measured loss 7.4e-7,
    statistics 1.2e-7, parameters 1.93 lr and 0.14% beyond 0.1 lr); and
    ``make_mesh`` refusing a data axis of 1 at world 2.

Role ``orchestrate``: ``orchestrate(mode="training")`` with two ranks that
join the group themselves from torchrun's environment (a narrow B3, bf16,
mixup, ``async_checkpoint``, a precise-BN pass and weight EMA, two
epochs), then a resume for a third epoch, then ``orchestrate(mode=
"inference")`` and its int8 eval: one ``metrics.jsonl`` writer,
``train.log.p1``, one run dir, a complete ``latest.ckpt`` with no ``.tmp``
left, params bit-equal across the ranks and equal to ``latest.ckpt``'s, the
same test probabilities on both ranks, and the int8 job's scales and
probabilities those of one process (every rank calibrates on the split's
first batches).
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds a pair of workers may take (about 20 s each here)

B3_NARROW = dict(width_coefficient=0.25, depth_coefficient=0.5, native_resolution=32)
FV_NARROW = dict(dim=16, in_dim=8, depths=(1, 1, 2, 1))
GLOBAL_B, STEPS, LR = 8, 3, 1e-4
AUG = {"train_random_rotation": True, "train_color_jitter": True, "train_random_erasing": True}
CLASS_WEIGHTS = (0.7, 1.6)
SPLIT = {"train": (8, 8), "val": (6, 6), "test": (7, 6)}  # images per class
# (a)'s bounds (tests/test_torch_train_step.py's f32 ones) and the bf16 ones
F32 = {"loss_rel": 1e-5, "stats_gap": 1e-5, "worst_lr": 2.01, "share_0.1lr": 1e-2}
BF16 = {"loss_rel": 5e-2, "worst_lr": 2.01, "share_0.5lr": 0.25}


# ---------------------------------------------------------------------------
# what a rank and one process both run
# ---------------------------------------------------------------------------


def _b3(dtype=torch.float32, **rates):
    from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet

    return EfficientNet(num_classes=2, dtype=dtype, generator=torch.Generator().manual_seed(0),
                        **B3_NARROW, **rates).train()


def _train_plan():
    from deepfakedetection_tpu_torch.data.transforms import build_train_plan
    from deepfakedetection_tpu_torch.registry import get_model_spec

    recipe = get_model_spec("efficientnet_b3").recipe
    return build_train_plan(32, AUG, recipe_defaults=recipe.default_train_toggles,
                            jitter_params=recipe.color_jitter)


def b3_steps(rows: slice) -> dict:
    """(a): 3 augmented, mixed steps of the global batches' ``rows``."""
    from deepfakedetection_tpu_torch.data.augment import augment_batch
    from deepfakedetection_tpu_torch.runtime.seeding import fold_in, fold_in_numpy, root_generator
    from deepfakedetection_tpu_torch.train.mixup import MixupSpec, sample_mix
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    model = _b3(dropout_rate=0.3, drop_connect_rate=0.3)
    opt = PhaseOptimizer(list(model.named_parameters()), lr=LR, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"), grad_clip_norm=1.0)
    plan, root = _train_plan(), root_generator(3)
    spec = MixupSpec(mixup_alpha=0.4, cutmix_alpha=1.0)
    rng = np.random.default_rng(11)
    losses = []
    for i in range(STEPS):
        S = plan.host_canvas_size
        canvases = torch.from_numpy(rng.integers(0, 256, (GLOBAL_B, S, S, 3), dtype=np.uint8))
        labels = torch.from_numpy(rng.integers(0, 2, GLOBAL_B))
        x = augment_batch(canvases[rows], fold_in(root, i), plan)
        mix = sample_mix(fold_in_numpy(root, 7, i), spec, 32, 32)
        out = train_step(model, opt, x, labels[rows], torch.ones(x.shape[0], dtype=torch.bool),
                         fold_in(root, 8, i), class_weights=torch.tensor(CLASS_WEIGHTS), mix=mix)
        losses.append(float(out["loss"]))
    return {"losses": losses, "state": model.state_dict()}


def fv_step(rows: slice, dtype: torch.dtype) -> dict:
    """(b): one narrow FasterViT step of a global batch of 4's ``rows``."""
    from deepfakedetection_tpu_torch.models.fastervit import FasterViT, tpu_heads
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    model = FasterViT(2, num_heads=tpu_heads(16, (2, 4, 8, 16)), official=False,
                      drop_path_rate=0.2, dtype=dtype, generator=torch.Generator().manual_seed(1),
                      **FV_NARROW).train()
    opt = PhaseOptimizer(list(model.named_parameters()), lr=LR, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"))
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 3, 224, 224, generator=g).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    labels = torch.tensor([0, 1, 1, 0])
    out = train_step(model, opt, x[rows], labels[rows], torch.ones(4, dtype=torch.bool)[rows],
                     torch.Generator().manual_seed(3))
    return {"losses": [float(out["loss"])], "state": model.state_dict()}


def eval_rows(data: Path) -> dict:
    """(d): the test split's probabilities and targets through ``collect_probs``."""
    from deepfakedetection_tpu_torch.data.folder import scan_image_folder
    from deepfakedetection_tpu_torch.data.pipeline import DeviceStager, make_eval_loader
    from deepfakedetection_tpu_torch.data.transforms import build_eval_plan
    from deepfakedetection_tpu_torch.evaluate.job import collect_probs, make_eval_step

    plan = build_eval_plan(32, {})
    loader = make_eval_loader(scan_image_folder(data / "test"), plan, batch_size=4)
    probs, targets, _ = collect_probs(make_eval_step(_b3().eval()), loader, plan,
                                      DeviceStager(torch.device("cpu")), torch.float32)
    return {"probs": torch.from_numpy(probs), "targets": torch.from_numpy(targets),
            "batches": len(loader)}


def jax_case_step(work: Path, rows: slice) -> dict:
    """(e): the port's fine-tune step from the JAX init in ``work``."""
    from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    model = _b3(dropout_rate=0.0, drop_connect_rate=0.0)
    load_state_dict_strict(model, torch.load(work / "jax_init.pt", weights_only=True))
    batch = np.load(work / "jax_batch.npz")
    opt = PhaseOptimizer(list(model.named_parameters()), lr=LR, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"))
    x = torch.from_numpy(batch["x"]).permute(0, 3, 1, 2)
    out = train_step(model, opt, x[rows], torch.from_numpy(batch["labels"]).long()[rows],
                     torch.from_numpy(batch["mask"])[rows], None)
    return {"losses": [float(out["loss"])], "state": model.state_dict()}


def readings(ref: dict, got: dict) -> dict[str, float]:
    """The losses' largest relative gap, the running statistics' largest
    absolute gap, and the parameters' in units of lr (largest, share beyond
    0.1 and 0.5 lr)."""
    loss = max(abs(a - b) / abs(a) for a, b in zip(ref["losses"], got["losses"]))
    keys = [k for k in ref["state"] if "num_batches" not in k]
    stats = [k for k in keys if "running" in k]
    units = torch.cat([((got["state"][k].float() - ref["state"][k].float()).abs() / LR).flatten()
                       for k in keys if k not in stats])
    gap = max((float((got["state"][k] - ref["state"][k]).abs().max()) for k in stats),
              default=0.0)
    return {"loss_rel": loss, "stats_gap": gap, "worst_lr": float(units.max()),
            "share_0.1lr": float((units > 0.1).float().mean()),
            "share_0.5lr": float((units > 0.5).float().mean())}


def over(reading: dict, bounds: dict) -> dict:
    return {k: (reading[k], b) for k, b in bounds.items() if not reading[k] <= b}


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------


def _rows(rank: int, n: int, world: int = 2) -> slice:
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def _steps_worker(rank: int, port: int, work: Path) -> None:
    import torch.distributed as dist

    from deepfakedetection_tpu_torch.parallel import mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        out = {"b3": b3_steps(_rows(rank, GLOBAL_B)),
               "fv_f32": fv_step(_rows(rank, 4), torch.float32),
               "fv_bf16": fv_step(_rows(rank, 4), torch.bfloat16),
               "eval": eval_rows(work / "data"),
               "jax": jax_case_step(work, _rows(rank, GLOBAL_B))}
        try:
            mesh.make_mesh(1, 1)
        except ValueError as e:
            out["idle_refusal"] = str(e)
        real = mesh.sum_over_data
        mesh.sum_over_data = lambda t: t  # BatchNorm statistics per rank
        try:
            out["b3_per_rank_bn"] = b3_steps(_rows(rank, GLOBAL_B))
        finally:
            mesh.sum_over_data = real
        torch.save(out, work / f"steps.{rank}.pt")
    finally:
        dist.destroy_process_group()


def narrow_spec():
    """The B3 spec with a narrow builder and a fine-tune batch of 8 (8 x 1)."""
    from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
    from deepfakedetection_tpu_torch.registry import get_model_spec

    spec = get_model_spec("efficientnet_b3")
    return dataclasses.replace(
        spec,
        recipe=dataclasses.replace(spec.recipe, finetune_micro_batch=8, accum_steps=1),
        builder=lambda num_classes, dtype=torch.bfloat16, generator=None, **kw: EfficientNet(
            num_classes=num_classes, dtype=dtype, generator=generator, **B3_NARROW),
    )


def _config(work: Path, epochs: int) -> Path:
    import yaml

    cfg = {"seed": 7, "device": "cpu", "mesh": {"data": -1, "model": 1},
           "data": {"root": str(work / "data"), "num_classes": 2, "img_size": 32},
           "models": {"efficientnet_b3": {
               "output_dir": str(work / "runs"),
               "training": {"epochs": epochs, "batch_size": 8, "num_workers": 0,
                            "resume": "continue", "async_checkpoint": True,
                            "mixup_alpha": 0.4, "bn_recalc_batches": 1, "ema_decay": 0.9},
               "inference": {"weights": "auto", "batch_size": 4, "num_workers": 0}}},
           "selection": ["efficientnet_b3"]}
    path = work / f"train_{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def int8_config(work: Path, out: str) -> Path:
    """The int8 eval of the trained ``.pth`` into ``work / out``."""
    import yaml

    (weights,) = work.glob("runs/*/checkpoints/efficientnet_b3.pth")
    cfg = {"seed": 7, "device": "cpu",
           "data": {"root": str(work / "data"), "num_classes": 2, "img_size": 32},
           "models": {"efficientnet_b3": {
               "output_dir": str(work / out),
               "inference": {"weights": str(weights), "precision": "int8", "batch_size": 4,
                             "num_workers": 0}}},
           "selection": ["efficientnet_b3"]}
    path = work / f"{out}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _orchestrate_worker(rank: int, port: int, work: Path) -> None:
    import torch.distributed as dist

    import deepfakedetection_tpu_torch.orchestrator as orch
    import deepfakedetection_tpu_torch.train.loop as loop

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    orch.get_model_spec = lambda name: narrow_spec()
    models = []
    step = loop.train_step

    def noting_step(model, *args, **kwargs):
        models.append(model)
        return step(model, *args, **kwargs)

    loop.train_step = noting_step
    try:
        first = orch.orchestrate(_config(work, 2), mode="training")["efficientnet_b3"]
        resumed = orch.orchestrate(_config(work, 3), mode="training")["efficientnet_b3"]
        evaluated = orch.orchestrate(_config(work, 3), mode="inference")["efficientnet_b3"]
        int8 = orch.orchestrate(int8_config(work, "int8"), mode="inference")["efficientnet_b3"]
        torch.save({"epochs_run": [first.epochs_run, resumed.epochs_run],
                    "losses": [first.final_train_loss, resumed.final_train_loss],
                    "state": models[-1].state_dict(),
                    "probs": torch.from_numpy(evaluated.probs),
                    "targets": torch.from_numpy(evaluated.targets),
                    "int8_probs": torch.from_numpy(int8.probs), "int8_scales": int8.int8_scales},
                   work / f"orchestrate.{rank}.pt")
    finally:
        dist.destroy_process_group()


ROLES = {"steps": _steps_worker, "orchestrate": _orchestrate_worker}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_pair(role: str, work: Path) -> list[dict]:
    """Both ranks of ``role`` in two processes; their outputs by rank."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "DFD_MULTIHOST")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_parallel", role,
                               str(rank), str(port), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{role} rank {rank} failed:\n{log[-4000:]}"
    return [torch.load(work / f"{role}.{rank}.pt", weights_only=False) for rank in range(2)]


def _write_tree(root: Path) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, counts in SPLIT.items():
        for cls, n in zip(("fake", "real"), counts):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                arr = rng.normal(60 if cls == "fake" else 180, 40, (40, 44, 3))
                Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(d / f"i{i:02d}.jpg")


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """The JAX init (as a port state dict) and batch in a work dir, and the
    JAX step on a data=2 mesh: (work, its loss, its state dict)."""
    import jax
    import jax.numpy as jnp

    from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
    from deepfakedetection_tpu.parallel.mesh import make_mesh, replicated
    from deepfakedetection_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from deepfakedetection_tpu.runtime.torch_convert import export_torch_state_dict
    from deepfakedetection_tpu.train import optim as jax_optim
    from deepfakedetection_tpu.train import steps as jax_steps
    from deepfakedetection_tpu_torch.runtime.convert import state_dict_from_jax

    work = tmp_path_factory.mktemp("parallel")
    _write_tree(work / "data")
    narrow = dict(num_classes=2, dtype=jnp.float32, dropout_rate=0.0, drop_connect_rate=0.0,
                  **B3_NARROW)
    params, stats = jax_steps.init_model_variables(JaxEfficientNet(**narrow), jax.random.key(0),
                                                   (1, 32, 32, 3))
    tree = {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}
    torch.save(state_dict_from_jax(tree, "efficientnet"), work / "jax_init.pt")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(GLOBAL_B, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 2, GLOBAL_B).astype(np.int32)
    mask = np.ones(GLOBAL_B, bool)
    mask[-2:] = False  # padding rows, all on rank 1
    np.savez(work / "jax_batch.npz", x=x, labels=labels, mask=mask)

    mesh = make_mesh(data=2, model=1)
    tx, _, _ = jax_optim.make_phase_optimizer(params, lr=LR, weight_decay=5e-2,
                                              trainable=jax_optim.unfreeze_predicate("all"))
    state = jax.device_put(jax_steps.TrainState(params=params, batch_stats=stats,
                                                opt_state=tx.init(params),
                                                step=jnp.asarray(0, jnp.int32)),
                           replicated(mesh))
    step = jax_steps.make_train_step_fn(JaxEfficientNet(**narrow), tx)
    with jax.default_matmul_precision("highest"):
        new, metrics = jax.jit(step)(state, *jax_shard_batch(mesh, (x, labels, mask)),
                                     jax.random.key(5))
    out = {"params": jax.device_get(new.params), "batch_stats": jax.device_get(new.batch_stats)}
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(out, "efficientnet").items()}
    return work, float(metrics["loss"]), sd


@pytest.fixture(scope="module")
def steps(jax_case):
    work = jax_case[0]
    return run_pair("steps", work)


@pytest.fixture(scope="module")
def one_process(jax_case):
    """This process's runs on the global batches (no process group)."""
    return {"b3": b3_steps(slice(None)), "fv_f32": fv_step(slice(None), torch.float32),
            "fv_bf16": fv_step(slice(None), torch.bfloat16),
            "eval": eval_rows(jax_case[0] / "data")}


def _bit_equal(a: dict, b: dict) -> list[str]:
    return [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("case", ["b3", "fv_f32", "fv_bf16", "jax"])
def test_the_ranks_end_bit_equal(steps, case):
    assert _bit_equal(steps[0][case]["state"], steps[1][case]["state"]) == []
    assert steps[0][case]["losses"] == steps[1][case]["losses"]


@pytest.mark.parametrize("case", ["b3", "fv_f32"])
def test_two_ranks_take_the_one_process_step(steps, one_process, case):
    reading = readings(one_process[case], steps[0][case])
    assert over(reading, F32) == {}, reading


def test_bf16_fastervit_ranks_take_the_one_process_step(steps, one_process):
    reading = readings(one_process["fv_bf16"], steps[0]["fv_bf16"])
    assert over(reading, BF16) == {}, reading


def test_per_rank_batchnorm_fails_the_gate(steps, one_process):
    reading = readings(one_process["b3"], steps[0]["b3_per_rank_bn"])
    assert over(reading, F32), reading
    other = readings(steps[0]["b3_per_rank_bn"], steps[1]["b3_per_rank_bn"])
    assert other["stats_gap"] > 0.0  # the ranks' statistics part


def test_a_ragged_split_gathers_in_order(steps, one_process):
    ref = one_process["eval"]
    assert [s["eval"]["batches"] for s in steps] == [4, 4] and ref["batches"] == 4
    for rank in range(2):
        got = steps[rank]["eval"]
        assert torch.equal(got["targets"], ref["targets"]) and len(got["targets"]) == 13
        assert torch.equal(got["probs"], steps[0]["eval"]["probs"])
        torch.testing.assert_close(got["probs"], ref["probs"], rtol=0, atol=1e-6)


def test_two_ranks_take_the_jax_step_on_a_data_2_mesh(jax_case, steps):
    _, j_loss, j_sd = jax_case
    reading = readings({"losses": [j_loss], "state": j_sd}, steps[0]["jax"])
    assert over(reading, F32) == {}, reading


def test_a_data_axis_smaller_than_the_world_is_refused(steps):
    assert "would leave 1 of 2 processes idle" in steps[0]["idle_refusal"]


@pytest.fixture(scope="module")
def orchestrated(jax_case):
    work = jax_case[0]
    return work, run_pair("orchestrate", work)


def test_orchestrate_writes_once_and_resumes(orchestrated):
    work, ranks = orchestrated
    (run,) = [p for p in (work / "runs").iterdir() if (p / "checkpoints" / "latest.ckpt").exists()]
    logs, ckpts = run / "logs", run / "checkpoints"
    records = [json.loads(x) for x in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2, 3]  # one writer
    assert (logs / "train.log").is_file() and (logs / "train.log.p1").is_file()
    assert "mesh data=2 model=1" in (logs / "train.log.p1").read_text()
    assert sorted(p.name for p in ckpts.iterdir()) == [
        "best.ckpt", "efficientnet_b3.pth", "latest.ckpt"]  # no .tmp left
    latest = torch.load(ckpts / "latest.ckpt", weights_only=True)
    assert latest["counters"]["epoch"] == 2 and latest["optimizer"]["count"] == 6
    assert [r["epochs_run"] for r in ranks] == [[2, 1], [2, 1]]
    assert all(np.isfinite(r["losses"]).all() for r in ranks)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert _bit_equal(ranks[0]["state"], ranks[1]["state"]) == []
    assert _bit_equal(latest["model"], ranks[0]["state"]) == []


def test_orchestrate_inference_gathers_the_split(orchestrated):
    work, ranks = orchestrated
    assert len(ranks[0]["targets"]) == sum(SPLIT["test"])
    assert torch.equal(ranks[0]["probs"], ranks[1]["probs"])
    assert torch.equal(ranks[0]["targets"], ranks[1]["targets"])
    (run,) = [p for p in (work / "runs").iterdir() if (p / "logs" / "inference.log").exists()]
    assert len((run / "logs" / "metrics.jsonl").read_text().splitlines()) == 1
    assert (run / "logs" / "inference.log.p1").is_file()


def test_two_ranks_calibrate_int8_as_one_process(orchestrated, monkeypatch):
    """Every rank calibrates on the split's first batches, as one process
    does: the same scales, and the same int8 probabilities."""
    import deepfakedetection_tpu_torch.orchestrator as orch

    work, ranks = orchestrated
    monkeypatch.setattr(orch, "get_model_spec", lambda name: narrow_spec())
    one = orch.orchestrate(int8_config(work, "int8_one"), mode="inference")["efficientnet_b3"]
    assert ranks[0]["int8_scales"].keys() == one.int8_scales.keys() and one.int8_scales
    for rank in range(2):
        assert all(np.array_equal(np.asarray(ranks[rank]["int8_scales"][k]),
                                  np.asarray(v)) for k, v in one.int8_scales.items())
        torch.testing.assert_close(ranks[rank]["int8_probs"], torch.from_numpy(one.probs),
                                   rtol=0, atol=1e-6)
    assert torch.equal(ranks[0]["int8_probs"], ranks[1]["int8_probs"])


if __name__ == "__main__":
    role, rank, port, work = sys.argv[1:]
    torch.set_num_threads(2)
    ROLES[role](int(rank), int(port), Path(work))
