"""The model axis of the mesh (``deepfakedetection_tpu_torch/parallel/mesh.py``
with ``model > 1``, ``parallel/tensor.py``) against the JAX package's.

(a) ``make_mesh`` places every rank of a world of 8 where the JAX
    ``make_mesh`` places device r of the 8 CPU devices, for (-1, 2), (4, 2)
    and (2, 4): the (data, model) indices, the data group (the ranks of one
    model index) and the model group (of one data index); and refuses a
    model axis that does not divide the world or a mesh that leaves ranks
    idle or exceeds them.
(b) ``param_specs`` shards exactly the parameters that the JAX
    ``param_shardings`` shards, name by name through the converter's name
    map, on a narrow EfficientNet-B3, a narrow FasterViT (official) and the
    full-width EfficientFormerV2-S1, at model axes of 2 and 4 (the JAX tree's
    shapes from ``jax.eval_shape``).
(c) Over gloo on the CPU, two launches of this file as a worker module at
    once, ``python -m tests.test_torch_model_axis <world> <model> <rank>
    <port> <workdir>``: 4 ranks at data 2 x model 2 and 2 ranks at data 2 x
    model 1. Each runs ``tests/test_torch_parallel.py``'s three f32 B3 steps
    (BatchNorm in training, augmentation, mixup, dropout, drop-path,
    clipping) on its data index's rows of the global batch; every rank of
    the 4 ends bit-equal to its data index's rank of the 2 and to every
    other rank, and all hold to one process's steps under that file's f32
    gates (loss 1e-5 relative, statistics 1e-5, parameters 2.01 lr and 1%
    beyond 0.1 lr; measured: the 4 bit-equal to the 2, against one process
    loss 3.7e-6, statistics 5.2e-6, parameters 1.19 lr and 0.06% beyond
    0.1 lr, as the 2 ranks of that file read).
(d) The 4 ranks make ``tests/util.py``'s TinyCNN column-parallel with
    ``shard_parameters`` (conv1, conv2 and the head: every kernel's output
    divides by 2) and take one SGD step of a global batch of 8, 4 rows a
    data index, from the JAX init: the loss and the gathered parameters and
    statistics against the JAX tensor-parallel step on the 4 x 2 mesh of
    ``tests/test_parallel.py:48-80`` from the same weights and batch (loss
    1e-5 relative; parameters and statistics within ``TP_ATOL``, a few f32
    roundings of summation order; measured loss equal, 1.2e-7 at most).
(e) ``orchestrate(mode="training")`` with ``mesh: {data: -1, model: 2}``
    over the 4 ranks logs the losses of the 2-rank run at ``{data: -1,
    model: 1}``: the same ``metrics.jsonl`` records' train losses and
    validation accuracies, one writer, and the eval passes' gather takes
    each data index's rows once.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300  # seconds both launches may take
TINY_LR = 0.5  # SGD: the update is the gradient times this
TINY_B = 8
TP_ATOL = 1e-6


class TinyCNN(nn.Module):
    """``tests/util.py``'s TinyCNN: two 3x3 stride-2 convs with flax's SAME
    padding, BatchNorm in training (the global batch's statistics), ReLU, a
    mean pool and a dense head, in f32 on NCHW."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, 2)
        self.bn1 = nn.BatchNorm2d(8)
        self.conv2 = nn.Conv2d(8, 16, 3, 2)
        self.head = nn.Linear(16, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from deepfakedetection_tpu_torch.models.common import batch_norm_train

        x = self.conv1(F.pad(x, (0, 1, 0, 1)))
        x = F.relu(batch_norm_train(self.bn1, x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        x = F.relu(self.conv2(F.pad(x, (0, 1, 0, 1))))
        return self.head(x.mean(dim=(2, 3)))


def tiny_state_from_flax(params: dict, stats: dict) -> dict[str, torch.Tensor]:
    """TinyCNN's flax variables in the port's layout."""
    t = {}
    for conv in ("conv1", "conv2"):
        t[f"{conv}.weight"] = np.transpose(params[conv]["kernel"], (3, 2, 0, 1))
        t[f"{conv}.bias"] = params[conv]["bias"]
    t["bn1.weight"], t["bn1.bias"] = params["bn1"]["scale"], params["bn1"]["bias"]
    t["bn1.running_mean"], t["bn1.running_var"] = stats["bn1"]["mean"], stats["bn1"]["var"]
    t["head.weight"] = np.transpose(params["head"]["kernel"])
    t["head.bias"] = params["head"]["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in t.items()}


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------


def tiny_tp_step(work: Path, mesh) -> dict:
    """(d): one SGD step of the column-parallel TinyCNN on the data index's
    rows; the loss and the state gathered over the model group."""
    from deepfakedetection_tpu_torch.parallel import mesh as mesh_mod
    from deepfakedetection_tpu_torch.parallel.tensor import shard_parameters
    from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy

    model = TinyCNN()
    model.load_state_dict(torch.load(work / "tiny_init.pt", weights_only=True), strict=False)
    sharded = shard_parameters(model, mesh)
    batch = np.load(work / "tiny_batch.npz")
    per = TINY_B // mesh.data
    rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    x = torch.from_numpy(batch["x"][rows]).permute(0, 3, 1, 2)
    labels = torch.from_numpy(batch["labels"][rows]).long()
    mask = torch.from_numpy(batch["mask"][rows])
    model.train()
    loss = smoothed_cross_entropy(model(x), labels, mask)
    params = [p for _, p in model.named_parameters()]
    grads = mesh_mod.all_reduce_gradients(torch.autograd.grad(loss, params))
    with torch.no_grad():
        for p, g in zip(params, grads):
            p -= TINY_LR * g
    state = {}
    for name, value in model.state_dict().items():
        if name in sharded or name.replace(".bias", ".weight") in sharded:
            parts = [torch.empty_like(value) for _ in range(mesh.model)]
            dist.all_gather(parts, value.contiguous(), group=mesh.model_group)
            value = torch.cat(parts)
        state[name] = value.clone()
    return {"loss": float(mesh_mod.all_reduce_(loss.detach().clone())), "state": state,
            "sharded": sharded, "local": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def axis_config(work: Path, model: int) -> Path:
    import yaml

    cfg = {"seed": 7, "device": "cpu", "mesh": {"data": -1, "model": model},
           "data": {"root": str(work / "data"), "num_classes": 2, "img_size": 32},
           "models": {"efficientnet_b3": {
               "output_dir": str(work / f"runs_m{model}"),
               "training": {"epochs": 2, "batch_size": 8, "num_workers": 0,
                            "mixup_alpha": 0.4}}},
           "selection": ["efficientnet_b3"]}
    path = work / f"axis_m{model}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _worker(world: int, model: int, rank: int, port: int, work: Path) -> None:
    import deepfakedetection_tpu_torch.orchestrator as orch
    from deepfakedetection_tpu_torch.parallel import mesh as mesh_mod
    from deepfakedetection_tpu_torch.parallel import multihost
    from tests.test_torch_parallel import GLOBAL_B, b3_steps, narrow_spec

    os.environ.update(DFD_MULTIHOST="1", RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    assert multihost.maybe_initialize(cpu=True)
    try:
        mesh = mesh_mod.make_mesh(-1, model)
        per = GLOBAL_B // mesh.data
        out = {"index": (mesh.data_index, mesh.model_index),
               "b3": b3_steps(slice(mesh.data_index * per, (mesh.data_index + 1) * per))}
        if model > 1:
            out["tiny"] = tiny_tp_step(work, mesh)
        orch.get_model_spec = lambda name: narrow_spec()
        result = orch.orchestrate(work / f"axis_m{model}.yaml",
                                  mode="training")["efficientnet_b3"]
        out["final_loss"] = result.final_train_loss
        torch.save(out, work / f"axis_{world}x{model}.{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("data, model", [(-1, 2), (4, 2), (2, 4)])
def test_make_mesh_places_every_rank_as_the_jax_mesh(monkeypatch, data, model):
    from deepfakedetection_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from deepfakedetection_tpu_torch.parallel import mesh

    ids = np.vectorize(lambda d: d.id)(jax_make_mesh(data, model).devices)
    monkeypatch.setattr(mesh, "_ACTIVE", None)
    monkeypatch.setattr(mesh, "_GROUPS", {})
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
    for r in range(8):
        monkeypatch.setattr(dist, "get_rank", lambda r=r: r)
        m = mesh.make_mesh(data, model)
        (i,), (j,) = np.nonzero(ids == r)
        assert (m.data, m.model, m.rank, m.world) == (*ids.shape, r, 8)
        assert (m.data_index, m.model_index) == (i, j)
        assert m.data_group == tuple(ids[:, j]) and m.model_group == tuple(ids[i, :])


@pytest.mark.parametrize("data, model, words", [
    (-1, 3, "model=3 does not divide 8 processes"),
    (3, 2, "would leave 2 of 8 processes idle; set mesh.data to -1 or 4"),
    (4, 4, "mesh 4x4 exceeds 8 processes"),
])
def test_make_mesh_refuses_a_mesh_that_is_not_the_world(monkeypatch, data, model, words):
    from deepfakedetection_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "_ACTIVE", None)
    monkeypatch.setattr(mesh, "_GROUPS", {})
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match=words):
        mesh.make_mesh(data, model)


def _family_models(family: str):
    """(flax model, input side, port model) of each family's case."""
    import jax.numpy as jnp

    from tests.test_torch_parallel import B3_NARROW, FV_NARROW

    if family == "efficientnet":
        from deepfakedetection_tpu.models.efficientnet import EfficientNet as Jax
        from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet

        return (Jax(num_classes=2, dtype=jnp.float32, **B3_NARROW), 32,
                EfficientNet(num_classes=2, dtype=torch.float32, **B3_NARROW))
    if family == "fastervit":
        from deepfakedetection_tpu.models.fastervit import FasterViT as Jax
        from deepfakedetection_tpu_torch.models.fastervit import FasterViT

        heads = (2, 4, 8, 16)
        return (Jax(num_classes=2, num_heads=heads, pos_mode="cpb", dtype=jnp.float32,
                    **FV_NARROW), 224,
                FasterViT(2, num_heads=heads, dtype=torch.float32, **FV_NARROW))
    from deepfakedetection_tpu.models.efficientformer_v2 import _VARIANTS
    from deepfakedetection_tpu.models.efficientformer_v2 import EfficientFormerV2 as Jax
    from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2

    s1 = {k: _VARIANTS["s1"][k] for k in ("dims", "depths", "vit_num", "e_ratios")}
    return (Jax(num_classes=2, dtype=jnp.float32, **s1), 224,
            create_efficientformer_v2("s1", dtype=torch.float32))


@pytest.fixture(scope="module")
def family_cases():
    import jax
    import jax.numpy as jnp

    out = {}
    for family in ("efficientnet", "fastervit", "efficientformerv2"):
        jmodel, size, port = _family_models(family)
        shapes = jax.eval_shape(lambda key, x, m=jmodel: m.init(key, x, train=False),
                                jax.random.key(0), jnp.zeros((1, size, size, 3)))
        out[family] = (shapes, port)
    return out


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("family", ["efficientnet", "fastervit", "efficientformerv2"])
def test_param_specs_shard_what_the_jax_rule_shards(family_cases, family, model):
    from deepfakedetection_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from deepfakedetection_tpu.parallel.mesh import param_shardings
    from deepfakedetection_tpu_torch.parallel.tensor import param_specs
    from deepfakedetection_tpu_torch.runtime.convert import _flatten, _name_map

    shapes, port = family_cases[family]
    shardings = _flatten({"params": param_shardings(jax_make_mesh(8 // model, model),
                                                    shapes["params"])})
    names = _name_map(family, _flatten(dict(shapes)))
    want = {key: "model" in tuple(shardings["params", *path].spec)
            for key, (path, _) in names.items() if ("params", *path) in shardings}
    specs = param_specs(port, model)
    assert set(specs) <= set(want), sorted(set(specs) - set(want))[:5]
    got = {key: spec == 0 for key, spec in specs.items()}
    assert got == {key: want[key] for key in got}
    assert 0 < sum(got.values()) < len(got)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    """The JAX TinyCNN's init and batch written for the workers, and its
    tensor-parallel SGD step on the 4 x 2 mesh: (work, loss, state)."""
    import jax
    import jax.numpy as jnp
    import optax

    from deepfakedetection_tpu.parallel.mesh import (
        batch_sharding,
        make_mesh,
        param_shardings,
        replicated,
    )
    from deepfakedetection_tpu.train.steps import TrainState, init_model_variables, make_train_step
    from tests.test_torch_parallel import _write_tree
    from tests.util import TinyCNN as JaxTinyCNN

    work = tmp_path_factory.mktemp("model_axis")
    _write_tree(work / "data")
    for model in (1, 2):  # the workers' orchestrate configs, written before they start
        axis_config(work, model)
    model = JaxTinyCNN(num_classes=2, dtype=jnp.float32)
    params, stats = init_model_variables(model, jax.random.key(0), (1, 16, 16, 3))
    params, stats = jax.device_get(params), jax.device_get(stats)
    torch.save(tiny_state_from_flax(params, stats), work / "tiny_init.pt")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(TINY_B, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 2, TINY_B).astype(np.int32)
    mask = np.ones(TINY_B, bool)
    np.savez(work / "tiny_batch.npz", x=x, labels=labels, mask=mask)

    mesh = make_mesh(data=4, model=2)
    tx = optax.sgd(TINY_LR)
    sharded = jax.tree.map(jax.device_put, params, param_shardings(mesh, params))
    state = TrainState(params=sharded, batch_stats=jax.device_put(stats, replicated(mesh)),
                       opt_state=jax.device_put(tx.init(sharded), replicated(mesh)),
                       step=jax.device_put(jnp.asarray(0, jnp.int32), replicated(mesh)))
    put = lambda a: jax.device_put(a, batch_sharding(mesh))  # noqa: E731
    with jax.default_matmul_precision("highest"):
        new, metrics = make_train_step(model, tx)(state, put(x), put(labels), put(mask),
                                                  jax.random.key(1))
    out = tiny_state_from_flax(jax.device_get(new.params), jax.device_get(new.batch_stats))
    return work, float(metrics["loss"]), out


def _launch(world: int, model: int, work: Path) -> list:
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "DFD_MULTIHOST")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return [subprocess.Popen([sys.executable, "-m", "tests.test_torch_model_axis", str(world),
                              str(model), str(rank), str(port), str(work)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(world)]


@pytest.fixture(scope="module")
def ranks(jax_tp):
    """The 4-rank (2 x 2) and 2-rank (2 x 1) launches, at once: their
    outputs by rank."""
    work = jax_tp[0]
    procs = {(4, 2): _launch(4, 2, work), (2, 1): _launch(2, 1, work)}
    logs = {}
    try:
        for key, group in procs.items():
            logs[key] = [p.communicate(timeout=TIMEOUT)[0].decode(errors="replace")
                         for p in group]
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [f"{world}x{model} rank {rank}:\n{logs[world, model][rank][-3000:]}"
              for (world, model), group in procs.items()
              for rank, p in enumerate(group) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    out = {}
    for world, model in procs:
        out[world, model] = [torch.load(work / f"axis_{world}x{model}.{rank}.pt",
                                        weights_only=False) for rank in range(world)]
    return work, out


def test_ranks_sit_at_their_mesh_indices(ranks):
    _, out = ranks
    assert [r["index"] for r in out[4, 2]] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["index"] for r in out[2, 1]] == [(0, 0), (1, 0)]


def test_data_2_model_2_takes_the_data_2_step_and_the_one_process_step(ranks):
    from tests.test_torch_parallel import F32, b3_steps, over, readings

    _, out = ranks
    four, two = out[4, 2], out[2, 1]
    for rank, got in enumerate(four):
        ref = two[rank // 2]["b3"]
        assert got["b3"]["losses"] == ref["losses"]
        assert [k for k in ref["state"] if not torch.equal(ref["state"][k],
                                                           got["b3"]["state"][k])] == []
    reading = readings(b3_steps(slice(None)), four[0]["b3"])
    assert over(reading, F32) == {}, reading


def test_a_column_parallel_step_takes_the_jax_tensor_parallel_step(jax_tp, ranks):
    _, j_loss, j_state = jax_tp
    _, out = ranks
    tiny = [r["tiny"] for r in out[4, 2]]
    assert tiny[0]["sharded"] == ["conv1.weight", "conv2.weight", "head.weight"]
    assert tiny[0]["local"]["conv2.weight"] == (8, 8, 3, 3)  # half the output features
    assert tiny[0]["local"]["head.weight"] == (1, 16)
    for t in tiny:
        assert abs(t["loss"] - j_loss) <= 1e-5 * abs(j_loss)
        gaps = {k: float((t["state"][k] - j_state[k]).abs().max()) for k in j_state}
        assert max(gaps.values()) <= TP_ATOL, gaps
    # and the step moved every tensor
    init = torch.load(jax_tp[0] / "tiny_init.pt", weights_only=True)
    assert all(not torch.equal(init[k], j_state[k]) for k in j_state)


def _records(work: Path, model: int) -> list[dict]:
    (run,) = [p for p in (work / f"runs_m{model}").iterdir() if (p / "logs").is_dir()]
    return [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]


def test_orchestrate_over_a_model_axis_logs_the_data_axis_losses(ranks):
    work, out = ranks
    four, two = _records(work, 2), _records(work, 1)
    assert [r["epoch"] for r in four] == [1, 2] == [r["epoch"] for r in two]  # one writer
    for a, b in zip(four, two):
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-5 * abs(b["train_loss"])
        assert a["accuracy"] == b["accuracy"]
    losses = {r["final_loss"] for r in out[4, 2]}
    assert len(losses) == 1 and losses == {out[2, 1][0]["final_loss"]}


if __name__ == "__main__":
    world, model, rank, port, work = sys.argv[1:]
    torch.set_num_threads(2)
    _worker(int(world), int(model), int(rank), int(port), Path(work))
