"""The ``mesh:`` block, the process group and the card of a rank, in one
process (the two-process runs are ``tests/test_torch_parallel.py``).

- ``parallel/mesh.mesh_dims`` raises exactly where the JAX orchestrator's
  ``_mesh_dims`` raises, with its words, and returns what it returns;
  ``make_mesh`` then accepts a data axis of -1 or the world with a model
  axis of 1, refuses ``model > 1`` naming the ROADMAP item of the model
  axis, and refuses a data axis that exceeds the world.
- ``orchestrate`` refuses a bad ``mesh:`` before any work: no run dir.
- ``maybe_initialize`` joins a group only when asked (``DFD_MULTIHOST=1``
  or torchrun's environment), is idempotent, and raises when the
  rendezvous or the card is missing; under a group ``resolve_device`` gives
  ``cuda:LOCAL_RANK``.
- Every kernel wrapper launches under its input's device guard (a
  ``with torch.cuda.device(...)`` around each call into the library), so a
  rank's kernels run on its own card.
"""

import ast
import re
import socket
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import yaml

from deepfakedetection_tpu.orchestrator import _mesh_dims
from deepfakedetection_tpu_torch.orchestrator import orchestrate
from deepfakedetection_tpu_torch.parallel import multihost
from deepfakedetection_tpu_torch.parallel.mesh import MODEL_AXIS_ITEM, make_mesh, mesh_dims
from deepfakedetection_tpu_torch.runtime.flags import resolve_device
from deepfakedetection_tpu_torch.train.loop import TrainJob, unported_options

REPO = Path(__file__).resolve().parents[1]
CASES = {
    "empty": {},
    "none": {"mesh": None},
    "data 0": {"mesh": {"data": 0, "model": 4}},
    "data -2": {"mesh": {"data": -2}},
    "model 0": {"mesh": {"model": 0}},
    "data 4 model 2": {"mesh": {"data": 4, "model": 2}},
    "data 2": {"mesh": {"data": 2}},
    "data 1": {"mesh": {"data": 1, "model": 1}},
}
ENV = ("DFD_MULTIHOST", "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("case", CASES)
def test_the_port_validates_the_mesh_as_the_jax_package(case):
    config = CASES[case]
    try:
        want = _mesh_dims(config)
    except ValueError as jax_error:
        with pytest.raises(ValueError) as port_error:
            mesh_dims(config)
        assert str(port_error.value) == str(jax_error)
        return
    assert mesh_dims(config) == want
    data, model = want
    if model > 1:
        with pytest.raises(NotImplementedError, match=re.escape(MODEL_AXIS_ITEM)):
            make_mesh(data, model)
    elif data not in (-1, 1):
        with pytest.raises(ValueError, match=f"mesh {data}x1 exceeds 1 processes"):
            make_mesh(data, model)
    else:
        mesh = make_mesh(data, model)
        assert (mesh.data, mesh.model, mesh.rank, mesh.world) == (1, 1, 0, 1)


def _config(tmp_path, mesh):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({
        "device": "cpu", "mesh": mesh, "data": {"root": str(tmp_path / "data")},
        "models": {"efficientnet_b3": {"output_dir": str(tmp_path / "runs")}},
        "selection": ["efficientnet_b3"]}))
    return path


@pytest.mark.parametrize("mesh, error, words", [
    ({"data": 0, "model": 4}, ValueError, "invalid mesh config data=0 model=4"),
    ({"data": -1, "model": 2}, NotImplementedError, MODEL_AXIS_ITEM),
    ({"data": 2, "model": 1}, ValueError, "mesh 2x1 exceeds 1 processes"),
])
@pytest.mark.parametrize("mode", ["training", "inference"])
def test_orchestrate_refuses_a_bad_mesh_before_any_work(tmp_path, mesh, error, words, mode):
    with pytest.raises(error, match=re.escape(words)):
        orchestrate(_config(tmp_path, mesh), mode=mode)
    assert not (tmp_path / "runs").exists()


def test_the_trainer_refuses_a_model_axis_only():
    job = TrainJob(model_name="efficientnet_b3", spec=None, run_paths=None, data_root=Path("."))
    assert unported_options(job) == []
    job.mesh_model = 2
    assert unported_options(job) == [
        f"mesh model=2: sharding parameters over a model axis is {MODEL_AXIS_ITEM}"]


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    monkeypatch.undo()
    if dist.is_initialized():
        dist.destroy_process_group()


def _port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def test_no_group_unless_asked(clean_env):
    clean_env.setenv("WORLD_SIZE", "1")
    clean_env.setenv("MASTER_ADDR", "localhost")  # torchrun with one process
    assert not multihost.requested()
    assert multihost.maybe_initialize(cpu=True) is False and not dist.is_initialized()


def test_a_world_of_one_over_gloo_runs_the_collectives(clean_env):
    clean_env.setenv("DFD_MULTIHOST", "1")
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"),
                        ("MASTER_PORT", _port())):
        clean_env.setenv(name, value)
    assert multihost.maybe_initialize(cpu=True) and dist.get_backend() == "gloo"
    assert multihost.maybe_initialize(cpu=True)  # idempotent
    mesh = make_mesh(-1, 1)
    assert (mesh.data, mesh.world, mesh.rank) == (1, 1, 0)
    rows = torch.arange(6.0).reshape(3, 2).numpy()
    assert (multihost.allgather_examples(rows) == rows).all()
    assert multihost.broadcast_object("20261018-000000") == "20261018-000000"
    multihost.barrier()


def test_a_failed_rendezvous_raises(clean_env):
    clean_env.setenv("DFD_MULTIHOST", "1")  # no MASTER_ADDR, RANK or WORLD_SIZE
    with pytest.raises(ValueError):
        multihost.maybe_initialize(cpu=True)
    assert not dist.is_initialized()


def test_nccl_without_a_card_raises(clean_env):
    clean_env.setenv("DFD_MULTIHOST", "1")
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        multihost.maybe_initialize(cpu=False)


def test_a_rank_resolves_its_own_card(clean_env):
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.distributed, "is_initialized", lambda: True)
    clean_env.setenv("LOCAL_RANK", "3")
    assert resolve_device({"device": "tpu"}) == torch.device("cuda", 3)
    assert resolve_device({"device": "cpu"}) == torch.device("cpu")


def _launches(node) -> bool:
    """A call of a kernel library entry that launches (the ``*_plan``
    entries and ``dfd_error_string`` run on the host)."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr.startswith("dfd_") and not node.func.attr.endswith("_plan")
            and node.func.attr != "dfd_error_string")


def _guarded_library_calls(source: str) -> tuple[int, list[int]]:
    """(launching calls into the kernel library, lines of those outside a
    ``with torch.cuda.device(...)``) in one module's source."""
    tree = ast.parse(source)
    guarded = []
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                ast.unparse(item.context_expr).startswith("torch.cuda.device(")
                for item in node.items):
            guarded.append((node.lineno, node.end_lineno))
    calls = [node.lineno for node in ast.walk(tree) if _launches(node)]
    return len(calls), [n for n in calls if not any(a <= n <= b for a, b in guarded)]


def test_every_kernel_launch_is_under_its_device_guard():
    total = 0
    for path in sorted((REPO / "deepfakedetection_tpu_torch" / "ops").glob("*.py")):
        count, bare = _guarded_library_calls(path.read_text())
        assert bare == [], f"{path.name}: library calls outside a device guard at {bare}"
        total += count
    assert total == 11  # K1, K2, K3 and its packing, K4, K5 and K6 both ways, K7, int8
    planted = "def f(lib, x):\n    return lib.dfd_kernel(x)\n"
    assert _guarded_library_calls(planted) == (1, [2])
