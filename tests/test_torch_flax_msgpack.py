"""The port's reader of the JAX package's native weights
(deepfakedetection_tpu_torch/runtime/flax_msgpack.py) and ``load_weights`` on
them, on the CPU.

(a) ``flax.serialization.to_bytes`` of a narrow B3 tree and of a narrow
    FasterViT tree, each with a bf16 leaf, numpy scalars and an empty array
    added, read back by the port's reader: the same keys, each array equal
    to flax's own ``msgpack_restore`` of the bytes, in the same dtype.
(b) The JAX package's ``export_weights`` (flax msgpack under a ``.pth``
    name) read by ``load_weights(path, family)`` for each family equals
    ``state_dict_from_jax`` on the tree, tensor for tensor; the FasterViT
    tpu configuration is still told from the tensors; in a fresh
    interpreter, with no ``jax``, ``flax``, ``msgpack`` or ``ml_dtypes``
    module loaded.
(c) The eval job (``orchestrate(mode="inference")``, narrow B3, bf16) on a
    msgpack weights file gives the probabilities it gives on the converted
    torch ``.pth``, bit for bit.
(d) A truncated file, bytes past the end, a type flax's weights do not use
    (a complex ext, a boolean) and a msgpack file without the model family
    raise ``ValueError``.
"""

import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.runtime.checkpoint import export_weights
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch.runtime import flax_msgpack
from deepfakedetection_tpu_torch.runtime.convert import (
    fastervit_head_config,
    load_weights,
    state_dict_from_jax,
)
from tests import test_torch_efficientformer_v2 as ef_tests
from tests import test_torch_efficientnet as b3_tests
from tests import test_torch_eval_job as job_tests
from tests import test_torch_fastervit as fv_tests

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ["efficientnet", "fastervit", "efficientformerv2"]
READ = """
import sys, torch
from deepfakedetection_tpu_torch.runtime.convert import load_weights
torch.save(load_weights(sys.argv[1], sys.argv[2]), sys.argv[3])
banned = ("jax", "jaxlib", "flax", "msgpack", "ml_dtypes", "deepfakedetection_tpu")
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in banned))
"""


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (the suite runs a file a
    worker on a few cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _tree(family):
    """A numpy-seeded JAX variables tree of a narrow model of ``family``."""
    if family == "efficientnet":
        return b3_tests.jax_variables(JaxEfficientNet(**b3_tests.NARROW, dtype=jnp.float32))
    if family == "fastervit":
        jmodel = JaxFasterViT(num_classes=2, num_heads=fv_tests._heads("tpu"), pos_mode="table",
                              dtype=jnp.float32, **fv_tests.NARROW)
        params, stats = init_model_variables(jmodel, jax.random.key(0), (1, 224, 224, 3))
        rng = np.random.default_rng(1)
        return {"params": fv_tests._perturbed(jax.device_get(params), rng),
                "batch_stats": fv_tests._perturbed(jax.device_get(stats), rng)}
    return ef_tests.seeded_tree(ef_tests.NARROW, 128, np.random.default_rng(0))


def _flat(tree, prefix=()):
    if not hasattr(tree, "items"):
        return {prefix: tree}
    return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}


def _numpy(leaf):
    """A leaf as a float64 numpy array (bf16 widened exactly)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.double().numpy()
    return np.asarray(np.asarray(leaf).astype(np.float64))


@pytest.mark.parametrize("family", ["efficientnet", "fastervit"])
def test_reader_gives_flax_trees_back(family):
    tree = _tree(family)
    tree["extra"] = {"bf16": jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16),
                     "step": np.int32(7), "lr": np.float32(0.5),
                     "empty": np.zeros((0, 3), np.float32), "count": np.arange(5)}
    blob = flax.serialization.to_bytes(tree)
    got, want = _flat(flax_msgpack.msgpack_restore(blob)), _flat(flax.serialization.msgpack_restore(blob))
    assert got.keys() == want.keys() and len(got) > 20
    for key, ref in want.items():
        leaf = got[key]
        assert isinstance(leaf, torch.Tensor), key
        assert str(leaf.dtype).removeprefix("torch.") == np.asarray(ref).dtype.name, key
        assert tuple(leaf.shape) == np.shape(ref), key
        assert np.array_equal(_numpy(leaf), _numpy(ref)), key


@pytest.mark.parametrize("family", FAMILIES)
def test_load_weights_reads_the_jax_packages_weights_named_pth(family, tmp_path):
    tree = _tree(family)
    path = export_weights(tmp_path / "Model.pth", tree["params"], tree["batch_stats"])
    got, want = load_weights(path, family), state_dict_from_jax(tree, family)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    if family == "fastervit":
        assert fastervit_head_config(got) == "tpu"


def test_a_fresh_interpreter_reads_them_without_jax_or_msgpack(tmp_path):
    tree = _tree("efficientnet")
    path = export_weights(tmp_path / "b3.weights.msgpack", tree["params"], tree["batch_stats"])
    proc = subprocess.run([sys.executable, "-c", READ, str(path), "efficientnet",
                           str(tmp_path / "out.pth")], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
    got = torch.load(tmp_path / "out.pth", weights_only=True)
    want = state_dict_from_jax(tree, "efficientnet")
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_eval_job_on_msgpack_weights_gives_the_converted_pths_probabilities(
        tiny_image_tree, tmp_path, monkeypatch):
    tree = _tree("efficientnet")
    native = export_weights(tmp_path / "native.pth", tree["params"], tree["batch_stats"])
    converted = tmp_path / "converted.pth"
    torch.save(state_dict_from_jax(tree, "efficientnet"), converted)
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: job_tests._port_spec())
    probs = {}
    for name, weights in (("native", native), ("converted", converted)):
        cfg = job_tests._config(tmp_path / f"{name}.yaml", tiny_image_tree, tmp_path / name,
                                weights, "bfloat16")
        probs[name] = port_orch.orchestrate(cfg, mode="inference")["efficientnet_b3"].probs
    assert probs["native"].shape == (12, 2)
    np.testing.assert_array_equal(probs["native"], probs["converted"])


def test_what_the_reader_refuses(tmp_path):
    tree = _tree("efficientnet")
    blob = flax.serialization.to_bytes(tree)
    for cut in (1, 17, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ValueError, match="truncated"):
            flax_msgpack.msgpack_restore(blob[:cut])
    with pytest.raises(ValueError, match="past the end"):
        flax_msgpack.msgpack_restore(blob + b"\xc0")
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.msgpack_restore(flax.serialization.msgpack_serialize({"z": 1 + 2j}))
    with pytest.raises(ValueError, match="tag 0xc3"):  # true: no weights tree holds one
        flax_msgpack.msgpack_restore(flax.serialization.msgpack_serialize({"flag": True}))
    path = tmp_path / "b3.pth"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match="model family"):
        load_weights(path)
    path.write_bytes(blob[: len(blob) // 3])
    with pytest.raises(ValueError, match="truncated"):
        load_weights(path, "efficientnet")
