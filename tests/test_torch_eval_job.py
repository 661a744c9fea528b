"""The slice as a whole: the port's ``orchestrate(mode="inference")`` against
the JAX package's, on the same image tree and the same ``.pth``.

Both stacks run a narrow EfficientNet (width 0.25, depth 0.5) at 32 px with
``get_model_spec`` monkeypatched, as tests/test_orchestrate_e2e.py does, and
a narrow FasterViT (dim 16, depths (1, 1, 2, 1)) at 224 px from a ``.pth`` in
the fastervit wheel's key names, which both jobs must read as the official
head configuration, and a
narrow EfficientFormerV2 (dims (16, 24, 32, 48), depths (1, 1, 3, 2)) at 128 px
from a ``.pth`` in timm's key names, which the port's job must build at the
job's img_size. The B3
checkpoint comes from a JAX init through ``export_torch_state_dict``, with a
classifier along the first principal direction of the model's features so
probabilities spread to a real operating point (random-init probabilities sit
almost tied). Gates, as tools/parity.py composes them: per-image
probabilities within 1e-4 in f32, the same swept threshold, accuracy and
confusion matrix, and the same decisions except for an image whose p1 lies
within 1e-4 of the threshold. The bf16 port run (through the kernel wrappers'
plain versions) must make the f32 run's decisions except within 2e-2 of the
threshold. Measured max|dp|: 1.0e-6 between the f32 port and JAX, 3.5e-3
between the bf16 and f32 port runs.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import deepfakedetection_tpu.orchestrator as jax_orch
import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu.models.efficientformer_v2 import EfficientFormerV2 as JaxEFv2
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.registry import get_model_spec as jax_model_spec
from deepfakedetection_tpu.runtime.torch_convert import export_torch_state_dict
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch.data.augment import normalize_batch
from deepfakedetection_tpu_torch.data.pipeline import (
    build_eval_plan,
    make_eval_loader,
    scan_image_folder,
)
from deepfakedetection_tpu_torch.models.efficientformer_v2 import EfficientFormerV2
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
from deepfakedetection_tpu_torch.models.fastervit import FasterViT
from deepfakedetection_tpu_torch.registry import get_model_spec as port_model_spec
from deepfakedetection_tpu_torch.evaluate.job import pick_head_config
from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
from deepfakedetection_tpu_torch.runtime.convert import fastervit_head_config, state_dict_from_jax
from deepfakedetection_tpu_torch.runtime.flags import resolve_device
from deepfakedetection_tpu_torch.train.loop import TrainResult
from tests.test_torch_efficientformer_v2 import NARROW as EF_NARROW
from tests.test_torch_efficientformer_v2 import seeded_tree
from tests.test_torch_fastervit import _perturbed
from tests.torch_refs.fastervit_torch import FasterViT2

REPO = Path(__file__).resolve().parents[1]

NARROW = dict(width_coefficient=0.25, depth_coefficient=0.5, native_resolution=32)
SIZE = 32
EVAL = {"ensure_rgb": True, "val_resize": True, "val_center_crop": True}


def _jax_spec():
    return dataclasses.replace(
        jax_model_spec("efficientnet_b3"),
        builder=lambda num_classes, dtype=jnp.bfloat16, **kw: JaxEfficientNet(
            num_classes=num_classes, dtype=dtype, **NARROW
        ),
    )


def _port_spec():
    return dataclasses.replace(
        port_model_spec("efficientnet_b3"),
        builder=lambda num_classes, dtype=torch.bfloat16, generator=None, **kw: EfficientNet(
            num_classes=num_classes, dtype=dtype, generator=generator, **NARROW
        ),
    )


def _features(state, root):
    """Pre-classifier features of every val and test image (port, f32)."""
    model = EfficientNet(num_classes=2, dtype=torch.float32, **NARROW).eval()
    model.load_state_dict(state)
    plan = build_eval_plan(SIZE, EVAL)
    feats = []
    hook = model._fc.register_forward_hook(lambda _m, inp, _o: feats.append(inp[0]))
    with torch.no_grad():
        for split in ("val", "test"):
            ds = scan_image_folder(root / split)
            for batch in make_eval_loader(ds, plan, batch_size=32):
                model(normalize_batch(torch.from_numpy(batch.images), plan)[batch.mask])
    hook.remove()
    return torch.cat(feats)


@pytest.fixture(scope="module")
def checkpoint(tiny_image_tree, tmp_path_factory):
    jmodel = JaxEfficientNet(num_classes=2, dtype=jnp.float32, **NARROW)
    params, batch_stats = init_model_variables(jmodel, jax.random.key(0), (1, SIZE, SIZE, 3))
    tree = {"params": jax.device_get(params), "batch_stats": jax.device_get(batch_stats)}
    state = {
        k: torch.from_numpy(np.array(v, np.float32))
        for k, v in export_torch_state_dict(tree, "efficientnet").items()
    }
    feats = _features(state, tiny_image_tree).double()
    centred = feats - feats.mean(0)
    direction = torch.linalg.svd(centred, full_matrices=False).Vh[0]
    z = centred @ direction
    scale = 2.0 / float(z.std())
    fc_w = torch.zeros_like(state["_fc.weight"], dtype=torch.float64)
    fc_w[1] = scale * direction
    state["_fc.weight"] = fc_w.float()
    state["_fc.bias"] = torch.tensor([0.0, -scale * float(feats.mean(0) @ direction)])
    path = tmp_path_factory.mktemp("ckpt") / "narrow_b3.pth"
    torch.save(state, path)
    return path


def _config(path, root, out_dir, weights, precision="float32", model="efficientnet_b3",
            size=SIZE):
    cfg = {
        "seed": 7,
        "device": "cpu",
        "precision": precision,
        "data": {"root": str(root), "val_split": "val", "test_split": "test",
                 "num_classes": 2, "img_size": size},
        "models": {model: {
            "output_dir": str(out_dir),
            "transforms": {"eval": EVAL},
            "inference": {"weights": str(weights), "split": "test", "batch_size": 8,
                          "num_workers": 0, "img_size": size},
        }},
        "selection": [model],
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


def _metrics_keys(out_dir):
    (run,) = sorted(out_dir.iterdir())
    lines = (run / "logs" / "metrics.jsonl").read_text().splitlines()
    return set(json.loads(lines[-1]))


@pytest.fixture(scope="module")
def runs(tiny_image_tree, checkpoint, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs")
    mp = pytest.MonkeyPatch()
    try:
        captured = {}
        real_run = jax_orch.run_eval_job
        mp.setattr(jax_orch, "get_model_spec", lambda name: _jax_spec())
        mp.setattr(jax_orch, "run_eval_job", lambda job: captured.setdefault("r", real_run(job)))
        mp.setattr(port_orch, "get_model_spec", lambda name: _port_spec())
        with jax.default_matmul_precision("highest"):
            jax_orch.orchestrate(
                _config(tmp / "jax.yaml", tiny_image_tree, tmp / "jax", checkpoint, "float32"),
                mode="inference",
            )
        out = {"jax": captured["r"]}
        for name, precision in (("f32", "float32"), ("bf16", "bfloat16")):
            cfg = _config(tmp / f"{name}.yaml", tiny_image_tree, tmp / name, checkpoint,
                          precision)
            out[name] = port_orch.orchestrate(cfg, mode="inference")["efficientnet_b3"]
        out["dirs"] = {k: tmp / k for k in ("jax", "f32", "bf16")}
        return out
    finally:
        mp.undo()


def test_port_f32_eval_job_matches_jax_per_image(runs):
    jax_r, port = runs["jax"], runs["f32"]
    t = jax_r.metrics["threshold"]
    assert port.probs.shape == jax_r.probs.shape == (12, 2)
    np.testing.assert_array_equal(port.targets, jax_r.targets)
    np.testing.assert_allclose(port.probs, jax_r.probs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.val_probs, jax_r.val_probs, atol=1e-4, rtol=0)
    assert port.metrics["threshold"] == t
    assert np.ptp(jax_r.probs[:, 1]) > 0.3  # a spread operating point, not a tie
    far = np.abs(jax_r.probs[:, 1] - t) > 1e-4
    np.testing.assert_array_equal(port.preds[far], jax_r.preds[far])
    assert port.metrics["accuracy"] == jax_r.metrics["accuracy"]
    assert port.metrics["confusion_matrix"] == jax_r.metrics["confusion_matrix"]
    assert port.metrics["roc_auc"] == pytest.approx(jax_r.metrics["roc_auc"], abs=1e-9)
    assert _metrics_keys(runs["dirs"]["f32"]) == _metrics_keys(runs["dirs"]["jax"])


def test_port_bf16_decisions_match_f32_away_from_threshold(runs):
    f32, bf16 = runs["f32"], runs["bf16"]
    t32, t16 = f32.metrics["threshold"], bf16.metrics["threshold"]
    p32 = f32.probs[:, 1]
    np.testing.assert_allclose(bf16.probs, f32.probs, atol=2e-2, rtol=0)
    far = (np.abs(p32 - t32) > 2e-2) & (np.abs(p32 - t16) > 2e-2)
    assert far.sum() >= 6
    np.testing.assert_array_equal(bf16.preds[far], f32.preds[far])


FV = "faster_vit_2_224"
FV_NARROW = dict(dim=16, in_dim=8, depths=(1, 1, 2, 1))
FV_SIZE = 224
FV_HEADS = {"official": (2, 4, 8, 16), "tpu": (1, 1, 1, 1)}


def _fv_specs(built):
    """Narrow FasterViT specs for both packages; ``built`` records the
    head_config each builder was given."""
    def jax_builder(num_classes, dtype=jnp.bfloat16, head_config="tpu", **kw):
        built.append(("jax", head_config))
        return JaxFasterViT(num_classes=num_classes, num_heads=FV_HEADS[head_config],
                            pos_mode="cpb" if head_config == "official" else "table",
                            dtype=dtype, **FV_NARROW)

    def port_builder(num_classes, dtype=torch.bfloat16, generator=None, head_config="tpu", **kw):
        built.append(("port", head_config))
        return FasterViT(num_classes, num_heads=FV_HEADS[head_config],
                         official=head_config == "official", dtype=dtype, generator=generator,
                         **FV_NARROW)

    return (dataclasses.replace(jax_model_spec(FV), builder=jax_builder),
            dataclasses.replace(port_model_spec(FV), builder=port_builder))


@pytest.fixture(scope="module")
def fv_runs(tiny_image_tree, tmp_path_factory):
    """The JAX and port eval jobs (f32) on a narrow official FasterViT whose
    seeded weights are a torch ``.pth`` in the wheel's names, its head fitted
    along the first principal direction of the val and test features."""
    tmp = tmp_path_factory.mktemp("fv")
    built = []
    jax_spec, port_spec = _fv_specs(built)
    jmodel = JaxFasterViT(num_classes=2, num_heads=FV_HEADS["official"], pos_mode="cpb",
                          dtype=jnp.float32, **FV_NARROW)
    params, stats = init_model_variables(jmodel, jax.random.key(0), (1, FV_SIZE, FV_SIZE, 3))
    rng = np.random.default_rng(3)
    tree = {"params": _perturbed(jax.device_get(params), rng),
            "batch_stats": _perturbed(jax.device_get(stats), rng)}
    state = state_dict_from_jax(tree, "fastervit")
    model = FasterViT(2, num_heads=FV_HEADS["official"], dtype=torch.float32, **FV_NARROW).eval()
    model.load_state_dict(state, strict=False)
    plan = build_eval_plan(FV_SIZE, EVAL)
    feats = []
    hook = model.head.register_forward_hook(lambda _m, inp, _o: feats.append(inp[0]))
    with torch.no_grad():
        for split in ("val", "test"):
            for batch in make_eval_loader(scan_image_folder(tiny_image_tree / split), plan,
                                          batch_size=32):
                model(normalize_batch(torch.from_numpy(batch.images), plan)[batch.mask])
    hook.remove()
    f = torch.cat(feats).double()
    direction = torch.linalg.svd(f - f.mean(0), full_matrices=False).Vh[0]
    scale = 2.0 / float(((f - f.mean(0)) @ direction).std())
    state["head.weight"] = torch.stack([torch.zeros_like(direction), scale * direction]).float()
    state["head.bias"] = torch.tensor([0.0, -scale * float(f.mean(0) @ direction)])
    weights = tmp / "narrow_fastervit.pth"
    torch.save(state, weights)

    def config(name):
        return _config(tmp / f"{name}.yaml", tiny_image_tree, tmp / name, weights, model=FV,
                       size=FV_SIZE)

    mp = pytest.MonkeyPatch()
    try:
        captured = {}
        real_run = jax_orch.run_eval_job
        mp.setattr(jax_orch, "get_model_spec", lambda name: jax_spec)
        mp.setattr(jax_orch, "run_eval_job", lambda job: captured.setdefault("r", real_run(job)))
        mp.setattr(port_orch, "get_model_spec", lambda name: port_spec)
        with jax.default_matmul_precision("highest"):
            jax_orch.orchestrate(config("jax"), mode="inference")
        port = port_orch.orchestrate(config("port"), mode="inference")[FV]
    finally:
        mp.undo()
    return {"jax": captured["r"], "port": port, "built": built}


def test_fastervit_torch_checkpoint_selects_the_official_config(fv_runs):
    assert ("port", "official") in fv_runs["built"] and ("jax", "official") in fv_runs["built"]
    assert ("port", "tpu") not in fv_runs["built"]


def test_port_f32_fastervit_eval_job_matches_jax_per_image(fv_runs):
    jax_r, port = fv_runs["jax"], fv_runs["port"]
    assert port.probs.shape == jax_r.probs.shape == (12, 2)
    assert np.ptp(jax_r.probs[:, 1]) > 0.3  # a spread operating point, not a tie
    np.testing.assert_array_equal(port.targets, jax_r.targets)
    np.testing.assert_allclose(port.probs, jax_r.probs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.val_probs, jax_r.val_probs, atol=1e-4, rtol=0)
    assert port.metrics["threshold"] == jax_r.metrics["threshold"]
    t = jax_r.metrics["threshold"]
    far = np.abs(jax_r.probs[:, 1] - t) > 1e-4
    np.testing.assert_array_equal(port.preds[far], jax_r.preds[far])


EF = "efficientformerv2_s1"
EF_SIZE = 128


def _ef_specs(built):
    """Narrow EfficientFormerV2 specs for both packages; ``built`` records the
    img_size the port's builder was given."""
    def jax_builder(num_classes, dtype=jnp.bfloat16, **kw):
        return JaxEFv2(num_classes=num_classes, dtype=dtype, **EF_NARROW)

    def port_builder(num_classes, dtype=torch.bfloat16, generator=None, img_size=224, **kw):
        built.append(img_size)
        return EfficientFormerV2(num_classes, **EF_NARROW, img_size=img_size, dtype=dtype,
                                 generator=generator)

    return (dataclasses.replace(jax_model_spec(EF), builder=jax_builder),
            dataclasses.replace(port_model_spec(EF), builder=port_builder))


@pytest.fixture(scope="module")
def ef_runs(tiny_image_tree, tmp_path_factory):
    """The JAX and port eval jobs (f32) on a narrow EfficientFormerV2 whose
    numpy-seeded weights are a torch ``.pth`` in timm's names, its heads
    fitted along the first principal direction of the val and test features."""
    tmp = tmp_path_factory.mktemp("ef")
    built = []
    jax_spec, port_spec = _ef_specs(built)
    tree = seeded_tree(EF_NARROW, EF_SIZE, np.random.default_rng(5))
    state = state_dict_from_jax(tree, "efficientformerv2")
    model = EfficientFormerV2(2, **EF_NARROW, img_size=EF_SIZE, dtype=torch.float32).eval()
    model.load_state_dict(state)
    plan = build_eval_plan(EF_SIZE, EVAL)
    feats = []
    hook = model.head.register_forward_hook(lambda _m, inp, _o: feats.append(inp[0]))
    with torch.no_grad():
        for split in ("val", "test"):
            for batch in make_eval_loader(scan_image_folder(tiny_image_tree / split), plan,
                                          batch_size=32):
                model(normalize_batch(torch.from_numpy(batch.images), plan)[batch.mask])
    hook.remove()
    f = torch.cat(feats).double()
    direction = torch.linalg.svd(f - f.mean(0), full_matrices=False).Vh[0]
    scale = 2.0 / float(((f - f.mean(0)) @ direction).std())
    for head in ("head", "head_dist"):
        state[f"{head}.weight"] = torch.stack([torch.zeros_like(direction),
                                               scale * direction]).float()
        state[f"{head}.bias"] = torch.tensor([0.0, -scale * float(f.mean(0) @ direction)])
    weights = tmp / "narrow_efficientformer.pth"
    torch.save(state, weights)

    mp = pytest.MonkeyPatch()
    try:
        captured = {}
        real_run = jax_orch.run_eval_job
        mp.setattr(jax_orch, "get_model_spec", lambda name: jax_spec)
        mp.setattr(jax_orch, "run_eval_job", lambda job: captured.setdefault("r", real_run(job)))
        mp.setattr(port_orch, "get_model_spec", lambda name: port_spec)
        with jax.default_matmul_precision("highest"):
            jax_orch.orchestrate(_config(tmp / "jax.yaml", tiny_image_tree, tmp / "jax", weights,
                                         model=EF, size=EF_SIZE), mode="inference")
        port = port_orch.orchestrate(_config(tmp / "port.yaml", tiny_image_tree, tmp / "port",
                                             weights, model=EF, size=EF_SIZE),
                                     mode="inference")[EF]
    finally:
        mp.undo()
    return {"jax": captured["r"], "port": port, "built": built}


def test_port_f32_efficientformer_eval_job_matches_jax_per_image(ef_runs):
    jax_r, port = ef_runs["jax"], ef_runs["port"]
    assert ef_runs["built"] == [EF_SIZE]  # built at the job's img_size
    assert port.probs.shape == jax_r.probs.shape == (12, 2)
    assert np.ptp(jax_r.probs[:, 1]) > 0.3  # a spread operating point, not a tie
    np.testing.assert_array_equal(port.targets, jax_r.targets)
    np.testing.assert_allclose(port.probs, jax_r.probs, atol=1e-4, rtol=0)
    np.testing.assert_allclose(port.val_probs, jax_r.val_probs, atol=1e-4, rtol=0)
    assert port.metrics["threshold"] == jax_r.metrics["threshold"]
    far = np.abs(jax_r.probs[:, 1] - jax_r.metrics["threshold"]) > 1e-4
    np.testing.assert_array_equal(port.preds[far], jax_r.preds[far])
    assert port.metrics["confusion_matrix"] == jax_r.metrics["confusion_matrix"]


@pytest.mark.parametrize("device", ["tpu", "cuda", None])
def test_any_device_but_cpu_needs_cuda(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device({"device": device})
    assert resolve_device({"device": "cpu"}) == torch.device("cpu")


def test_orchestrate_refuses_what_is_not_ported(tmp_path, tiny_image_tree, checkpoint,
                                                monkeypatch):
    cfg = tmp_path / "c.yaml"
    _config(cfg, tiny_image_tree, tmp_path / "out", checkpoint, "float32")
    data = yaml.safe_load(cfg.read_text())
    data["models"]["faster_vit_2_224"] = {"output_dir": str(tmp_path / "fv")}
    data["models"]["efficientformerv2_s1"] = {"output_dir": str(tmp_path / "ef"),
                                              "training": {"remat": True}}
    data["selection"] = ["efficientnet_b3", "efficientformerv2_s1", "faster_vit_2_224"]
    # an attention past K6's 128 tokens under DFD_FUSED_ATTN (FasterViT at 448
    # px) is what the port still refuses
    cfg.write_text(yaml.safe_dump({**data, "precision": "bfloat16",
                                   "data": {**data["data"], "img_size": 448}}))
    with monkeypatch.context() as mp:
        mp.setenv("DFD_FUSED_ATTN", "1")
        with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
            port_orch.orchestrate(cfg, mode="training")
    assert not (tmp_path / "out").exists()  # failed before any work
    # every family reaches the trainer, FasterViT with the fused sub-block (K6)
    # switched on as well, and S1 with remat: no refusal
    data["selection"] = ["efficientnet_b3", "efficientformerv2_s1", "faster_vit_2_224"]
    cfg.write_text(yaml.safe_dump(data))
    jobs = []
    with monkeypatch.context() as mp:
        mp.setenv("DFD_FUSED_ATTN", "1")
        mp.setattr(port_orch, "run_training",
                   lambda job: jobs.append(job) or TrainResult(0.0, -1, 0, 0.0))
        port_orch.orchestrate(cfg, mode="training")
    assert [job.spec.name for job in jobs] == data["selection"]
    assert all(port_orch.unported_options(job) == [] for job in jobs)

    # the shipped training config, pointed at the tree, on the CPU
    shipped = yaml.safe_load((REPO / "config" / "train.yaml").read_text())
    shipped.update(device="cpu", data={**shipped["data"], "root": str(tiny_image_tree)})
    for name, block in shipped["models"].items():
        block["output_dir"] = str(tmp_path / "shipped" / name)
    cfg.write_text(yaml.safe_dump(shipped))
    jobs.clear()
    with monkeypatch.context() as mp:
        mp.setattr(port_orch, "run_training",
                   lambda job: jobs.append(job) or TrainResult(0.0, -1, 0, 0.0))
        port_orch.orchestrate(cfg, mode="training")
    assert [(j.spec.name, j.img_size, j.batch_size) for j in jobs] == [
        ("efficientnet_b3", 224, 64), ("efficientformerv2_s1", 224, 128),
        ("faster_vit_2_224", 224, 64)]

    data["selection"] = ["efficientnet_b3"]
    data["models"]["efficientnet_b3"]["inference"]["precision"] = "int8"
    cfg.write_text(yaml.safe_dump(data))
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: _port_spec())
    # int8 eval is ported: it runs and says so in its metrics
    res = port_orch.orchestrate(cfg, mode="inference")["efficientnet_b3"]
    assert res.metrics["precision"] == "int8" and np.isfinite(res.probs).all()

    _, ef_spec = _ef_specs([])
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: ef_spec)
    data["selection"] = ["efficientformerv2_s1"]
    data["models"]["efficientformerv2_s1"]["inference"] = {"batch_size": 8, "num_workers": 0}
    cfg.write_text(yaml.safe_dump(data))
    res = port_orch.orchestrate(cfg, mode="inference")["efficientformerv2_s1"]
    assert res.probs.shape == (12, 2) and np.isfinite(res.probs).all()


@pytest.mark.parametrize("source,want", [
    ("wheel", "official"), ("port official", "official"), ("port tpu", "tpu"),
    ("jax tpu", "tpu"), ("jax official", "official"),
])
def test_fastervit_head_config_reads_the_tensors(source, want):
    """A torch state dict builds the configuration it was made in: the
    wheel's FasterViT-2 and the port's official export official, the port's
    tpu export and the converter's tpu tree tpu (full width for the wheel
    and the port, narrow through ``state_dict_from_jax``)."""
    if source == "wheel":
        state = FasterViT2(num_classes=2).state_dict()
    elif source.startswith("port"):
        state = create_faster_vit("2", head_config=source.split()[1],
                                  dtype=torch.float32).state_dict()
    else:
        config = source.split()[1]
        jmodel = JaxFasterViT(num_classes=2, num_heads=FV_HEADS[config],
                              pos_mode="cpb" if config == "official" else "table",
                              dtype=jnp.float32, **FV_NARROW)
        params, stats = init_model_variables(jmodel, jax.random.key(0), (1, FV_SIZE, FV_SIZE, 3))
        state = state_dict_from_jax({"params": jax.device_get(params),
                                     "batch_stats": jax.device_get(stats)}, "fastervit")
    assert fastervit_head_config(state) == want
    assert pick_head_config("fastervit", {}, state) == {"head_config": want}


def test_pinned_head_config_wins_and_other_families_are_untouched():
    tpu_state = {"levels.2.blocks.0.attn.rel_bias": torch.zeros(1)}
    assert pick_head_config("fastervit", {"head_config": "official"}, tpu_state) == {
        "head_config": "official"}
    assert pick_head_config("fastervit", {}, None) == {}
    assert pick_head_config("efficientnet", {"width": 1}, tpu_state) == {"width": 1}
