"""The port's single-image surface (deepfakedetection_tpu_torch/predict.py
and web_ui.py) against the JAX package's root ``predict.py`` and
``web_ui.py``, on the CPU, on the same converted ``.pth`` files.

Two models are selected: a narrow B3 (width 0.25, depth 0.5) and a narrow
EfficientFormerV2 (dims (16, 24, 32, 48)), both at 64 px in float32, built
in both packages through ``get_model_spec`` monkeypatched, from one
seeded tree each (B3 a JAX init, EfficientFormerV2 numpy-seeded; carried by
``state_dict_from_jax``) with heads fitted along the
first principal direction of their features on the images, so the
probabilities spread. The config's top-level ``ensemble:`` weighs B3 twice.

- ``predict --json``: one record an image with the same labels, each
  model's and the ensemble's probabilities within 1e-4 [measured 1.0e-6, the
  records' sixth decimal] and confidences within 1e-2 points.
- ``predict --json --cam``: the summary lines of both CLIs name the same
  labels (confidences within 1e-2 points) and the ensemble line, and each
  writes a PNG; the port's is the triptych (two 64 px panels side by side)
  at ``EXPORT_SCALE``.
- ``predict_and_visualize`` returns the exported array and writes it.
- ``build_interface`` without gradio raises an error that names it.
"""

import dataclasses
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import deepfakedetection_tpu.orchestrator as jax_orch
import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu.models.efficientformer_v2 import EfficientFormerV2 as JaxEFv2
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.registry import get_model_spec as jax_model_spec
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch import predict as port_predict
from deepfakedetection_tpu_torch import web_ui as port_web_ui
from deepfakedetection_tpu_torch.data.augment import normalize_batch
from deepfakedetection_tpu_torch.data.pipeline import (
    build_eval_plan,
    make_eval_loader,
    scan_image_folder,
)
from deepfakedetection_tpu_torch.models.efficientformer_v2 import EfficientFormerV2
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
from deepfakedetection_tpu_torch.registry import get_model_spec as port_model_spec
from deepfakedetection_tpu_torch.runtime.convert import state_dict_from_jax
from tests.test_torch_efficientformer_v2 import NARROW as EF_NARROW
from tests.test_torch_efficientformer_v2 import seeded_tree

B3, EF = "efficientnet_b3", "efficientformerv2_s1"
B3_NARROW = dict(width_coefficient=0.25, depth_coefficient=0.5, native_resolution=32)
SIZE = 64
EVAL = {"ensure_rgb": True, "val_resize": True, "val_center_crop": True}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs one file a
    worker on a few cores, and the port's many small CPU ops slow down by
    an order of magnitude when every worker's pool spans every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _specs():
    jax_builders = {
        B3: lambda num_classes, dtype=jnp.bfloat16, **kw: JaxEfficientNet(
            num_classes=num_classes, dtype=dtype, **B3_NARROW),
        EF: lambda num_classes, dtype=jnp.bfloat16, **kw: JaxEFv2(
            num_classes=num_classes, dtype=dtype, **EF_NARROW),
    }
    port_builders = {
        B3: lambda num_classes, dtype=torch.bfloat16, generator=None, **kw: EfficientNet(
            num_classes=num_classes, dtype=dtype, generator=generator, **B3_NARROW),
        EF: lambda num_classes, dtype=torch.bfloat16, generator=None, img_size=224, **kw:
        EfficientFormerV2(num_classes, **EF_NARROW, img_size=img_size, dtype=dtype,
                          generator=generator),
    }
    return ({n: dataclasses.replace(jax_model_spec(n), builder=b) for n, b in jax_builders.items()},
            {n: dataclasses.replace(port_model_spec(n), builder=b)
             for n, b in port_builders.items()})


def _fit(model, heads, images):
    """Each head along the first principal direction of the model's f32
    features of ``images``, the logit difference at a standard deviation of
    2."""
    feats = []
    hook = getattr(model, heads[0]).register_forward_hook(
        lambda _m, inp, _o: feats.append(inp[0]))
    with torch.no_grad():
        model(images)
    hook.remove()
    f = feats[0].double()
    direction = torch.linalg.svd(f - f.mean(0), full_matrices=False).Vh[0]
    scale = 2.0 / float(((f - f.mean(0)) @ direction).std())
    with torch.no_grad():
        for name in heads:
            head = getattr(model, name)
            head.weight.copy_(torch.stack([torch.zeros_like(direction), scale * direction]))
            head.bias.copy_(torch.tensor([0.0, -scale * float(f.mean(0) @ direction)]))


def _write_images(root):
    """12 images of 40-90 px in two class folders, each of its own mean
    brightness: noise images of one brightness give a narrow random net
    near-identical features, and a head fitted to them cancels large terms."""
    rng = np.random.default_rng(0)
    for i in range(12):
        d = root / ("fake", "real")[i % 2]
        d.mkdir(parents=True, exist_ok=True)
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        arr = rng.normal(rng.uniform(40, 215), 40, (h, w, 3)).clip(0, 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img_{i:03d}.png")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The two ``.pth`` files, the config that selects both models and the
    images."""
    tmp = tmp_path_factory.mktemp("predict")
    _write_images(tmp / "images")
    plan = build_eval_plan(SIZE, EVAL)
    batch = next(iter(make_eval_loader(scan_image_folder(tmp / "images"), plan, batch_size=32)))
    images = normalize_batch(torch.from_numpy(batch.images), plan)[batch.mask]
    b3 = EfficientNet(num_classes=2, dtype=torch.float32, **B3_NARROW).eval()
    params, stats = init_model_variables(
        JaxEfficientNet(num_classes=2, dtype=jnp.float32, **B3_NARROW), jax.random.key(0),
        (1, SIZE, SIZE, 3))
    b3.load_state_dict(state_dict_from_jax(
        {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}, "efficientnet"))
    _fit(b3, ("_fc",), images)
    ef = EfficientFormerV2(2, **EF_NARROW, img_size=SIZE, dtype=torch.float32).eval()
    tree = seeded_tree(EF_NARROW, SIZE, np.random.default_rng(8))
    ef.load_state_dict(state_dict_from_jax(tree, "efficientformerv2"))
    _fit(ef, ("head", "head_dist"), images)
    models = {}
    for name, model in ((B3, b3), (EF, ef)):
        torch.save(model.state_dict(), tmp / f"{name}.pth")
        models[name] = {"output_dir": str(tmp / "runs" / name), "transforms": {"eval": EVAL},
                        "inference": {"weights": str(tmp / f"{name}.pth"), "img_size": SIZE}}
    cfg = {"seed": 7, "device": "cpu", "precision": "float32",
           "data": {"root": str(tmp), "num_classes": 2, "img_size": SIZE},
           "models": models, "selection": [B3, EF], "ensemble": {"weights": {B3: 2.0}}}
    path = tmp / "predict.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, tmp / "images", tmp


@pytest.fixture()
def both(setup, monkeypatch, tmp_path):
    """The JAX package's root ``predict`` and ``web_ui`` and the port's, with
    the narrow specs and their exports under ``tmp_path``."""
    import predict as jax_predict
    import web_ui as jax_web_ui

    jax_specs, port_specs = _specs()
    monkeypatch.setattr(jax_orch, "get_model_spec", lambda name: jax_specs[name])
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: port_specs[name])
    monkeypatch.setattr(jax_predict, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(jax_web_ui, "EXPORT_DIR", tmp_path / "jax_exports")
    monkeypatch.setattr(port_web_ui, "EXPORT_DIR", tmp_path / "port_exports")
    for ui in (jax_web_ui, port_web_ui):  # the globals initialize_from_config sets
        for name in ("MODEL_CACHE", "ENSEMBLE_CFG", "CLASS_LABELS"):
            monkeypatch.setattr(ui, name, getattr(ui, name))
    return jax_predict, setup


def _jax_main(jax_predict, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["predict.py", *argv])
    with jax.default_matmul_precision("highest"):
        jax_predict.main()
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def _port_main(argv, capsys):
    port_predict.main(argv)
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_predict_json_records_match_jax(both, monkeypatch, capsys):
    jax_predict, (cfg, images, _) = both
    argv = ["--config", str(cfg), "--input", str(images), "--json"]
    want = _jax_main(jax_predict, argv, monkeypatch, capsys)
    got = _port_main(argv, capsys)
    assert len(got) == len(want) == 12
    spread = []
    for g, w in zip(got, want):
        assert g["image"] == w["image"]
        assert list(g["predictions"]) == list(w["predictions"]) == [B3, EF, "ensemble"]
        for name, wp in w["predictions"].items():
            gp = g["predictions"][name]
            assert gp["label"] == wp["label"], (g["image"], name)
            np.testing.assert_allclose(gp["probs"], wp["probs"], atol=1e-4, rtol=0)
            assert abs(gp["confidence"] - wp["confidence"]) <= 1e-2 + 1e-9
            spread.append(wp["probs"][1])
    assert np.ptp(spread) > 0.3  # the probabilities spread, so the labels say something


def _summary_parts(lines):
    return [re.match(r"(.*): (\w+) \(([\d.]+)% confidence\)", x).groups() for x in lines[:-1]]


def test_predict_cam_summaries_match_jax_and_write_the_triptych(both, monkeypatch, capsys,
                                                               tmp_path):
    jax_predict, (cfg, images, _) = both
    one = sorted(images.rglob("*.png"))[0]
    argv = ["--config", str(cfg), "--input", str(one), "--json", "--cam"]
    (want,) = _jax_main(jax_predict, argv, monkeypatch, capsys)
    (got,) = _port_main(argv, capsys)
    assert got["image"] == want["image"] == str(one)
    got_parts, want_parts = _summary_parts(got["summary"]), _summary_parts(want["summary"])
    assert [p[:2] for p in got_parts] == [p[:2] for p in want_parts]
    assert [p[0] for p in got_parts] == [B3, EF, "Ensemble"]
    for g, w in zip(got_parts, want_parts):
        assert abs(float(g[2]) - float(w[2])) <= 1e-2 + 1e-9
    png = got["summary"][-1].removeprefix("Saved: ")
    assert png.startswith(str(tmp_path / "port_exports"))
    with Image.open(png) as img:
        size = img.size
    assert size == (2 * SIZE * port_web_ui.EXPORT_SCALE, SIZE * port_web_ui.EXPORT_SCALE)
    assert list((tmp_path / "jax_exports").glob("*.png"))


def test_predict_and_visualize_writes_the_png(both, tmp_path):
    _, (cfg, images, _) = both
    port_web_ui.initialize_from_config(cfg)
    with Image.open(sorted(images.rglob("*.png"))[-1]) as img:
        arr, summary = port_web_ui.predict_and_visualize(img.copy())
    scale = port_web_ui.EXPORT_SCALE
    assert arr.shape == (SIZE * scale, 2 * SIZE * scale, 3) and arr.dtype == np.uint8
    lines = summary.splitlines()
    assert len(lines) == 4 and lines[2].startswith("Ensemble: ")
    path = lines[-1].removeprefix("Saved: ")
    with Image.open(path) as saved:
        np.testing.assert_array_equal(np.asarray(saved), arr)


def test_build_interface_without_gradio_names_the_package(monkeypatch, setup):
    monkeypatch.setitem(sys.modules, "gradio", None)  # an import of it raises ImportError
    with pytest.raises(RuntimeError, match="'gradio' package"):
        port_web_ui.build_interface(setup[0])


@pytest.mark.parametrize("raw,want", [
    (None, None), (False, None), (True, {}), ({"enabled": False}, None),
    ({"weights": {B3: 2.0}}, {"weights": {B3: 2.0}}),
])
def test_ensemble_settings_and_the_batch_jobs_refusal(raw, want, setup, tmp_path, monkeypatch):
    """``ensemble:`` as predict and the web UI read it; the batch job no
    longer refuses an enabled ensemble: it evaluates both models over the
    images and writes the ensemble's record to ``runs/ensemble/<ts>/``
    (``tests/test_torch_ensemble.py`` holds that record to the JAX
    package's)."""
    assert port_orch.ensemble_settings({"ensemble": raw}) == want
    cfg = yaml.safe_load(setup[0].read_text())
    cfg["ensemble"] = raw
    if raw is None:
        del cfg["ensemble"]
    cfg["data"]["test_split"] = "images"
    for name, block in cfg["models"].items():
        block["output_dir"] = str(tmp_path / "runs" / name)
    path = tmp_path / "e.yaml"
    path.write_text(yaml.safe_dump(cfg))
    if want is not None:
        _, port_specs = _specs()
        monkeypatch.setattr(port_orch, "get_model_spec", lambda name: port_specs[name])
        monkeypatch.chdir(tmp_path)  # the default ensemble output_dir, runs/ensemble
        results = port_orch.orchestrate(path, mode="inference")
        assert list(results) == [B3, EF]
        (run,) = sorted((tmp_path / "runs" / "ensemble").iterdir())
        record = json.loads((run / "logs" / "metrics.jsonl").read_text().splitlines()[-1])
        assert record["model"] == "ensemble" and record["members"] == [B3, EF]
        assert record.get("weights") == ({B3: 2.0, EF: 1.0} if want else None)
