"""``python -m deepfakedetection_tpu_torch.bench`` against the root ``bench.py``.

``bench_eval`` and ``bench_train`` run small on the CPU (B3 at 32 px, batch
2, one step; int8, TTA, EMA and mixup too); every metric name, and the
batch and step counts handed to the bench functions, equal ``bench.py``'s for
the same flags (both mains with their bench functions stubbed); ``bench.py``'s
refusals are the port's, FasterViT's ``--conv-remat`` and
``--pad-conv-stages`` among them (their variants' metric suffixes are
``bench.py``'s too, and the model gets their keyword arguments), and the
port also refuses ``--compiler-option``, naming why; a run prints one JSON
line with ``vs_baseline: null``.
"""

import functools
import json
import math

import pytest
import torch

import bench as jax_bench
from deepfakedetection_tpu_torch import bench

SMALL = dict(img_size=32, batch=2, steps=1, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (as tests/test_torch_cam.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("opts", [{}, {"int8": True}, {"tta": True}], ids=["bf16", "int8", "tta"])
def test_bench_eval_runs_small_on_the_cpu(opts):
    img_s = bench.bench_eval("efficientnet_b3", **SMALL, **opts)
    assert math.isfinite(img_s) and img_s > 0


@pytest.mark.parametrize("opts", [{}, {"ema_decay": 0.999, "mixup": True}], ids=["plain", "ema_mixup"])
def test_bench_train_runs_small_on_the_cpu(opts):
    img_s = bench.bench_train("efficientnet_b3", **SMALL, **opts)
    assert math.isfinite(img_s) and img_s > 0


FLAGS = [
    [], ["--official", "--model", "faster_vit_2_224"], ["--model", "efficientformerv2_s1"],
    ["--int8"], ["--tta"], ["--int8", "--tta", "--batch", "64", "--steps", "7"],
    ["--mode", "train"], ["--mode", "train", "--ema", "0.999"], ["--mode", "train", "--mixup"],
    ["--mode", "train", "--ema", "0.99", "--mixup", "--steps", "30", "--batch", "32"],
    ["--mode", "train", "--steps", "3", "--official", "--model", "faster_vit_2_224"],
    ["--mode", "train", "--model", "faster_vit_2_224", "--conv-remat"],
    ["--mode", "train", "--model", "faster_vit_2_224", "--conv-remat", "save-conv", "--official",
     "--pad-conv-stages", "--ema", "0.99"],
    ["--model", "faster_vit_2_224", "--pad-conv-stages", "--int8"],
]


def _run(module, argv, monkeypatch, capsys):
    """The metric line and the (model, batch, steps) the bench function was
    handed, with ``bench_eval`` / ``bench_train`` stubbed."""
    calls = []

    def stub(model, batch, steps, *_a, **kw):
        calls.append((model, batch, steps, kw.get("model_kwargs")))
        return 123.45

    monkeypatch.setattr(module, "bench_eval", stub)
    monkeypatch.setattr(module, "bench_train", stub)
    if module is jax_bench:
        monkeypatch.setattr("sys.argv", ["bench.py", *argv])
        monkeypatch.setattr("deepfakedetection_tpu.runtime.compile_cache.enable", lambda: None)
        module.main()
    else:
        module.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0]), calls


@pytest.mark.parametrize("argv", FLAGS, ids=[" ".join(f) or "default" for f in FLAGS])
def test_metric_names_and_arguments_are_bench_pys(argv, monkeypatch, capsys):
    want, want_calls = _run(jax_bench, argv, monkeypatch, capsys)
    got, got_calls = _run(bench, argv, monkeypatch, capsys)
    assert got["metric"] == want["metric"]
    assert got_calls == want_calls
    assert got["value"] == want["value"] == 123.5
    assert got["unit"] == want["unit"] == "img/s/chip"
    assert got["vs_baseline"] is None


VARIANTS = [
    (["--conv-remat"], "train_throughput_224px_faster_vit_2_224_convremat",
     {"conv_remat": "full"}),
    (["--conv-remat", "save-conv", "--ema", "0.99"],
     "train_throughput_224px_faster_vit_2_224_convrematsc_ema", {"conv_remat": "save-conv"}),
    (["--official", "--pad-conv-stages", "--mixup"],
     "train_throughput_224px_faster_vit_2_224_official_padconv_mixup",
     {"head_config": "official", "conv_stage_dims": (128, 256)}),
]


@pytest.mark.parametrize("argv,metric,kwargs", VARIANTS, ids=[" ".join(a) for a, _, _ in VARIANTS])
def test_fastervit_variant_suffixes(argv, metric, kwargs, monkeypatch, capsys):
    got, calls = _run(bench, ["--mode", "train", "--model", "faster_vit_2_224", *argv],
                      monkeypatch, capsys)
    assert got["metric"] == metric and calls == [("faster_vit_2_224", 128, 10, kwargs)]


SHARED_REFUSALS = [
    (["--int8", "--mode", "train"], "eval-only"),
    (["--ema", "0.99"], "training mode"),
    (["--tta", "--mode", "train"], "eval-only"),
    (["--mixup"], "train-only"),
    (["--conv-remat", "--mode", "train"], "FasterViT option"),
    (["--conv-remat", "save-conv", "--model", "faster_vit_2_224"], "train mode"),
    (["--pad-conv-stages"], "benchmark variant"),
]
PORT_REFUSALS = [
    (["--compiler-option", "xla_tpu_scoped_vmem_limit_kib=65536"], "CompileOptions"),
]


@pytest.mark.parametrize("argv,reason", SHARED_REFUSALS + PORT_REFUSALS,
                         ids=[" ".join(a) for a, _ in SHARED_REFUSALS + PORT_REFUSALS])
def test_refusals(argv, reason, monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        bench.parse_args(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert reason in err
    if (argv, reason) in SHARED_REFUSALS:
        monkeypatch.setattr("sys.argv", ["bench.py", *argv])
        monkeypatch.setattr("deepfakedetection_tpu.runtime.compile_cache.enable", lambda: None)
        with pytest.raises(SystemExit):
            jax_bench.main()
        assert capsys.readouterr().err.split("error: ")[1] == err.split("error: ")[1]


def test_one_json_line(capsys, monkeypatch):
    """A whole run (the CPU at 32 px standing in for the card) prints one
    JSON line."""
    monkeypatch.setattr(bench, "bench_eval",
                        functools.partial(bench.bench_eval, img_size=32, device="cpu"))
    bench.main(["--batch", "2", "--steps", "1"])
    (line,) = capsys.readouterr().out.strip().splitlines()
    out = json.loads(line)
    assert out["metric"] == "eval_throughput_224px_efficientnet_b3"
    assert out["unit"] == "img/s/chip" and out["vs_baseline"] is None and out["value"] > 0


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.bench_eval("efficientnet_b3", img_size=32, batch=2, steps=1)
