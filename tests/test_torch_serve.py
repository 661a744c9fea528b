"""The port's serving endpoint (deepfakedetection_tpu_torch/serve.py) on the
CPU, against the JAX package's root ``serve.py``.

Two models are served: the narrow B3 and narrow EfficientFormerV2 of
``tests/test_torch_predict.py`` (64 px, float32, ``device: cpu``), built in
both packages through ``get_model_spec`` monkeypatched, from one seeded tree
each carried by ``state_dict_from_jax``, with heads fitted so the
probabilities spread. The config's top-level ``ensemble:`` weighs B3 twice;
B3 takes ``threshold: auto`` and ``calibration: temperature`` from one
written ``metrics.jsonl``, EfficientFormerV2 a fixed threshold, the ensemble
``threshold: auto`` from its own record.

- ``predict_once`` on 12 JPEG images: the same labels and class indices, each
  model's and the ensemble's probabilities within 1e-4 [measured 8.5e-7];
  ``?model=`` and an unknown model the same in both.
- The decision settings resolve to the same values in both.
- The root ``MicroBatcher`` semantics (coalesce and pad, a concurrent stress,
  errors propagated, submit after stop fails fast, stop drains), as cases
  over both classes.
- The port's HTTP server: every endpoint, 32 concurrent clients with a mean
  batch above 1, ``/stats`` and ``/metrics`` in agreement, ``/reload`` 403 /
  200 with a token and 403 on a public bind without one; 64 clients
  connecting at once all answered (the root server's listen backlog of 5
  resets some).
- Warmup runs on each batcher's thread and counts nothing.
- A drain-first reload whose build fails leaves the server answering (a
  rebuilt state, or 503 with Retry-After while there is none); a second
  ``BatcherStopped`` answers 503.
- The native request decode against PIL and against the JAX binding.
- A config that asks for the card raises at startup where there is none.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import deepfakedetection_tpu.orchestrator as jax_orch
import deepfakedetection_tpu_torch.orchestrator as port_orch
import serve as jax_serve
from chip_smoke import prometheus_values
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch import serve as port_serve
from deepfakedetection_tpu_torch.data import native
from deepfakedetection_tpu_torch.data.augment import normalize_batch
from deepfakedetection_tpu_torch.data.decode import decode_pil_eval
from deepfakedetection_tpu_torch.data.pipeline import (
    build_eval_plan,
    make_eval_loader,
    scan_image_folder,
)
from deepfakedetection_tpu_torch.models.efficientformer_v2 import EfficientFormerV2
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
from deepfakedetection_tpu_torch.runtime.convert import state_dict_from_jax
from tests.test_torch_predict import B3, B3_NARROW, EF, EF_NARROW, EVAL, SIZE, _fit, _specs
from tests.test_torch_efficientformer_v2 import seeded_tree

TOKEN = "s3cret"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs (the suite runs a file a
    worker on a few cores; see ``tests/test_torch_predict.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def write_jpegs(root, counts: dict[str, int], seed: int) -> None:
    """``counts[split]`` JPEG images of 40-90 px a split, alternating between
    two class folders, each image of its own mean brightness."""
    rng = np.random.default_rng(seed)
    for split, n in counts.items():
        for i in range(n):
            d = root / split / ("fake", "real")[i % 2]
            d.mkdir(parents=True, exist_ok=True)
            h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
            arr = rng.normal(rng.uniform(40, 215), 40, (h, w, 3)).clip(0, 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"img_{i:03d}.jpg", quality=92)


def write_models(tmp, images) -> dict[str, object]:
    """The narrow B3's and EfficientFormerV2's ``.pth`` files under ``tmp``,
    heads fitted to the images under ``images``; their paths by name."""
    plan = build_eval_plan(SIZE, EVAL)
    batch = next(iter(make_eval_loader(scan_image_folder(images), plan, batch_size=64)))
    x = normalize_batch(torch.from_numpy(batch.images), plan)[batch.mask]
    b3 = EfficientNet(num_classes=2, dtype=torch.float32, **B3_NARROW).eval()
    params, stats = init_model_variables(
        JaxEfficientNet(num_classes=2, dtype=jnp.float32, **B3_NARROW), jax.random.key(0),
        (1, SIZE, SIZE, 3))
    b3.load_state_dict(state_dict_from_jax(
        {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}, "efficientnet"))
    _fit(b3, ("_fc",), x)
    ef = EfficientFormerV2(2, **EF_NARROW, img_size=SIZE, dtype=torch.float32).eval()
    ef.load_state_dict(state_dict_from_jax(
        seeded_tree(EF_NARROW, SIZE, np.random.default_rng(8)), "efficientformerv2"))
    _fit(ef, ("head", "head_dist"), x)
    paths = {}
    for name, model in ((B3, b3), (EF, ef)):
        paths[name] = tmp / f"{name}.pth"
        torch.save(model.state_dict(), paths[name])
    return paths


def model_block(tmp, name, weights, **inference):
    return {"output_dir": str(tmp / "runs" / name), "transforms": {"eval": EVAL},
            "inference": {"weights": str(weights), "img_size": SIZE, **inference}}


def _record(path, rec) -> None:
    path.mkdir(parents=True, exist_ok=True)
    with (path / "metrics.jsonl").open("a") as fh:
        fh.write(json.dumps(rec) + "\n")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The config, the 12 JPEG bodies, and the root ``serve.py``'s and the
    port's states built from it."""
    tmp = tmp_path_factory.mktemp("serve")
    write_jpegs(tmp / "images", {"test": 12}, seed=0)
    weights = write_models(tmp, tmp / "images" / "test")
    runs = tmp / "runs"
    _record(runs / B3 / "r1" / "logs", {"model": B3, "threshold": 0.3,
                                        "timestamp": "2026-08-17T10:00:00"})
    _record(runs / B3 / "r2" / "logs", {"model": B3, "threshold": 0.55, "temperature": 1.7,
                                        "timestamp": "2026-08-18T10:00:00"})
    _record(runs / "ensemble" / "r1" / "logs", {"model": "ensemble", "threshold": 0.45,
                                                "timestamp": "2026-08-18T11:00:00"})
    cfg = {"seed": 7, "device": "cpu", "precision": "float32",
           "data": {"root": str(tmp), "num_classes": 2, "img_size": SIZE},
           "models": {B3: model_block(tmp, B3, weights[B3], threshold="auto",
                                      calibration="temperature"),
                      EF: model_block(tmp, EF, weights[EF], threshold=0.4)},
           "selection": [B3, EF],
           "ensemble": {"weights": {B3: 2.0}, "threshold": "auto",
                        "output_dir": str(runs / "ensemble")}}
    path = tmp / "serve.yaml"
    path.write_text(yaml.safe_dump(cfg))
    bodies = [p.read_bytes() for p in sorted((tmp / "images").rglob("*.jpg"))]
    jax_specs, port_specs = _specs()
    precision = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")  # the batcher thread's too
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_orch, "get_model_spec", lambda name: jax_specs[name])
        mp.setattr(port_orch, "get_model_spec", lambda name: port_specs[name])
        states = {"jax": jax_serve.build_state(path, max_batch=8, max_wait_ms=2.0),
                  "port": port_serve.build_state(path, max_batch=8, max_wait_ms=2.0)}
    yield path, bodies, states
    jax.config.update("jax_default_matmul_precision", precision)
    for state in states.values():
        state.close()


@pytest.fixture()
def port_specs(monkeypatch):
    """The narrow specs for port states built inside a test (reloads)."""
    _, specs = _specs()
    monkeypatch.setattr(port_orch, "get_model_spec", lambda name: specs[name])


def _image(body: bytes) -> Image.Image:
    img = Image.open(io.BytesIO(body))
    img.load()
    return img


def test_predict_once_matches_the_jax_server(served):
    _, bodies, states = served
    spread = []
    for body in bodies:
        want = jax_serve.predict_once(states["jax"], _image(body), raw=body)
        got = port_serve.predict_once(states["port"], _image(body), raw=body)
        assert [r["model"] for r in got] == [r["model"] for r in want] == [B3, EF, "ensemble"]
        for g, w in zip(got, want):
            assert (g["label"], g["class_index"], g["display_name"]) == \
                (w["label"], w["class_index"], w["display_name"]), g["model"]
            np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-4, rtol=0)
            assert abs(g["confidence"] - w["confidence"]) <= 1e-4
        members = {r["model"]: np.asarray(r["probs"]) for r in got}
        np.testing.assert_allclose(members["ensemble"], (2 * members[B3] + members[EF]) / 3,
                                   atol=1e-12, rtol=0)
        spread.append(members[EF][1])
    assert np.ptp(spread) > 0.3  # the probabilities spread, so the labels say something

    body = bodies[0]
    want = jax_serve.predict_once(states["jax"], _image(body), EF, raw=body)
    got = port_serve.predict_once(states["port"], _image(body), EF, raw=body)
    assert [r["model"] for r in got] == [r["model"] for r in want] == [EF]
    np.testing.assert_allclose(got[0]["probs"], want[0]["probs"], atol=1e-4, rtol=0)
    for predict_once, state in ((jax_serve.predict_once, states["jax"]),
                                (port_serve.predict_once, states["port"])):
        with pytest.raises(KeyError):
            predict_once(state, _image(body), "nope", raw=body)


def test_threshold_auto_and_temperature_match_the_jax_server(served):
    _, _, states = served
    for state in states.values():
        assert [(m.name, m.threshold, m.temperature) for m in state.models] == \
            [(B3, 0.55, 1.7), (EF, 0.4, None)]  # B3's from the one calibrated record
        assert state.ensemble_enabled and state.ensemble_threshold == 0.45
        assert state.ensemble_weights == {B3: 2.0}
    assert port_serve.latest_sweep_threshold(served[0].parent / "runs" / B3) == 0.55
    assert port_serve.latest_metric_value(served[0].parent / "runs" / "missing", "x") is None


def test_bucket_and_warmup_buckets():
    assert [port_serve._bucket(n, 32) for n in (1, 2, 3, 5, 8, 9, 31, 32, 40)] == \
        [1, 2, 4, 8, 8, 16, 32, 32, 32]
    assert port_serve.warmup_buckets("none", 32) == []
    assert port_serve.warmup_buckets("first", 32) == [1]
    assert port_serve.warmup_buckets("all", 32) == [1, 2, 4, 8, 16, 32]
    assert port_serve.warmup_buckets("all", 24) == [1, 2, 4, 8, 16]


# ---------------------------------------------------------------- MicroBatcher

BATCHERS = pytest.mark.parametrize("cls", [jax_serve.MicroBatcher, port_serve.MicroBatcher],
                                   ids=["jax", "port"])


def _stopped_error(cls):
    return jax_serve.BatcherStopped if cls is jax_serve.MicroBatcher else port_serve.BatcherStopped


def _echo(batch: np.ndarray) -> np.ndarray:
    return np.stack([np.full((2,), a.mean(), np.float32) for a in batch])


@BATCHERS
def test_microbatcher_coalesces_and_pads(cls):
    seen: list[int] = []

    def runner(batch):
        assert batch.shape[0] & (batch.shape[0] - 1) == 0  # a power-of-two bucket
        seen.append(batch.shape[0])
        return _echo(batch)

    mb = cls(runner, max_batch=8, max_wait_ms=50.0, name="t")
    futs = [mb.submit(np.full((4, 4, 3), i, np.uint8)) for i in range(5)]
    assert [float(f.result(timeout=10)[0]) for f in futs] == [float(i) for i in range(5)]
    stats = mb.stats()
    assert stats["requests"] == 5 and stats["batches"] <= 5 and "latency_ms_p50" in stats
    assert all(b in (1, 2, 4, 8) for b in seen)
    assert 8 in seen  # five submissions within the window go out as one padded bucket
    mb.stop()


@BATCHERS
def test_microbatcher_concurrent_stress(cls):
    def runner(batch):
        time.sleep(0.002)  # overlapping windows
        return _echo(batch)

    mb = cls(runner, max_batch=8, max_wait_ms=3.0, name="stress")
    with ThreadPoolExecutor(max_workers=16) as ex:
        results = list(ex.map(
            lambda i: float(mb.submit(np.full((2, 2, 3), i % 251, np.uint8)).result(timeout=30)[0]),
            range(64)))
    assert results == [float(i % 251) for i in range(64)]
    assert mb.stats()["requests"] == 64
    mb.stop()


@BATCHERS
def test_microbatcher_propagates_runner_errors(cls):
    def runner(batch):
        raise RuntimeError("device on fire")

    mb = cls(runner, max_batch=4, max_wait_ms=1.0, name="err")
    with pytest.raises(RuntimeError, match="device on fire"):
        mb.submit(np.zeros((2, 2, 3), np.uint8)).result(timeout=10)
    mb.stop()


@BATCHERS
def test_microbatcher_submit_after_stop_fails_fast(cls):
    mb = cls(lambda b: np.zeros((b.shape[0], 2), np.float32), max_batch=4, max_wait_ms=1.0,
             name="stopped")
    mb.stop()
    t0 = time.perf_counter()
    with pytest.raises(_stopped_error(cls)):
        mb.submit(np.zeros((2, 2, 3), np.uint8))
    assert time.perf_counter() - t0 < 1.0
    mb.stop()  # idempotent


@BATCHERS
def test_microbatcher_stop_drains_queued_items(cls):
    def runner(batch):
        time.sleep(0.01)
        return _echo(batch)

    mb = cls(runner, max_batch=2, max_wait_ms=50.0, name="drain")
    futs = [mb.submit(np.full((2, 2, 3), i, np.uint8)) for i in range(7)]
    stopper = threading.Thread(target=mb.stop)
    stopper.start()
    assert [float(f.result(timeout=30)[0]) for f in futs] == [float(i) for i in range(7)]
    stopper.join(timeout=30)
    assert not stopper.is_alive()


def test_call_runs_between_batches_on_the_worker_thread():
    """``call`` (the warmup's route) runs on the batcher's thread, after the
    batch it interrupts, is not counted, and hands back its exception."""
    order: list[str] = []

    def runner(batch):
        order.append(f"batch {len(batch)}")
        return _echo(batch)

    mb = port_serve.MicroBatcher(runner, max_batch=4, max_wait_ms=50.0, name="calls")
    fut = mb.submit(np.zeros((2, 2, 3), np.uint8))
    call = mb.call(lambda: order.append(threading.current_thread().name) or 7)
    assert call.result(timeout=10) == 7 and fut.result(timeout=10).shape == (2,)
    assert order == ["batch 1", "batcher-calls"]
    with pytest.raises(ZeroDivisionError):
        mb.call(lambda: 1 / 0).result(timeout=10)
    assert mb.stats()["requests"] == 1
    mb.stop()
    with pytest.raises(port_serve.BatcherStopped):
        mb.call(lambda: None)


# ---------------------------------------------------------------- the port's server


class Server:
    """The port's HTTP server over ``state`` on a loopback port, on a thread."""

    def __init__(self, config, state, **kw):
        self.server = port_serve.build_server(config, port=0, state=state, **kw)
        self.handler = self.server.RequestHandlerClass
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        host, port = self.server.server_address[:2]
        self.base = f"http://{host}:{port}"

    def request(self, path, data=None, headers=None):
        """(status, headers, body bytes), errors included."""
        req = urllib.request.Request(self.base + path, data=data, headers=headers or {},
                                     method="GET" if data is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, resp.headers, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.headers, err.read()

    def json(self, path, data=None, headers=None):
        code, _, body = self.request(path, data, headers)
        return code, json.loads(body)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        if self.handler.state is not None:
            self.handler.state.close()


@pytest.fixture()
def server(served, port_specs):
    config = served[0]
    srv = Server(config, port_serve.build_state(config, max_batch=8, max_wait_ms=20.0),
                 max_batch=8, max_wait_ms=20.0, reload_token=TOKEN)
    yield srv
    srv.close()


def test_http_endpoints_and_concurrent_clients(served, server):
    _, bodies, _ = served
    code, health = server.json("/healthz")
    assert code == 200 and health == {"status": "ok", "models": [B3, EF]}

    code, raw = server.json("/predict", bodies[0])
    assert code == 200 and [r["model"] for r in raw["results"]] == [B3, EF, "ensemble"]
    code, b64 = server.json("/predict", json.dumps(
        {"image_b64": base64.b64encode(bodies[0]).decode()}).encode(),
        {"Content-Type": "application/json"})
    assert code == 200 and b64["results"] == raw["results"]
    code, one = server.json(f"/predict?model={EF}", bodies[0])
    assert code == 200 and [r["model"] for r in one["results"]] == [EF]
    assert one["results"][0]["probs"] == raw["results"][1]["probs"]
    assert server.json("/predict?model=nope", bodies[0])[0] == 404
    assert server.json("/predict", b"not an image")[0] == 400
    assert server.json("/nope")[0] == 404 and server.json("/nope", b"x")[0] == 404

    # 32 clients at once, two requests each, every fourth restricted to B3
    def client(i):
        return [server.request(f"/predict?model={B3}" if (i + k) % 4 == 0 else "/predict",
                               bodies[(i + k) % len(bodies)])[0] for k in range(2)]

    with ThreadPoolExecutor(max_workers=32) as ex:
        codes = [c for cs in ex.map(client, range(32)) for c in cs]
    assert codes == [200] * 64
    restricted = sum((i + k) % 4 == 0 for i in range(32) for k in range(2))
    code, stats = server.json("/stats")
    assert code == 200
    # before them: two full requests and one restricted to EfficientFormerV2
    assert stats[B3]["requests"] == 2 + 64 and stats[EF]["requests"] == 3 + 64 - restricted
    assert stats[B3]["mean_batch"] > 1 and stats[EF]["mean_batch"] > 1
    code, headers, body = server.request("/metrics")
    assert code == 200 and headers["Content-Type"].startswith("text/plain")
    metrics = prometheus_values(body.decode())  # chip_smoke.py phase 12's reader
    for name, s in stats.items():
        assert metrics[("dfd_requests_total", name)] == s["requests"]
        assert metrics[("dfd_batches_total", name)] == s["batches"]
        assert abs(metrics[("dfd_mean_batch_size", name)] - s["mean_batch"]) <= 1e-4
        for q, key in (("0.5", "latency_ms_p50"), ("0.99", "latency_ms_p99")):
            assert abs(metrics[(f"dfd_request_latency_ms_{q}", name)] - s[key]) <= 1e-4


def test_sixty_four_clients_at_once_are_all_answered():
    """64 client threads connecting at once, 16 requests each, against three
    batchers with a constant runner: every request answered 200 (the listen
    backlog of socketserver's default, 5, resets connections here)."""
    plan = build_eval_plan(SIZE, EVAL)

    def constant(batch):
        return np.tile(np.float32([[0.25, 0.75]]), (len(batch), 1))

    state = port_serve.ServeState(models=[
        port_serve.ServedModel(name, name, plan, port_serve.MicroBatcher(
            constant, max_batch=32, max_wait_ms=5.0, name=name)) for name in ("a", "b", "c")],
        ensemble_enabled=True)
    srv = Server(None, state)
    bodies = [io.BytesIO() for _ in range(4)]
    for i, buf in enumerate(bodies):
        Image.fromarray(np.full((48, 40, 3), 60 * i, np.uint8)).save(buf, format="JPEG")
    try:
        with ThreadPoolExecutor(max_workers=64) as ex:
            codes = list(ex.map(lambda i: srv.request("/predict", bodies[i % 4].getvalue())[0],
                                range(64 * 16)))
        assert codes == [200] * (64 * 16)
        assert sum(m.batcher.stats()["requests"] for m in state.models) == 3 * 64 * 16
    finally:
        srv.close()


def test_reload_token_gating(served, server):
    assert server.json("/reload", b"")[0] == 403
    assert server.json("/reload", b"", {"X-Reload-Token": "wrong"})[0] == 403
    before = server.handler.state
    code, out = server.json("/reload", b"", {"X-Reload-Token": TOKEN})
    assert code == 200 and out["status"] == "reloaded"
    assert out["models"] == {B3: {"threshold": 0.55, "temperature": 1.7},
                             EF: {"threshold": 0.4, "temperature": None}}
    assert server.handler.state is not before
    code, out = server.json("/reload", b"", {"Authorization": f"Bearer {TOKEN}"})
    assert code == 200
    assert server.json("/predict", served[1][0])[0] == 200
    # without a token, a public bind refuses /reload
    server.handler.reload_token = None
    server.handler.bind_host = "0.0.0.0"
    assert server.json("/reload", b"")[0] == 403
    server.handler.bind_host = "127.0.0.1"
    assert server.json("/reload", b"")[0] == 200


def test_warmup_runs_on_each_batchers_thread(served, port_specs):
    state = port_serve.build_state(served[0], max_batch=8, max_wait_ms=2.0)
    seen = []
    for m in state.models:
        m.batcher.runner = lambda b, run=m.batcher.runner: (
            seen.append((threading.current_thread().name, len(b))), run(b))[1]
    try:
        state.warmup("none")
        assert seen == []
        state.warmup("all")
        assert sorted(seen) == sorted((f"batcher-{name}", n) for name in (B3, EF)
                                      for n in (1, 2, 4, 8))
        assert all(m.batcher.stats()["requests"] == 0 for m in state.models)
    finally:
        state.close()


@pytest.mark.parametrize("failures", [1, 2], ids=["rebuilt", "none-left"])
def test_failed_drain_first_reload_leaves_the_server_answering(served, server, monkeypatch,
                                                              failures):
    """DFD_RELOAD_DRAIN_FIRST=1 with a build that raises: a failure is built
    once more; with a second failure the server has no state and answers 503
    with Retry-After until a reload succeeds (never the closed state's 500)."""
    monkeypatch.setenv("DFD_RELOAD_DRAIN_FIRST", "1")
    build, calls = port_serve.build_state, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) <= failures:
            raise RuntimeError("weights half written")
        return build(*args, **kwargs)

    monkeypatch.setattr(port_serve, "build_state", flaky)
    token = {"X-Reload-Token": TOKEN}
    body = served[1][0]
    if failures == 1:
        assert server.json("/reload", b"", token)[0] == 200
        assert server.json("/predict", body)[0] == 200
        return
    code, out = server.json("/reload", b"", token)
    assert code == 500 and "weights half written" in out["error"] and len(calls) == 2
    assert server.handler.state is None
    code, headers, _ = server.request("/predict", body)
    assert code == 503 and headers["Retry-After"] == str(port_serve.RETRY_AFTER_S)
    assert server.request("/healthz")[0] == 503 and server.request("/stats")[0] == 503
    assert server.json("/reload", b"", token)[0] == 200
    assert server.json("/predict", body)[0] == 200


def test_a_second_batcher_stopped_answers_503(served, server, monkeypatch):
    calls = []

    def stopped(*args, **kwargs):
        calls.append(1)
        raise port_serve.BatcherStopped("stopped")

    monkeypatch.setattr(port_serve, "predict_once", stopped)
    code, headers, body = server.request("/predict", served[1][0])
    assert code == 503 and headers["Retry-After"] == str(port_serve.RETRY_AFTER_S)
    assert len(calls) == 2 and "retry" in json.loads(body)["error"]


def test_native_request_decode_against_pil(served):
    """Native decode of request bodies: bit for bit the JAX binding's,
    within a few levels of PIL's, and PIL's own pixels for a format the
    library does not decode (BMP)."""
    if not native.has_buffer_batch():
        pytest.skip("native/libdfd_loader.so lacks dfd_decode_buffer_batch_rc")
    from deepfakedetection_tpu.data import native as jax_native

    plan = build_eval_plan(SIZE, EVAL)
    for body in served[1][:4]:
        got = port_serve._decode_request(plan, _image(body), body, True)
        want, status = jax_native.decode_buffer_batch([body], SIZE, n_threads=1,
                                                      resize_target=SIZE)
        assert int(status[0]) == 0
        np.testing.assert_array_equal(got, want[0])
        pil = decode_pil_eval(_image(body), plan)
        assert np.abs(got.astype(int) - pil.astype(int)).mean() < 2.0
    buf = io.BytesIO()
    _image(served[1][0]).save(buf, format="BMP")
    np.testing.assert_array_equal(
        port_serve._decode_request(plan, _image(buf.getvalue()), buf.getvalue(), True),
        decode_pil_eval(_image(buf.getvalue()), plan))


def test_a_config_that_asks_for_the_card_refuses_to_start(served, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = yaml.safe_load(served[0].read_text())
    cfg["device"] = "tpu"  # the shipped configs' value: the card
    path = tmp_path / "card.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        port_serve.build_state(path)
