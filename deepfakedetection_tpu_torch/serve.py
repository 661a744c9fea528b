"""HTTP serving endpoint with dynamic micro-batching, on PyTorch.

Port of the root ``serve.py``, with its names, endpoints and flags:

- **dynamic micro-batching**: concurrent requests are coalesced into one
  device step (the first request opens a window of ``--max-wait-ms``; the
  batch closes at ``--max-batch`` or at the deadline, whichever is first);
- **padded batch buckets**: a batch is zero-padded up to a power of two, so
  the models see at most log2(max_batch) + 1 batch shapes;
- **per-model fan-out** with the prediction semantics of the web UI (softmax
  confidence and class label), the optional binary decision threshold
  ``inference.threshold`` (``p(class 1) >= t``, or ``auto``: the newest eval
  sweep's), ``inference.calibration: temperature`` (the same eval record's
  fitted T), and with a top-level ``ensemble:`` the weighted mean of the
  members (``evaluate/ensemble.weighted_mean``).

Endpoints::

    POST /predict            body = raw image bytes (any PIL format), or
                             JSON {"image_b64": "..."}; optional
                             ?model=<name> restricts to one model
    POST /reload             rebuild the models, thresholds and temperatures
                             (token-gated, or loopback binds only)
    GET  /healthz            liveness + loaded models
    GET  /stats              request/batch counters, latency percentiles
    GET  /metrics            the same in Prometheus text format

Run from the repository root::

    python -m deepfakedetection_tpu_torch.serve --config config/inference.yaml --port 8000
    curl --data-binary @photo.jpg http://localhost:8000/predict

The YAML's ``device`` decides where the models run (``resolve_device``): the
CUDA card unless it says ``cpu``; the server refuses to start when the card
is asked for and there is none. Each model's runner copies the uint8 bucket
to the device through pinned host buffers, normalises it and runs the eval
job's own ``make_eval_step`` in the job's compute dtype, so a served
probability is the batch job's for the same image. All work stays on the
current CUDA stream. Warmup runs on each batcher's own thread, where the
requests will run (PyTorch keeps its cuBLAS and cuDNN handles per thread).
"""

from __future__ import annotations

import argparse
import base64
import gc
import hmac
import io
import json
import os
import queue
import signal
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from PIL import Image

from deepfakedetection_tpu_torch.config import load_config
from deepfakedetection_tpu_torch.data import native
from deepfakedetection_tpu_torch.data.augment import normalize_batch
from deepfakedetection_tpu_torch.data.decode import decode_pil_eval
from deepfakedetection_tpu_torch.data.pipeline import DeviceStager
from deepfakedetection_tpu_torch.data.transforms import (
    EvalTransformPlan,
    build_eval_plan,
    resolve_transform_mapping,
)
from deepfakedetection_tpu_torch.evaluate.ensemble import weighted_mean
from deepfakedetection_tpu_torch.evaluate.job import load_model_for_eval, make_eval_step
from deepfakedetection_tpu_torch.evaluate.metrics import apply_temperature
from deepfakedetection_tpu_torch.orchestrator import build_eval_job, ensemble_settings
from deepfakedetection_tpu_torch.runtime.flags import resolve_device
from deepfakedetection_tpu_torch.runtime.paths import ensure_run_dirs

DEFAULT_CONFIG_PATH = Path("config/inference.yaml")
RETRY_AFTER_S = 1  # the Retry-After of a 503 while a reload swaps the models


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class BatcherStopped(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` after :meth:`MicroBatcher.stop`.

    A request thread that captured the state from before a reload can reach
    a batcher whose worker has stopped; it fails at once rather than waiting
    on a Future nobody resolves, and the handler retries on the current
    state."""


class _Call:
    """A function the worker runs between batches, its result in ``future``."""

    def __init__(self, fn: Callable[[], Any]) -> None:
        self.fn = fn
        self.future: Future = Future()

    def run(self) -> None:
        try:
            self.future.set_result(self.fn())
        except Exception as exc:  # handed to the caller through the future
            self.future.set_exception(exc)


class MicroBatcher:
    """Coalesce concurrent submissions into padded device batches.

    ``runner`` maps a uint8 [N, S, S, 3] array (N a power-of-two bucket) to
    a [N, C] float array of class probabilities. One daemon thread drains
    the queue: the first item opens a ``max_wait_ms`` window, the batch
    closes at ``max_batch`` items or the deadline. ``call`` runs a function
    on that thread between batches (the warmup) without counting it.
    """

    def __init__(
        self,
        runner: Callable[[np.ndarray], np.ndarray],
        *,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        name: str = "model",
    ) -> None:
        self.runner = runner
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.name = name
        self._q: queue.Queue[tuple[np.ndarray, Future] | _Call | None] = queue.Queue()
        self._lock = threading.Lock()
        # "check stopped, enqueue" and "set stopped, enqueue the sentinel" are
        # atomic against each other, so no item ever follows the sentinel
        self._submit_lock = threading.Lock()
        self._stopped = False
        self.n_requests = 0
        self.n_batches = 0
        self.batch_sizes: deque[int] = deque(maxlen=1024)
        self.latencies_ms: deque[float] = deque(maxlen=1024)
        self._thread = threading.Thread(target=self._worker, name=f"batcher-{name}", daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        with self._submit_lock:
            if self._stopped:
                raise BatcherStopped(f"batcher {self.name!r} is stopped (state was reloaded)")
            self._q.put(item)

    def submit(self, arr: np.ndarray) -> Future:
        fut: Future = Future()
        fut._t0 = time.perf_counter()  # type: ignore[attr-defined]
        self._put((arr, fut))
        return fut

    def call(self, fn: Callable[[], Any]) -> Future:
        """Run ``fn`` on the worker thread; its result or exception in the
        returned Future."""
        item = _Call(fn)
        self._put(item)
        return item.future

    def stop(self) -> None:
        with self._submit_lock:
            if self._stopped:
                return
            self._stopped = True
            self._q.put(None)
        self._thread.join(timeout=5)

    def _worker(self) -> None:
        while True:
            head = self._q.get()
            if head is None:
                return
            if isinstance(head, _Call):
                head.run()
                continue
            items, call = [head], None
            deadline = time.perf_counter() + self.max_wait_s
            while len(items) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(items)
                    return
                if isinstance(nxt, _Call):
                    call = nxt
                    break
                items.append(nxt)
            self._flush(items)
            if call is not None:
                call.run()

    def _flush(self, items: list[tuple[np.ndarray, Future]]) -> None:
        arrs = [a for a, _ in items]
        futs = [f for _, f in items]
        n = len(arrs)
        padded_n = _bucket(n, self.max_batch)
        batch = np.stack(arrs).astype(np.uint8)
        if padded_n > n:
            pad = np.zeros((padded_n - n, *batch.shape[1:]), np.uint8)
            batch = np.concatenate([batch, pad])
        try:
            probs = np.asarray(self.runner(batch))[:n]
        except Exception as exc:  # handed to every waiter
            for f in futs:
                if not f.cancelled():
                    f.set_exception(exc)
            return
        now = time.perf_counter()
        with self._lock:
            self.n_requests += n
            self.n_batches += 1
            self.batch_sizes.append(n)
            for f in futs:
                self.latencies_ms.append((now - getattr(f, "_t0", now)) * 1e3)
        for f, p in zip(futs, probs):
            if not f.cancelled():
                f.set_result(np.asarray(p))

    def stats(self) -> dict[str, Any]:
        with self._lock:
            lats = sorted(self.latencies_ms)
            sizes = list(self.batch_sizes)
            out = {
                "requests": self.n_requests,
                "batches": self.n_batches,
                "mean_batch": (sum(sizes) / len(sizes)) if sizes else 0.0,
            }
            if lats:
                out["latency_ms_p50"] = lats[len(lats) // 2]
                out["latency_ms_p99"] = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
            return out


@dataclass
class ServedModel:
    """One loaded model, its preprocessing plan and its batcher."""

    name: str
    display_label: str
    plan: EvalTransformPlan
    batcher: MicroBatcher
    threshold: float | None = None
    # inference.calibration: temperature -> the newest calibrated eval run's
    # fitted T; probabilities are served calibrated, as that run's sweep saw them
    temperature: float | None = None


def warmup_buckets(mode: str, max_batch: int) -> list[int]:
    """``first``: bucket 1; ``all``: every power of two up to ``max_batch``;
    ``none``: nothing."""
    if mode == "none":
        return []
    buckets = [1]
    while mode == "all" and buckets[-1] * 2 <= max_batch:
        buckets.append(buckets[-1] * 2)
    return buckets


@dataclass
class ServeState:
    models: list[ServedModel]
    class_labels: dict[int, str] = field(default_factory=lambda: {0: "fake", 1: "real"})
    # the top-level ``ensemble:`` key: the weighted mean over the fan-out
    ensemble_weights: dict[str, float] | None = None
    ensemble_enabled: bool = False
    ensemble_threshold: float | None = None
    # decode request bodies with the native library (--native-decode /
    # DFD_NATIVE_EVAL=1); a body it cannot decode goes through PIL
    native_decode: bool = False

    def by_name(self, name: str) -> ServedModel | None:
        for m in self.models:
            if m.name == name:
                return m
        return None

    def close(self) -> None:
        """Stop every model's batcher thread (queued batches are served first)."""
        for m in self.models:
            m.batcher.stop()

    def warmup(self, mode: str = "first") -> None:
        """Run each bucket of ``warmup_buckets(mode)`` once through every
        model on its batcher's thread, all models at once, and wait: the
        first request then finds the kernel library loaded, the models'
        derived caches filled and the thread's cuBLAS and cuDNN handles
        made. Warmups are not counted in the stats."""
        calls = []
        for m in self.models:
            size = m.plan.img_size
            for n in warmup_buckets(mode, m.batcher.max_batch):
                zeros = np.zeros((n, size, size, 3), np.uint8)
                calls.append(m.batcher.call(lambda r=m.batcher.runner, z=zeros: r(z)))
        for fut in calls:
            fut.result()


def latest_metric_record(output_dir: Path, key: str) -> dict | None:
    """Newest eval metrics record carrying ``key``, whole, from
    ``<output_dir>/*/logs/metrics.jsonl``, so that correlated values
    (threshold and temperature) come from one eval run."""
    best: tuple[str, dict] | None = None
    for metrics_file in sorted(Path(output_dir).glob("*/logs/metrics.jsonl")):
        try:
            lines = metrics_file.read_text().splitlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if key in rec and rec[key] is not None:
                stamp = str(rec.get("timestamp", ""))
                if best is None or stamp >= best[0]:
                    best = (stamp, rec)
    return best[1] if best else None


def latest_metric_value(output_dir: Path, key: str) -> float | None:
    """Newest value of ``key`` across the model's eval metrics records."""
    rec = latest_metric_record(output_dir, key)
    return float(rec[key]) if rec else None


def latest_sweep_threshold(output_dir: Path) -> float | None:
    """Newest decision threshold the eval job's 501-point sweep logged."""
    return latest_metric_value(output_dir, "threshold")


def make_runner(eval_step, plan: EvalTransformPlan, device: torch.device,
                dtype: torch.dtype) -> Callable[[np.ndarray], np.ndarray]:
    """A batcher's runner: the uint8 bucket to ``device`` through pinned
    buffers (one set a bucket size), ``normalize_batch`` in ``dtype``, the
    eval step, float32 probabilities back on the host."""
    stagers: dict[int, DeviceStager] = {}

    def runner(batch_u8: np.ndarray) -> np.ndarray:
        stager = stagers.setdefault(len(batch_u8), DeviceStager(device))
        x = normalize_batch(stager(batch_u8), plan, out_dtype=dtype)
        return eval_step(x).float().cpu().numpy()

    return runner


def _decision(model_name: str, infer_cfg: dict[str, Any],
              out_dir: Path) -> tuple[float | None, float | None]:
    """(threshold, temperature) of a model: a fixed ``inference.threshold``
    or ``auto``, and with ``calibration: temperature`` the newest calibrated
    eval record's T and, for ``auto``, that record's threshold."""
    thr = infer_cfg.get("threshold")
    temperature = None
    want_calibration = str(infer_cfg.get("calibration") or "").lower() == "temperature"
    calib_rec = latest_metric_record(out_dir, "temperature") if want_calibration else None
    if want_calibration:
        temperature = float(calib_rec["temperature"]) if calib_rec else None
        print(f"[serve] {model_name}: temperature "
              + (f"{temperature:.4f} (from latest calibrated eval)" if temperature is not None
                 else "calibration requested but no calibrated eval record found — "
                      "serving uncalibrated"))
    if isinstance(thr, str) and thr.lower() == "auto":
        # a sweep on calibrated val probabilities pairs only with that run's T
        if calib_rec is not None and calib_rec.get("threshold") is not None:
            thr = float(calib_rec["threshold"])
            print(f"[serve] {model_name}: threshold {thr:.4f} "
                  "(from the same calibrated eval record)")
        else:
            thr = latest_sweep_threshold(out_dir)
            if want_calibration and thr is not None and temperature is not None:
                print(f"[serve] ⚠ {model_name}: threshold taken from a different "
                      "(uncalibrated) record than the temperature")
            print(f"[serve] {model_name}: threshold "
                  + (f"{thr:.4f} (from latest eval sweep)" if thr is not None
                     else "auto requested but no sweep record found — using argmax"))
    return (float(thr) if thr is not None else None), temperature


def build_state(
    config_path: Path,
    *,
    max_batch: int = 32,
    max_wait_ms: float = 5.0,
    native_decode: bool | None = None,
) -> ServeState:
    """Load every selected model of an inference YAML through the eval job's
    own chain (``build_eval_job``: img_size fallbacks, weights, head
    configuration; ``load_model_for_eval``) on the YAML's device, each
    behind its own batcher."""
    config = load_config(config_path)
    device = resolve_device(config)
    labels_cfg = config.get("data", {}).get("class_labels")
    class_labels = {0: "fake", 1: "real"}
    if isinstance(labels_cfg, dict):
        class_labels = {int(k): str(v) for k, v in labels_cfg.items()}
    models_cfg: dict[str, dict[str, Any]] = config.get("models", {})
    selection: list[str] = config.get("selection") or list(models_cfg.keys())

    served: list[ServedModel] = []
    for model_name in selection:
        model_cfg = models_cfg.get(model_name)
        if not isinstance(model_cfg, dict):
            print(f"[serve] Skipping unknown model '{model_name}' in selection.")
            continue
        out_dir = Path(model_cfg.get("output_dir") or f"runs/{model_name}")
        job = build_eval_job(config, model_name, dict(model_cfg, name=model_name),
                             ensure_run_dirs(out_dir, run_id="serve"), device)
        plan = build_eval_plan(job.img_size, resolve_transform_mapping(model_cfg, "eval"))
        model = load_model_for_eval(job)
        runner = make_runner(make_eval_step(model, tta=job.tta), plan, device, job.compute_dtype)
        threshold, temperature = _decision(model_name, model_cfg.get("inference") or {}, out_dir)
        served.append(ServedModel(
            name=model_name,
            display_label=str(model_cfg.get("display_name") or model_cfg.get("label")
                              or model_name),
            plan=plan,
            batcher=MicroBatcher(runner, max_batch=max_batch, max_wait_ms=max_wait_ms,
                                 name=model_name),
            threshold=threshold,
            temperature=temperature,
        ))
    if not served:
        raise RuntimeError("No valid models configured for serving.")

    ens_cfg = ensemble_settings(config)
    ens_threshold = None
    if ens_cfg is not None:
        thr = ens_cfg.get("threshold")
        if isinstance(thr, str) and thr.lower() == "auto":
            thr = latest_sweep_threshold(Path(ens_cfg.get("output_dir") or "runs/ensemble"))
            print("[serve] ensemble: threshold "
                  + (f"{thr:.4f} (from latest ensemble sweep)" if thr is not None
                     else "auto requested but no sweep record found — using argmax"))
        ens_threshold = float(thr) if thr is not None else None
    if native_decode is None:
        native_decode = os.environ.get("DFD_NATIVE_EVAL") == "1"
    native_decode = bool(native_decode) and native.available() and native.has_buffer_batch()
    if native_decode:
        print("[serve] native request decode enabled (C++ JPEG/PNG path)")
    return ServeState(
        models=served,
        class_labels=class_labels,
        ensemble_weights=(ens_cfg or {}).get("weights"),
        ensemble_enabled=ens_cfg is not None,
        ensemble_threshold=ens_threshold,
        native_decode=native_decode,
    )


def _decode_request(plan: EvalTransformPlan, image: Image.Image, raw: bytes | None,
                    native_decode: bool) -> np.ndarray:
    """One request's pixels for one model's plan: the native library when
    enabled and it decodes the bytes (JPEG/PNG, status 0), PIL otherwise."""
    if native_decode and raw is not None:
        out, status = native.decode_buffer_batch(
            [raw], plan.img_size, n_threads=1, resize_target=plan.resize_size or plan.img_size)
        if int(status[0]) == 0:
            return out[0]
    return decode_pil_eval(image, plan)


def _scored(name: str, display: str, probs: np.ndarray, threshold: float | None,
            class_labels: dict[int, str]) -> dict[str, Any]:
    if threshold is not None and probs.shape[-1] == 2:
        cls_idx = int(probs[1] >= threshold)
    else:
        cls_idx = int(probs.argmax())
    return {
        "model": name,
        "display_name": display,
        "label": class_labels.get(cls_idx, f"class_{cls_idx}"),
        "class_index": cls_idx,
        "confidence": float(probs[cls_idx]),
        "probs": [float(p) for p in probs],
    }


def predict_once(
    state: ServeState,
    image: Image.Image,
    only: str | None = None,
    *,
    raw: bytes | None = None,
) -> list[dict[str, Any]]:
    """Fan an image out to the served models (or the one named ``only``) and
    gather their scored results, plus the ensemble's over the full fan-out.
    ``raw``, the request's encoded bytes, feeds the native decode."""
    targets = state.models if only is None else [m for m in state.models if m.name == only]
    if not targets:
        raise KeyError(only or "<none>")
    futs = [(m, m.batcher.submit(_decode_request(m.plan, image, raw, state.native_decode)))
            for m in targets]
    results = []
    member_probs: list[tuple[str, np.ndarray]] = []
    for m, fut in futs:
        probs = fut.result(timeout=120)
        if m.temperature is not None:
            probs = apply_temperature(np.asarray(probs, np.float64)[None, :], m.temperature)[0]
        member_probs.append((m.name, np.asarray(probs, np.float64)))
        results.append(_scored(m.name, m.display_label, probs, m.threshold, state.class_labels))
    if state.ensemble_enabled and only is None and len(member_probs) >= 2:
        probs = weighted_mean(member_probs, state.ensemble_weights)
        results.append(_scored("ensemble", "Ensemble", probs, state.ensemble_threshold,
                               state.class_labels))
    return results


def prometheus_text(state: ServeState) -> str:
    """The batchers' stats in the Prometheus text exposition format."""
    lines = [
        "# HELP dfd_requests_total Images scored since startup.",
        "# TYPE dfd_requests_total counter",
        "# HELP dfd_batches_total Device steps executed since startup.",
        "# TYPE dfd_batches_total counter",
        "# HELP dfd_mean_batch_size Mean coalesced batch size.",
        "# TYPE dfd_mean_batch_size gauge",
        "# HELP dfd_request_latency_ms Request latency quantiles (ms).",
        "# TYPE dfd_request_latency_ms summary",
    ]
    for m in state.models:
        s = m.batcher.stats()
        tag = f'{{model="{m.name}"}}'
        lines.append(f"dfd_requests_total{tag} {s['requests']}")
        lines.append(f"dfd_batches_total{tag} {s['batches']}")
        lines.append(f"dfd_mean_batch_size{tag} {s['mean_batch']:.4f}")
        for q, key in (("0.5", "latency_ms_p50"), ("0.99", "latency_ms_p99")):
            if key in s:
                lines.append(f'dfd_request_latency_ms{{model="{m.name}",quantile="{q}"}} '
                             f"{s[key]:.4f}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # set by build_server; None while a drain-first reload rebuilds the models
    state: ServeState | None

    def log_message(self, fmt: str, *args: Any) -> None:  # quiet by default
        pass

    def _reload_authorized(self) -> bool:
        """POST /reload rebuilds every model, so it must not be open to anyone
        who reaches a public bind. With a token (``--reload-token`` /
        ``DFD_RELOAD_TOKEN``) the request must present it as ``Authorization:
        Bearer <t>`` or ``X-Reload-Token: <t>``; without one only loopback
        binds honour it. SIGHUP works either way."""
        token = getattr(type(self), "reload_token", None)
        if token:
            presented = self.headers.get("X-Reload-Token", "")
            auth = self.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                presented = presented or auth[len("Bearer "):]
            return hmac.compare_digest(presented, token)
        bind = str(getattr(type(self), "bind_host", "127.0.0.1"))
        return bind in ("127.0.0.1", "localhost", "::1")

    def _send(self, body: bytes, ctype: str, code: int, retry_after: bool = False) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if retry_after:
            self.send_header("Retry-After", str(RETRY_AFTER_S))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, payload: dict[str, Any], code: int = 200) -> None:
        self._send(json.dumps(payload).encode(), "application/json", code, retry_after=code == 503)

    def _unavailable(self) -> None:
        self._send_json({"error": "no models are being served: a reload is rebuilding them; "
                         "retry"}, 503)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if not self.path.startswith(("/healthz", "/stats", "/metrics")):
            self._send_json({"error": f"unknown path {self.path}"}, 404)
            return
        state = type(self).state
        if state is None:
            self._unavailable()
        elif self.path.startswith("/healthz"):
            self._send_json({"status": "ok", "models": [m.name for m in state.models]})
        elif self.path.startswith("/stats"):
            self._send_json({m.name: m.batcher.stats() for m in state.models})
        else:
            self._send(prometheus_text(state).encode(), "text/plain; version=0.0.4", 200)

    def do_POST(self) -> None:  # noqa: N802
        if self.path.startswith("/reload"):
            if not self._reload_authorized():
                self._send_json(
                    {"error": "reload not authorized: set DFD_RELOAD_TOKEN and send it as "
                     "'Authorization: Bearer <token>' or 'X-Reload-Token', or use SIGHUP "
                     "on the host"}, 403)
                return
            try:
                summary = reload_state(type(self))
            except Exception as exc:
                self._send_json({"error": f"reload failed: {exc}"}, 500)
                return
            self._send_json(summary)
            return
        if not self.path.startswith("/predict"):
            self._send_json({"error": f"unknown path {self.path}"}, 404)
            return
        state = type(self).state
        if state is None:
            self._unavailable()
            return
        only = (parse_qs(urlparse(self.path).query).get("model") or [None])[0]
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").lower()
            blob = (base64.b64decode(json.loads(body)["image_b64"])
                    if ctype.startswith("application/json") else body)
            image = Image.open(io.BytesIO(blob))
            if state.native_decode:
                # an integrity scan only: the native path decodes the raw bytes
                # and the PIL fallback opens them again lazily
                image.verify()
                image = Image.open(io.BytesIO(blob))
            else:
                image.load()
        except Exception as exc:
            self._send_json({"error": f"bad request: {exc}"}, 400)
            return
        t0 = time.perf_counter()
        results = None
        try:
            for _ in range(2):
                try:
                    results = predict_once(state, image, only, raw=blob)
                    break
                except BatcherStopped:
                    # raced a reload that stopped this state's batchers: the
                    # class attribute holds the new state (or None while a
                    # drain-first reload rebuilds); one retry, then 503
                    state = type(self).state
                    if state is None:
                        break
        except KeyError as exc:
            self._send_json({"error": f"unknown model {exc}"}, 404)
            return
        except OSError as exc:
            # native mode defers the full decode past verify(): a truncated
            # body surfaces here, still the client's fault
            self._send_json({"error": f"bad request: {exc}"}, 400)
            return
        except Exception as exc:
            self._send_json({"error": f"inference failed: {exc}"}, 500)
            return
        if results is None:
            self._unavailable()
            return
        self._send_json({"results": results, "latency_ms": (time.perf_counter() - t0) * 1e3})


def _release_device_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reload_state(handler_cls) -> dict[str, Any]:
    """Rebuild the ServeState from the server's config and swap it in.

    Re-resolves what startup resolved once: ``weights: auto`` (the newest
    run's export), ``threshold: auto`` and the calibration temperature.
    Triggered by ``POST /reload`` or SIGHUP. By default the new state is
    built and warmed while the old one serves, then swapped in (an atomic
    attribute store); the old batchers drain in a background thread, and a
    request that reaches one after it stopped is retried on the new state.
    Device memory then holds both sets of models for a while.

    With ``DFD_RELOAD_DRAIN_FIRST=1`` the old state is stopped and released
    first (requests answer 503 with ``Retry-After`` meanwhile), then the new
    one is built. If that build fails it is tried once more; if that fails
    too, the server stays without a state, answering 503, until a reload
    succeeds, and the error is raised.
    """
    drain_first = os.environ.get("DFD_RELOAD_DRAIN_FIRST", "0") == "1"
    args = handler_cls.reload_args

    def build() -> ServeState:
        state = build_state(args["config_path"], max_batch=args["max_batch"],
                            max_wait_ms=args["max_wait_ms"], native_decode=args["native_decode"])
        try:
            state.warmup("first")
        except BaseException:
            state.close()
            raise
        return state

    with handler_cls.reload_lock:
        if drain_first:
            old, handler_cls.state = handler_cls.state, None
            if old is not None:
                old.close()
            del old
            _release_device_memory()
            try:
                new_state = build()
            except Exception as exc:
                print(f"[serve] drain-first reload failed ({exc}); building once more")
                _release_device_memory()
                new_state = build()
            handler_cls.state = new_state
        else:
            new_state = build()
            old, handler_cls.state = handler_cls.state, new_state
            if old is not None:
                threading.Thread(target=old.close, daemon=True).start()
    return {
        "status": "reloaded",
        "models": {m.name: {"threshold": m.threshold, "temperature": m.temperature}
                   for m in new_state.models},
    }


class _Server(ThreadingHTTPServer):
    # listen backlog: socketserver's default of 5 resets connections when
    # tens of clients connect at once (the JAX server keeps 5)
    request_queue_size = 128


def build_server(
    config_path: Path,
    *,
    host: str = "127.0.0.1",
    port: int = 8000,
    max_batch: int = 32,
    max_wait_ms: float = 5.0,
    state: ServeState | None = None,
    native_decode: bool | None = None,
    reload_token: str | None = None,
) -> ThreadingHTTPServer:
    """Construct (but do not start) the HTTP server; ``port=0`` picks a free
    port (``server.server_address`` reports it)."""
    st = state or build_state(config_path, max_batch=max_batch, max_wait_ms=max_wait_ms,
                              native_decode=native_decode)
    handler = type("Handler", (_Handler,), {
        "state": st,
        "reload_lock": threading.Lock(),
        "reload_token": reload_token or os.environ.get("DFD_RELOAD_TOKEN") or None,
        "bind_host": host,
        "reload_args": {"config_path": config_path, "max_batch": max_batch,
                        "max_wait_ms": max_wait_ms, "native_decode": native_decode},
    })
    return _Server((host, port), handler)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Deepfake detection serving endpoint (PyTorch)")
    parser.add_argument("--config", type=Path, default=DEFAULT_CONFIG_PATH)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-batch", type=int, default=32)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument(
        "--warmup", choices=["none", "first", "all"], default="first",
        help="run batch buckets once at startup (first = batch 1 only, all = every power of "
        "two up to --max-batch)",
    )
    parser.add_argument(
        "--native-decode", action="store_true", default=None,
        help="decode request bytes with the C++ library (JPEG/PNG; default honours "
        "DFD_NATIVE_EVAL=1)",
    )
    parser.add_argument(
        "--reload-token", default=None,
        help="bearer token required by POST /reload (default: DFD_RELOAD_TOKEN; without a "
        "token /reload only works on loopback binds; SIGHUP always works)",
    )
    args = parser.parse_args(argv)

    state = build_state(args.config, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                        native_decode=args.native_decode)
    state.warmup(args.warmup)
    server = build_server(
        args.config, host=args.host, port=args.port, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, state=state, native_decode=args.native_decode,
        reload_token=args.reload_token,
    )
    del state  # the handler class holds it, so a drain-first reload can release it
    host, port = server.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} "
          f"(max_batch={args.max_batch}, max_wait_ms={args.max_wait_ms})", flush=True)
    # SIGTERM (container stop, maintenance): stop accepting, drain, exit 0
    signal.signal(signal.SIGTERM, lambda s, f: threading.Thread(
        target=server.shutdown, daemon=True).start())

    def _sighup(s, f):  # re-resolve weights, thresholds and temperatures, as POST /reload
        def run():
            try:
                print(f"[serve] SIGHUP reload: {reload_state(server.RequestHandlerClass)}")
            except Exception as exc:
                print(f"[serve] SIGHUP reload failed: {exc}")

        threading.Thread(target=run, daemon=True).start()

    signal.signal(signal.SIGHUP, _sighup)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        current = server.RequestHandlerClass.state
        if current is not None:
            current.close()
        print("[serve] drained and stopped", flush=True)


if __name__ == "__main__":
    main()
