"""Online HTTP serving daemon: micro-batching over the serving engines
(counterpart of ``tpu_unet/serve_http.py``).

Online traffic arrives one image at a time. A :class:`MicroBatcher` queues
concurrent requests, drains up to ``batch_size`` of them (waiting at most
``max_wait_ms`` for followers after the first arrival) and makes one engine
call; every request's future resolves from that call. With an engine's
``bucket_sizes`` ladder a part-full flush pads to the smallest adequate
bucket instead of the full batch. Request threads decode and resize
concurrently, so host decode overlaps device work.

The engine call runs on the batcher's own thread. Inference mode and the
current CUDA device are per thread, so the engines enter both themselves
(``serve.py``, ``_Engine._serving``).

Overload policy (``max_queue``): beyond the queue bound a request is refused
(HTTP 503 with ``Retry-After``) instead of growing every waiter's latency,
and a request whose deadline passed while it queued is dropped without an
engine call. Rejected and expired counts appear in /healthz and /metrics.

The HTTP layer (the standard library's ``ThreadingHTTPServer``) is a thin
shell over :class:`ServingService`, which is testable without sockets:

- ``POST /v1/score``    (anomaly engines)  image bytes -> {"score": float}
- ``POST /v1/heatmap``  (anomaly engines built with_heatmap) image bytes ->
                          {"score", "heatmap_png_base64"}
- ``POST /v1/predict``  (seg engines)      image bytes -> {"mask_png_base64",
                          "mean_confidence", "class_pixel_share"}
- ``GET  /v1/meta`` or ``/healthz``        engine geometry and counters
- ``GET  /metrics``                        Prometheus text (serve_metrics.py)

An engine serves one device: run one daemon per card behind a load
balancer to scale out.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple, Union

import numpy as np

from tpu_unet_torch.serve import AnomalyScorer, SegmentationPredictor
from tpu_unet_torch.serve_metrics import ServingMetrics


def decode_image_bytes(data: bytes, size_hw: Tuple[int, int]) -> np.ndarray:
    """Decode encoded image bytes (PNG/JPEG/BMP/...) to resized (H,W,3) u8."""
    from tpu_unet_torch.data.transforms import load_image_rgb
    return load_image_rgb(io.BytesIO(data), size_hw)


def _png_b64(gray_u8: np.ndarray) -> str:
    """(H,W) uint8 -> base64-encoded grayscale PNG."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(gray_u8, mode="L").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class QueueFullError(RuntimeError):
    """Admission refused: the serving queue is at its configured bound.

    The HTTP layer maps this to 503 + ``Retry-After`` — the standard overload
    contract — instead of letting the queue (and every waiter's latency) grow
    without bound when the arrival rate exceeds engine throughput.
    """


class MicroBatcher:
    """Coalesce concurrent single-item requests into fixed-shape engine calls.

    ``run_batch`` takes a (B,H,W,3) uint8 stack with B <= batch_size (the
    engine pads internally) and returns a sequence of per-item results. A
    single worker thread owns the engine call (the engine is one device
    stream anyway), so request threads only queue and wait on futures.

    Overload policy (both knobs off by default):

    - ``max_queue``: bound on requests *waiting* for a batch slot; submit()
      raises :class:`QueueFullError` when full (load-shedding beats queueing
      past the point where every request times out anyway).
    - per-request ``deadline`` (``time.monotonic()`` seconds): a request whose
      deadline passed while queued is dropped at flush time — its waiter has
      already timed out, so running it would spend device time on a response
      nobody reads. Its future gets a ``TimeoutError``.
    """

    def __init__(self, run_batch, batch_size: int, max_wait_ms: float = 5.0,
                 max_queue: Optional[int] = None):
        self._run = run_batch
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue = int(max_queue) if max_queue else None
        self._q: queue.Queue = queue.Queue(maxsize=self.max_queue or 0)
        self.engine_batches = 0          # one per program execution
        self.requests_served = 0
        self.rejected = 0                # submit() refusals (queue full)
        self.expired = 0                 # dropped in-queue past their deadline
        self._stats_lock = threading.Lock()
        # Orders submit()'s closed-check and put against close()'s
        # set-closed and sentinel put: no request can be enqueued after the
        # shutdown sentinel, so the worker, serving everything up to it,
        # resolves every future.
        self._lifecycle_lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="tpu-unet-microbatcher")
        self._worker.start()

    def submit(self, image_u8: np.ndarray,
               deadline: Optional[float] = None) -> Future:
        fut: Future = Future()
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            try:
                self._q.put_nowait((image_u8, fut, deadline))
            except queue.Full:
                with self._stats_lock:
                    self.rejected += 1
                raise QueueFullError(
                    f"serving queue is full ({self.max_queue} waiting); "
                    "retry later") from None
        return fut

    def close(self) -> None:
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
            # The sentinel is enqueued under the lock that guards submit(),
            # so every accepted request sits before it: the worker serves
            # them all, then exits, even if this join times out while the
            # engine is still busy.
            self._q.put(None)
        self._worker.join(timeout=30)

    def _drain_after_sentinel(self) -> None:
        """Fail anything still queued once the sentinel has been consumed.

        With the lifecycle lock, nothing should ever follow the sentinel;
        this is defense-in-depth so a future regression hangs no waiter."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1].set_exception(
                    RuntimeError("MicroBatcher closed before this "
                                 "request reached the engine"))

    def _loop(self) -> None:
        while True:
            head = self._q.get()
            if head is None:
                self._drain_after_sentinel()
                return
            batch = [head]
            # The first request opens a window: wait up to max_wait_s for
            # followers, but never beyond a full batch.
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:  # close() raced the window: serve, then exit
                    self._flush(batch)
                    self._drain_after_sentinel()
                    return
                batch.append(item)
            self._flush(batch)

    def _flush(self, batch) -> None:
        now = time.monotonic()
        live = [item for item in batch
                if item[2] is None or now <= item[2]]
        if len(live) < len(batch):
            with self._stats_lock:
                self.expired += len(batch) - len(live)
            err = TimeoutError("request expired in the serving queue before "
                               "reaching the engine (server overloaded)")
            for _, fut, dl in batch:
                if dl is not None and now > dl:
                    fut.set_exception(err)
            if not live:
                return
        images = np.stack([img for img, _, _ in live])
        try:
            results = self._run(images)
        except BaseException as e:  # noqa: BLE001 — propagate to every waiter
            for _, fut, _ in live:
                fut.set_exception(e)
            return
        self.engine_batches += 1
        self.requests_served += len(live)
        for (_, fut, _), res in zip(live, results):
            fut.set_result(res)


class ServingService:
    """Engine + micro-batcher + JSON marshalling; the HTTP layer's core."""

    def __init__(self, engine: Union[AnomalyScorer, SegmentationPredictor],
                 max_wait_ms: float = 5.0,
                 threshold: Optional[float] = None,
                 request_timeout_s: float = 120.0,
                 max_queue: Optional[int] = None):
        self.engine = engine
        self.threshold = threshold
        self.request_timeout_s = request_timeout_s
        self.metrics = ServingMetrics()
        self.heatmap_batcher: Optional[MicroBatcher] = None
        if isinstance(engine, AnomalyScorer):
            self.kind = "anomaly_scorer"
            self.size_hw = (engine.image_size, engine.image_size)
            run = lambda imgs: list(engine.score_array(imgs))  # noqa: E731
            if engine.has_heatmap:
                self.heatmap_batcher = MicroBatcher(
                    lambda imgs: list(zip(*engine.heatmap_array(imgs))),
                    engine.batch_size, max_wait_ms, max_queue=max_queue)
        elif isinstance(engine, SegmentationPredictor):
            self.kind = "segmentation_predictor"
            self.size_hw = tuple(engine.image_size_hw)
            run = lambda imgs: list(zip(*engine.predict_array(imgs)))  # noqa: E731
        else:
            raise TypeError(f"unsupported engine type {type(engine).__name__}")
        self.batcher = MicroBatcher(run, engine.batch_size, max_wait_ms,
                                    max_queue=max_queue)

    def _deadline(self) -> float:
        """Queue-drop deadline = the waiter's own .result() timeout: past it
        the requesting thread has already answered with an error, so the
        batcher should not spend a device slot on the answer."""
        return time.monotonic() + self.request_timeout_s

    # -- request handling ----------------------------------------------------

    def handle(self, path: str, body: bytes) -> dict:
        """Serve one POSTed image; returns the JSON-ready response dict.

        Raises ValueError for a wrong endpoint/engine pairing and lets decode
        errors surface (the HTTP layer maps both to 4xx). Every request —
        success or failure — is timed into the Prometheus metrics registry.
        """
        t0 = time.monotonic()
        try:
            resp = self._handle(path, body)
        except BaseException:
            self.metrics.observe(path, time.monotonic() - t0, ok=False)
            raise
        self.metrics.observe(path, time.monotonic() - t0, ok=True)
        return resp

    def _handle(self, path: str, body: bytes) -> dict:
        if path == "/v1/score" and self.kind == "anomaly_scorer":
            image = decode_image_bytes(body, self.size_hw)
            score = float(self.batcher.submit(image, self._deadline())
                          .result(timeout=self.request_timeout_s))
            return self._score_resp(score)
        if path == "/v1/heatmap" and self.heatmap_batcher is not None:
            image = decode_image_bytes(body, self.size_hw)
            score, heatmap = self.heatmap_batcher.submit(
                image, self._deadline()).result(timeout=self.request_timeout_s)
            resp = self._score_resp(float(score))
            resp["heatmap_png_base64"] = _png_b64(np.asarray(heatmap))
            return resp
        if path == "/v1/predict" and self.kind == "segmentation_predictor":
            image = decode_image_bytes(body, self.size_hw)
            mask, conf = self.batcher.submit(image, self._deadline()).result(
                timeout=self.request_timeout_s)
            nc = self.engine.num_classes or int(mask.max()) + 1
            shares = np.bincount(np.asarray(mask).ravel(), minlength=nc)
            return {
                "mask_png_base64": _png_b64(np.asarray(mask)),
                "mean_confidence": None if np.isnan(conf) else float(conf),
                "class_pixel_share": (shares / shares.sum()).round(6).tolist(),
            }
        if path == "/v1/heatmap":
            raise ValueError(
                "endpoint '/v1/heatmap' needs an anomaly engine built with "
                "--heatmap (or an artifact exported from one)")
        raise ValueError(
            f"endpoint {path!r} does not serve a {self.kind} engine "
            f"(anomaly engines serve /v1/score, seg engines /v1/predict)")

    def _score_resp(self, score: float) -> dict:
        resp = {"score": None if np.isnan(score) else score}
        if self.threshold is not None and not np.isnan(score):
            resp["anomalous"] = bool(score > self.threshold)
            resp["threshold"] = self.threshold
        return resp

    def meta(self) -> dict:
        return {
            "status": "ok",
            "kind": self.kind,
            "image_size_hw": [int(s) for s in self.size_hw],
            "batch_size": self.engine.batch_size,
            "bucket_sizes": (list(self.engine.bucket_sizes)
                             if getattr(self.engine, "bucket_sizes", None)
                             else None),
            "quantize": getattr(self.engine, "quantize", None) or "none",
            "max_wait_ms": self.batcher.max_wait_s * 1000.0,
            "max_queue": self.batcher.max_queue,
            "requests_served": self.batcher.requests_served,
            "engine_batches": self.batcher.engine_batches,
            "requests_rejected": self.batcher.rejected,
            "requests_expired": self.batcher.expired,
            "heatmap": self.heatmap_batcher is not None,
            **({"heatmap_requests_served": self.heatmap_batcher.requests_served,
                "heatmap_engine_batches": self.heatmap_batcher.engine_batches,
                "heatmap_requests_rejected": self.heatmap_batcher.rejected,
                "heatmap_requests_expired": self.heatmap_batcher.expired}
               if self.heatmap_batcher is not None else {}),
        }

    def metrics_text(self) -> str:
        """Prometheus exposition text for GET /metrics (serve_metrics.py)."""
        programs = {"main": (self.batcher.engine_batches,
                             self.batcher.requests_served)}
        queues = {"main": (self.batcher.rejected, self.batcher.expired)}
        if self.heatmap_batcher is not None:
            programs["heatmap"] = (self.heatmap_batcher.engine_batches,
                                   self.heatmap_batcher.requests_served)
            queues["heatmap"] = (self.heatmap_batcher.rejected,
                                 self.heatmap_batcher.expired)
        info = {
            "kind": self.kind,
            "quantize": getattr(self.engine, "quantize", None) or "none",
            "batch_size": str(self.engine.batch_size),
            "image_size_hw": "x".join(str(int(s)) for s in self.size_hw),
        }
        return self.metrics.render(info, programs, queues)

    def warmup(self) -> None:
        """Run the serving programs before accepting traffic (every bucket of
        the engine's ladder, building the kernels on first use), then one
        request through each micro-batcher to prove the whole path."""
        self.engine.warmup()
        img = np.zeros(self.size_hw + (3,), np.uint8)
        self.batcher.submit(img).result(timeout=600)
        if self.heatmap_batcher is not None:
            self.heatmap_batcher.submit(img).result(timeout=600)

    def close(self) -> None:
        self.batcher.close()
        if self.heatmap_batcher is not None:
            self.heatmap_batcher.close()


def make_server(service: ServingService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``server.server_address`` has the
    bound port (pass port=0 for an ephemeral one). Run with serve_forever()."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, payload: dict,
                  retry_after: Optional[int] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(retry_after))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path in ("/healthz", "/v1/meta"):
                self._send(200, service.meta())
            elif self.path == "/metrics":
                body = service.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/v1/score", "/v1/predict", "/v1/heatmap"):
                self._send(404, {"error": f"unknown path {self.path!r}"})
                return
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                self._send(400, {"error": "empty body (send image bytes)"})
                return
            body = self.rfile.read(length)
            try:
                self._send(200, service.handle(self.path, body))
            except ValueError as e:  # endpoint/engine mismatch
                self._send(404, {"error": str(e)})
            except QueueFullError as e:  # overload: shed load, ask to retry
                self._send(503, {"error": str(e)}, retry_after=1)
            except TimeoutError as e:  # expired in queue / result() timeout
                self._send(503, {"error": f"{type(e).__name__}: {e}"},
                           retry_after=1)
            except Exception as e:  # noqa: BLE001 — undecodable image etc.
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet; the CLI logs startup
            pass

    class Server(ThreadingHTTPServer):
        # The listen backlog. socketserver's default of 5 drops the
        # connections of a burst of clients, each of which then retries its
        # SYN after a second.
        request_queue_size = 128

    return Server((host, port), Handler)
