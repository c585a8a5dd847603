"""Prometheus-style serving metrics, text exposition format 0.0.4
(counterpart of ``tpu_unet/serve_metrics.py``, rendering the same text for
the same observations).

The HTTP daemon (``serve_http.py``) counts requests per endpoint and status,
keeps a latency histogram per endpoint and, per program, its engine calls,
the requests they served, and the requests refused or expired in its queue;
``GET /metrics`` renders them for any Prometheus-compatible scraper.
Standard library only: plain counters behind locks. The latency buckets run
from 1 ms to 10 s. The metric names keep the JAX package's
``tpu_unet_`` prefix, so one dashboard reads both.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0,
)


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_le(bound: float) -> str:
    if math.isinf(bound):
        return "+Inf"
    return repr(bound)


class Histogram:
    """Cumulative-bucket latency histogram (thread-safe)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(buckets)) + (math.inf,)
        self._counts = [0] * len(self.bounds)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    self._counts[i] += 1
                    break
            self._sum += value
            self._count += 1

    def render(self, name: str, labels: Mapping[str, str]) -> List[str]:
        with self._lock:
            counts, total, count = list(self._counts), self._sum, self._count
        lines = []
        cumulative = 0
        for bound, c in zip(self.bounds, counts):
            cumulative += c
            lbl = _fmt_labels({**labels, "le": _fmt_le(bound)})
            lines.append(f"{name}_bucket{lbl} {cumulative}")
        lbl = _fmt_labels(labels)
        lines.append(f"{name}_sum{lbl} {total:.6f}")
        lines.append(f"{name}_count{lbl} {count}")
        return lines


class ServingMetrics:
    """Per-endpoint request counters + latency histograms."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._requests: Dict[Tuple[str, str], int] = {}
        self._latency: Dict[str, Histogram] = {}

    def observe(self, endpoint: str, seconds: float, ok: bool = True) -> None:
        status = "ok" if ok else "error"
        with self._lock:
            key = (endpoint, status)
            self._requests[key] = self._requests.get(key, 0) + 1
            hist = self._latency.get(endpoint)
            if hist is None:
                hist = self._latency[endpoint] = Histogram(self._buckets)
        hist.observe(seconds)

    def render(self, info: Mapping[str, str],
               programs: Mapping[str, Tuple[int, int]],
               queues: Optional[Mapping[str, Tuple[int, int]]] = None) -> str:
        """Exposition text.

        ``info``: static labels of the ``tpu_unet_serving_info`` gauge (kind,
        quantize, ...). ``programs``: program name -> (engine_batches,
        requests_served) from its MicroBatcher; occupancy is
        requests / batches. ``queues``: program name -> (rejected, expired)
        admission counters; nonzero means the daemon is shedding load.
        """
        lines: List[str] = []
        lines.append("# HELP tpu_unet_serving_info Static engine/server labels.")
        lines.append("# TYPE tpu_unet_serving_info gauge")
        lines.append(f"tpu_unet_serving_info{_fmt_labels(dict(info))} 1")

        lines.append("# HELP tpu_unet_requests_total Requests by endpoint and status.")
        lines.append("# TYPE tpu_unet_requests_total counter")
        with self._lock:
            requests = dict(self._requests)
            hists = dict(self._latency)
        for (endpoint, status), n in sorted(requests.items()):
            lbl = _fmt_labels({"endpoint": endpoint, "status": status})
            lines.append(f"tpu_unet_requests_total{lbl} {n}")

        lines.append("# HELP tpu_unet_request_latency_seconds End-to-end request"
                     " latency (decode + micro-batch wait + device).")
        lines.append("# TYPE tpu_unet_request_latency_seconds histogram")
        for endpoint, hist in sorted(hists.items()):
            lines.extend(hist.render("tpu_unet_request_latency_seconds",
                                     {"endpoint": endpoint}))

        lines.append("# HELP tpu_unet_engine_batches_total Compiled-program"
                     " executions per program.")
        lines.append("# TYPE tpu_unet_engine_batches_total counter")
        lines.append("# HELP tpu_unet_engine_requests_total Requests served by"
                     " program executions (requests/batches = occupancy).")
        lines.append("# TYPE tpu_unet_engine_requests_total counter")
        for program, (batches, served) in sorted(programs.items()):
            lbl = _fmt_labels({"program": program})
            lines.append(f"tpu_unet_engine_batches_total{lbl} {batches}")
            lines.append(f"tpu_unet_engine_requests_total{lbl} {served}")
        if queues:
            lines.append("# HELP tpu_unet_queue_rejected_total Requests refused"
                         " at admission (queue full; HTTP 503).")
            lines.append("# TYPE tpu_unet_queue_rejected_total counter")
            lines.append("# HELP tpu_unet_queue_expired_total Requests dropped"
                         " in queue past their deadline (never ran).")
            lines.append("# TYPE tpu_unet_queue_expired_total counter")
            for program, (rejected, expired) in sorted(queues.items()):
                lbl = _fmt_labels({"program": program})
                lines.append(f"tpu_unet_queue_rejected_total{lbl} {rejected}")
                lines.append(f"tpu_unet_queue_expired_total{lbl} {expired}")
        return "\n".join(lines) + "\n"
