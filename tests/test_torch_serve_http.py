"""The port's online serving (tpu_unet_torch/serve_http.py, serve_metrics.py)
on the CPU: the metrics text string-equal to tpu_unet.serve_metrics' for the
same observations, the micro-batcher's batching, backpressure and deadlines,
responses against tpu_unet.serve_http.ServingService's for the same bytes
(AnomalyUNet and SegmentationUNet at base 4, 32 px, f32), the HTTP server,
and the engine run in inference mode from the batcher's thread."""

import base64
import http.client
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import jax_variables, one_torch_thread, seeded_state_dict  # noqa: F401
from tpu_unet import serve as jserve
from tpu_unet import serve_http as jhttp
from tpu_unet import serve_metrics as jmetrics
from tpu_unet_torch import serve_metrics as tmetrics
from tpu_unet_torch.serve import AnomalyScorer, SegmentationPredictor
from tpu_unet_torch.serve_http import MicroBatcher, QueueFullError, ServingService, make_server

KW = dict(batch_size=4, base_features=4, precision="f32")


def _png(arr_u8):
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return buf.getvalue()


def _unpng(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _images(seed, n=5):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


# -- metrics ------------------------------------------------------------------

_OBSERVATIONS = [
    [],
    [("/v1/score", 0.0004, True), ("/v1/score", 0.003, True), ("/v1/score", 12.5, False)],
    [("/v1/predict", 0.02, True), ("/healthz", 0.001, True), ("/v1/predict", 0.5, False),
     ("/v1/predict", 0.0025, True), ("/v1/heatmap", 2.5, True)],
]


@pytest.mark.parametrize("obs", _OBSERVATIONS)
@pytest.mark.parametrize("with_queues", [False, True])
def test_metrics_render_equals_jax(obs, with_queues):
    port, ref = tmetrics.ServingMetrics(), jmetrics.ServingMetrics()
    for m in (port, ref):
        for endpoint, seconds, ok in obs:
            m.observe(endpoint, seconds, ok=ok)
    info = {"kind": "segmentation_predictor", "quantize": "int8", "batch_size": "16",
            "image_size_hw": "512x512"}
    programs = {"main": (7, 19), "heatmap": (2, 3)}
    queues = {"main": (4, 1), "heatmap": (0, 0)} if with_queues else None
    assert port.render(info, programs, queues) == ref.render(info, programs, queues)


def test_histogram_equals_jax():
    hp, hj = tmetrics.Histogram((0.5, 0.1, 1.0)), jmetrics.Histogram((0.5, 0.1, 1.0))
    for v in (0.05, 0.1, 0.3, 0.99, 7.0):
        hp.observe(v)
        hj.observe(v)
    assert hp.render("x", {"a": "b"}) == hj.render("x", {"a": "b"})


# -- the micro-batcher ----------------------------------------------------------

class _GatedRun:
    """run_batch stub that waits on ``gate`` and records its batch sizes."""

    def __init__(self):
        self.gate, self.entered, self.batch_sizes = threading.Event(), threading.Event(), []

    def __call__(self, imgs):
        self.entered.set()
        assert self.gate.wait(timeout=30)
        self.batch_sizes.append(len(imgs))
        return [float(im.mean()) for im in imgs]


def _img(v=0):
    return np.full((2, 2, 3), v, np.uint8)


def test_microbatcher_coalesces_and_serves_singletons():
    run = _GatedRun()
    b = MicroBatcher(run, batch_size=4, max_wait_ms=2000)
    futs = [b.submit(_img(i)) for i in range(4)]
    run.gate.set()
    assert [f.result(timeout=30) for f in futs] == [float(i) for i in range(4)]
    assert run.batch_sizes == [4] and b.engine_batches == 1 and b.requests_served == 4
    b.close()
    run2 = _GatedRun()
    run2.gate.set()
    b2 = MicroBatcher(run2, batch_size=4, max_wait_ms=0)
    for i in range(3):
        assert b2.submit(_img(i)).result(timeout=30) == float(i)
    assert run2.batch_sizes == [1, 1, 1]
    b2.close()
    with pytest.raises(RuntimeError, match="closed"):
        b2.submit(_img())


def test_microbatcher_backpressure_deadlines_and_errors():
    run = _GatedRun()
    b = MicroBatcher(run, batch_size=1, max_wait_ms=0, max_queue=2)
    f0 = b.submit(_img(0))
    assert run.entered.wait(timeout=10)
    f1 = b.submit(_img(1), deadline=time.monotonic() - 1)  # already expired
    f2 = b.submit(_img(2))
    with pytest.raises(QueueFullError, match="full"):
        b.submit(_img(3))
    assert b.rejected == 1
    run.gate.set()
    assert f0.result(timeout=30) == 0.0 and f2.result(timeout=30) == 2.0
    with pytest.raises(TimeoutError):
        f1.result(timeout=30)
    assert b.expired == 1 and b.requests_served == 2 and run.batch_sizes == [1, 1]
    b.close()

    def boom(imgs):
        raise ValueError("engine failed")

    b = MicroBatcher(boom, batch_size=2, max_wait_ms=500)
    futs = [b.submit(_img()) for _ in range(2)]
    for f in futs:
        with pytest.raises(ValueError, match="engine failed"):
            f.result(timeout=30)
    b.close()


# -- services against the JAX package's --------------------------------------------

@pytest.fixture(scope="module")
def anomaly():
    sd = seeded_state_dict("anomaly_unet", 11, base_features=4)
    v = jax_variables(sd, "anomaly_unet")
    port = AnomalyScorer.from_state_dict(sd, image_size=32, with_heatmap=True,
                                         bucket_sizes=(1, 2), device="cpu", **KW)
    ref = jserve.AnomalyScorer.from_variables(v["params"], v["batch_stats"], image_size=32,
                                              with_heatmap=True, bucket_sizes=(1, 2), **KW)
    return port, ref


@pytest.fixture(scope="module")
def seg():
    sd = seeded_state_dict("seg_unet", 12, n_classes=4, base_features=4)
    v = jax_variables(sd, "seg_unet")
    kw = dict(num_classes=4, image_size_hw=(32, 32), bucket_sizes=(1, 2), **KW)
    return (SegmentationPredictor.from_state_dict(sd, device="cpu", **kw),
            jserve.SegmentationPredictor.from_variables(v["params"], v["batch_stats"], **kw))


def test_anomaly_responses_match_jax(anomaly):
    """Score responses to rtol 1e-4 (tests/test_torch_serve.py's f32
    tolerance), heatmap PNGs within 1 level (0.5 rounding ties)."""
    port = ServingService(anomaly[0], max_wait_ms=1, threshold=0.5)
    ref = jhttp.ServingService(anomaly[1], max_wait_ms=1, threshold=0.5)
    try:
        for img in _images(1, n=3):
            body = _png(img)
            got, want = port.handle("/v1/score", body), ref.handle("/v1/score", body)
            assert set(got) == set(want) == {"score", "anomalous", "threshold"}
            np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4)
            got, want = port.handle("/v1/heatmap", body), ref.handle("/v1/heatmap", body)
            np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4)
            diff = _unpng(got["heatmap_png_base64"]).astype(int) - \
                _unpng(want["heatmap_png_base64"]).astype(int)
            assert np.abs(diff).max() <= 1
        with pytest.raises(ValueError, match="does not serve"):
            port.handle("/v1/predict", body)
        meta, ref_meta = port.meta(), ref.meta()
        assert meta == ref_meta
    finally:
        port.close()
        ref.close()


def test_seg_responses_match_jax(seg):
    port = ServingService(seg[0], max_wait_ms=1)
    ref = jhttp.ServingService(seg[1], max_wait_ms=1)
    try:
        for img in _images(2, n=3):
            body = _png(img)
            got, want = port.handle("/v1/predict", body), ref.handle("/v1/predict", body)
            np.testing.assert_array_equal(_unpng(got["mask_png_base64"]),
                                          _unpng(want["mask_png_base64"]))
            np.testing.assert_allclose(got["mean_confidence"], want["mean_confidence"],
                                       rtol=1e-5)
            assert got["class_pixel_share"] == want["class_pixel_share"]
        for service in (port, ref):
            with pytest.raises(ValueError, match="needs an anomaly engine"):
                service.handle("/v1/heatmap", body)
        assert port.meta() == ref.meta()

        def counters(text):  # the latency histogram's values depend on timing
            return [ln for ln in text.splitlines()
                    if not ln.startswith("tpu_unet_request_latency_seconds")]

        assert counters(port.metrics_text()) == counters(ref.metrics_text())
    finally:
        port.close()
        ref.close()


def test_flush_thread_runs_the_engine_in_inference_mode():
    """A bf16 engine's parameters require grad: called from the batcher's
    own thread (where the caller's inference mode does not reach) it must
    enter inference mode itself and build no autograd graph."""
    sd = seeded_state_dict("seg_unet", 13, n_classes=4, base_features=4)
    engine = SegmentationPredictor.from_state_dict(
        sd, num_classes=4, image_size_hw=(32, 32), batch_size=2, base_features=4,
        precision="bf16", device="cpu")
    inner, seen = engine._predict_fn, []

    def spy(x):
        out = inner(x)
        seen.append((threading.current_thread().name, torch.is_inference_mode_enabled(),
                     out[1].requires_grad, out[1].grad_fn is None))
        return out

    engine._predict_fn = spy
    service = ServingService(engine, max_wait_ms=1)
    try:
        service.handle("/v1/predict", _png(_images(3, n=1)[0]))
    finally:
        service.close()
    assert seen == [("tpu-unet-microbatcher", True, False, True)]


# -- the HTTP server ----------------------------------------------------------------

def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _serve(service):
    server = make_server(service, host="127.0.0.1", port=0)
    assert server.request_queue_size >= 64  # a burst of clients is not dropped
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]


def test_http_concurrent_predicts_equal_predict_array_and_metrics(seg):
    engine = seg[0]
    service = ServingService(engine, max_wait_ms=20)
    server, port = _serve(service)
    try:
        images = _images(4, n=12)
        with ThreadPoolExecutor(6) as pool:
            replies = list(pool.map(lambda im: _request(port, "POST", "/v1/predict", _png(im)),
                                    images))
        masks, confs = engine.predict_array(images)
        for (status, _, body), m, c in zip(replies, masks, confs):
            assert status == 200
            r = json.loads(body)
            np.testing.assert_array_equal(_unpng(r["mask_png_base64"]), m)
            assert r["mean_confidence"] == pytest.approx(float(c), rel=1e-6)
        status, _, body = _request(port, "GET", "/healthz")
        meta = json.loads(body)
        assert status == 200 and meta["requests_served"] == 12
        assert meta["engine_batches"] <= 12 and meta["bucket_sizes"] == [1, 2, 4]
        status, headers, text = _request(port, "GET", "/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        assert 'tpu_unet_requests_total{endpoint="/v1/predict",status="ok"} 12' in text.decode()
        assert _request(port, "GET", "/nope")[0] == 404
        assert _request(port, "POST", "/v1/score", _png(images[0]))[0] == 404
        assert _request(port, "POST", "/v1/predict", b"not an image")[0] == 400
    finally:
        server.shutdown()
        server.server_close()
        service.close()


def test_http_overload_gets_503_with_retry_after(seg):
    """With the engine held and max_queue 1, a burst is refused with 503 and
    Retry-After, and /healthz counts the refusals."""
    engine = seg[0]
    gate, entered = threading.Event(), threading.Event()
    service = ServingService(engine, max_wait_ms=0, max_queue=1)
    inner = service.batcher._run

    def held(imgs):
        entered.set()
        assert gate.wait(timeout=30)
        return inner(imgs)

    service.batcher._run = held
    server, port = _serve(service)
    try:
        body = _png(_images(5, n=1)[0])
        with ThreadPoolExecutor(8) as pool:
            first = pool.submit(_request, port, "POST", "/v1/predict", body)
            assert entered.wait(timeout=30)
            burst = [pool.submit(_request, port, "POST", "/v1/predict", body) for _ in range(6)]
            time.sleep(0.5)
            gate.set()
            replies = [first.result()] + [f.result() for f in burst]
        codes = [r[0] for r in replies]
        refused = [r for r in replies if r[0] == 503]
        assert codes.count(200) >= 2 and refused
        assert all(r[1].get("Retry-After") == "1" for r in refused)
        meta = json.loads(_request(port, "GET", "/healthz")[2])
        assert meta["requests_rejected"] == len(refused) and meta["max_queue"] == 1
    finally:
        gate.set()
        server.shutdown()
        server.server_close()
        service.close()
