"""The port's span recorder (tpu_unet_torch/utils/spans.py) and the spans
the serving engines, the int8 executor, K2's wrapper and the train steps
record, on the CPU at base_features=4 and 32 px."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.augment import sample_augment_draws
from tpu_unet_torch.serve import AnomalyScorer, SegmentationPredictor
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (AugmentConfig, make_anomaly_train_step,
                                        make_seg_train_step)
from tpu_unet_torch.utils import spans

SERVE_CHILDREN = {"serve.put", "serve.k1", "serve.forward", "serve.head", "serve.fetch"}
TRAIN_PHASES = {"train.augment", "train.forward", "train.loss", "train.backward",
                "train.optimizer"}
TRACE_BASE_S = 7889238  # the chrome trace's base: epoch seconds floored to a multiple


@pytest.fixture(autouse=True)
def empty_ring():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    spans.clear()
    torch.set_num_threads(n)


def _images(seed, n, h=32, w=32):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _state_dict(name, **kw):
    torch.manual_seed(0)
    return build_model(name, base_features=4, **kw).state_dict()


@pytest.fixture(scope="module")
def predictor():
    return SegmentationPredictor.from_state_dict(
        _state_dict("seg_unet", n_classes=3), num_classes=3, image_size_hw=(32, 32),
        batch_size=1, precision="f32", base_features=4, device="cpu")


def _by_id(recorded):
    return {s.id: s for s in recorded}


def _one_root(recorded, name):
    roots = [s for s in recorded if s.name == name]
    assert len(roots) == 1, [s.name for s in recorded]
    root = roots[0]
    assert root.parent is None and root.root == root.id
    return root


def test_nothing_is_recorded_outside_a_profiler(predictor):
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("a") is spans.span("b")  # the shared no-op
    predictor.predict_array(_images(0, 1))
    assert spans.recorded() == [] and spans.overwritten() == 0


def test_predict_array_under_a_cpu_profiler_records_a_request(predictor, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predictor.predict_array(_images(1, 1))
    got = spans.recorded()
    root = _one_root(got, "serve.request")
    children = [s for s in got if s.id != root.id]
    assert {s.name for s in children} == SERVE_CHILDREN and len(children) == 5
    for s in children:
        assert s.parent == root.id and s.root == root.id and s.thread == root.thread
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert root.thread == threading.get_native_id()
    order = [s.name for s in sorted(children, key=lambda s: s.start_ns)]
    assert order == ["serve.put", "serve.k1", "serve.forward", "serve.head", "serve.fetch"]

    # The clock: the trace's ts (us) plus its base is time.time_ns(), the
    # base the epoch second floored to a multiple of 7,889,238 s.
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    assert base == root.start_ns // 10**9 // TRACE_BASE_S * TRACE_BASE_S * 10**9
    put = next(s for s in children if s.name == "serve.put")
    a, b = (put.start_ns - base) / 1e3, (put.end_ns - base) / 1e3
    uploads = [e for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("name") in ("aten::to", "aten::copy_")
               and e.get("tid") == put.thread and a <= e["ts"] <= b]
    assert uploads, "no upload operator inside serve.put"
    assert all(e["ts"] + e["dur"] <= b + 1.0 for e in uploads)


def test_int8_score_array_records_plan_ops_and_k2_under_forward():
    calib = _images(2, 16)
    scorer = AnomalyScorer.from_state_dict(
        _state_dict("anomaly_unet"), image_size=32, batch_size=2, quantize="int8",
        calib_images=calib, base_features=4, device="cpu")
    spans.clear()  # calibration ran outside any profiler: nothing to drop
    with spans.recording():
        scorer.score_array(_images(3, 2))
    got = spans.recorded()
    ids = _by_id(got)
    root = _one_root(got, "serve.request")
    forward = [s for s in got if s.name == "serve.forward"]
    assert len(forward) == 1 and forward[0].parent == root.id
    ops = [s for s in got if s.name.startswith("int8.")]
    assert {s.name for s in ops} == {"int8.input", "int8.double_conv", "int8.maxpool",
                                     "int8.up_block", "int8.head"}
    assert len(ops) == 15  # input, 5 double convs, 4 pools, 4 up blocks, the head
    assert all(s.parent == forward[0].id and s.root == root.id for s in ops)
    k2 = [s for s in got if s.name == "kernel.k2"]
    assert len(k2) == 18  # two 3x3 convs in each of 9 double convs
    assert all(ids[s.parent].name in ("int8.double_conv", "int8.up_block") for s in k2)
    assert all(ids[s.parent].start_ns <= s.start_ns <= s.end_ns <= ids[s.parent].end_ns
               for s in k2)


def _phases(got):
    root = _one_root(got, "train.step")
    kids = [s for s in got if s.id != root.id]
    assert all(s.parent == root.id and s.root == root.id for s in kids)
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in kids)
    return [s.name for s in sorted(kids, key=lambda s: s.start_ns)]


def test_anomaly_train_step_records_its_phases():
    model = build_model("anomaly_unet", base_features=4)
    state = create_train_state(model, "adam", 1e-3, 1e-4, device="cpu")
    step = make_anomaly_train_step(aug_cfg=AugmentConfig())
    imgs = torch.from_numpy(_images(4, 2))
    masks = torch.zeros(2, 32, 32, 1)
    draws = sample_augment_draws(2, AugmentConfig(), torch.Generator().manual_seed(0))
    with spans.recording():
        step.with_draws(state, imgs, masks, draws)
    assert _phases(spans.recorded()) == [
        "train.optimizer", "train.augment", "train.forward", "train.loss",
        "train.backward", "train.optimizer", "train.loss"]


def test_seg_train_step_records_its_phases_and_the_confusion_matrix():
    model = build_model("seg_unet", n_classes=3, base_features=4, dropout=0.1)
    state = create_train_state(model, "adam", 1e-3, 1e-4, device="cpu")
    step = make_seg_train_step(3, aug_cfg=AugmentConfig())
    gen = torch.Generator().manual_seed(0)
    imgs = torch.from_numpy(_images(5, 2, 64, 32))
    labels = torch.randint(0, 3, (2, 64, 32), generator=gen, dtype=torch.uint8)
    augment, dropout = step.draws(state.model, 2, gen)
    with profile(activities=[ProfilerActivity.CPU]):
        step.with_draws(state, imgs, labels, augment, dropout)
    names = _phases(spans.recorded())
    assert set(names) == TRAIN_PHASES | {"train.confusion"}
    assert names.index("train.confusion") > names.index("train.backward")


def test_recording_reaches_other_threads_and_names_them():
    seen = []

    def work():
        with spans.span("worker"):
            seen.append(threading.get_native_id())

    with spans.recording():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    (s,) = spans.recorded()
    assert s.name == "worker" and s.thread == seen[0] != threading.get_native_id()
    with spans.span("after"):
        pass
    assert len(spans.recorded()) == 1


def test_threads_recording_at_once_lose_no_span_and_keep_their_own_nesting():
    n_threads, per = (os.cpu_count() or 1) + 4, 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with spans.span("outer"):
                    with spans.span("inner"):
                        pass

        with spans.recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = spans.recorded()
    assert len(got) == 2 * n_threads * per and spans.overwritten() == 0
    assert len({s.id for s in got}) == len(got)
    ids = _by_id(got)
    for s in got:
        if s.name == "inner":
            outer = ids[s.parent]
            assert outer.name == "outer" and s.root == outer.id == outer.root
            assert s.thread == outer.thread
        else:
            assert s.parent is None and s.root == s.id
    assert len({s.thread for s in got}) == n_threads


def test_the_ring_keeps_the_newest_spans_and_counts_the_rest():
    extra = 10
    with spans.recording():
        for i in range(spans.CAPACITY + extra):
            with spans.span(f"s{i}"):
                pass
    got = spans.recorded()
    assert len(got) == spans.CAPACITY and spans.overwritten() == extra
    assert got[0].name == f"s{extra}" and got[-1].name == f"s{spans.CAPACITY + extra - 1}"
    assert all(a.id < b.id for a, b in zip(got, got[1:]))
    spans.clear()
    assert spans.recorded() == [] and spans.overwritten() == 0
