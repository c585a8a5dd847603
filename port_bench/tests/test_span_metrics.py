"""The program's spans joined to a hand-made device trace
(``layer_metrics/_spans.py``) and the readers of the span metrics."""

import sys
from collections import namedtuple

import pytest

from port_bench import cells, spec
from port_bench.layer_metrics import _spans
from port_bench.run import Context
from port_bench.trace import Trace

# The recorder's span: name, start and end in time.time_ns(), id, parent, root, thread.
Rec = namedtuple("Rec", "name start_ns end_ns id parent root thread")
BASE_NS = 1790857026 * 10**9  # a multiple of 7,889,238 s: a trace's base
MAIN, AUTOGRAD, OTHER = 101, 102, 103  # thread ids

SPAN_METRICS = ("augment_ms.train", "forward_ms.train", "loss_ms.train", "backward_ms.train",
                "optimizer_ms.train", "put_ms.serve", "int8_glue_ms.serve", "put_ms.latency",
                "dispatch_ms.latency", "launches.latency", "idle_program.latency")


class _Spans:
    """Spans built in trace microseconds, recorded in time.time_ns()."""

    def __init__(self):
        self.recs = []

    def add(self, name, start_us, end_us, thread=MAIN, parent=None):
        sid = len(self.recs) + 1
        root = sid if parent is None else next(r.root for r in self.recs if r.id == parent)
        self.recs.append(Rec(name, BASE_NS + int(start_us * 1000), BASE_NS + int(end_us * 1000),
                             sid, parent, root, thread))
        return sid


def _launch(ts, corr, tid=MAIN, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 5, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(ts, dur, corr, cat="kernel", name="k"):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _ctx(events, recs, monkeypatch, steps=0, requests=0):
    monkeypatch.setattr(_spans, "program_spans", lambda: recs)
    rec = cells.Record(seconds=1.0, images=1, steps=steps, requests=requests)
    return Context({}, {}, rec, rec, Trace(events))


def _train_case(epoch=False):
    """Two kept steps on the main thread (and one cut by the window's start),
    a backward kernel launched by the autograd thread, a request on another
    thread open across the backward's launch and launching in it, an
    unmatched kernel and one launched outside every step or request. The
    window is 1000-3000 us. With ``epoch`` the steps are children of a
    ``cli.train`` span that outlasts the window, as under the trainers."""
    s = _Spans()
    top = s.add("cli.train", 900, 3100) if epoch else None
    s.add("train.step", 950, 1005, parent=top)  # starts before the window: dropped
    r1 = s.add("train.step", 1010, 2000, parent=top)
    s.add("train.augment", 1010, 1100, parent=r1)
    s.add("train.forward", 1100, 1300, parent=r1)
    s.add("train.loss", 1300, 1350, parent=r1)
    s.add("train.backward", 1350, 1600, parent=r1)
    s.add("train.optimizer", 1600, 1700, parent=r1)
    r2 = s.add("train.step", 2000, 2900, parent=top)
    s.add("train.forward", 2010, 2100, parent=r2)
    s.add("serve.request", 1340, 1630, thread=OTHER)
    events = [
        _launch(1000, 0),                      # the window starts here
        _launch(1020, 1), _kernel(1400, 50, 1),        # augment
        _launch(1150, 2), _kernel(1460, 100, 2),       # forward
        _launch(1400, 3, tid=AUTOGRAD), _kernel(1600, 200, 3),  # backward, other thread
        _launch(1410, 4, tid=OTHER), _kernel(1800, 20, 4),      # backward began later
        _launch(1620, 9, tid=OTHER), _kernel(1820, 10, 9),      # the request alone is open
        _launch(1650, 5), _kernel(1850, 30, 5, cat="gpu_memset"),  # optimizer
        _launch(1950, 6), _kernel(1900, 40, 6),        # train.step, no phase
        _launch(2050, 7), _kernel(2100, 60, 7),        # step 2's forward
        _kernel(2200, 70, 99),                         # no launch: unmatched
        _kernel(2300, 80, None),                       # no correlation: unmatched
        _launch(2950, 8), _kernel(2960, 40, 8, cat="gpu_memcpy"),  # outside every span
    ]
    return events, s.recs


def test_the_clock_rule():
    assert _spans.trace_us(BASE_NS + 1234567) == pytest.approx(1234.567)
    assert _spans.trace_us(BASE_NS - 1) > 7.8e12  # the previous base


def test_join_by_correlation_innermost_span_and_window(monkeypatch):
    events, recs = _train_case()
    j = _spans.join(Trace(events), recs)
    assert [u.start for u in j.units_named("train.step")] == [1010, 2000]
    assert len(j.units_named("serve.request")) == 1
    assert all(s.unit != 1 for s in j.spans.values())  # the cut step is gone
    where = {e["args"]["correlation"]: (s.name if s else None) for e, s in j.issued}
    assert where == {1: "train.augment", 2: "train.forward", 3: "train.backward",
                     4: "train.backward", 9: "train.optimizer", 5: "train.optimizer",
                     6: "train.step", 7: "train.forward", 8: None}
    assert [e["dur"] for e in j.unmatched] == [70, 80]
    assert [e["dur"] for e in j.outside()] == [40]


def test_the_train_phase_metrics(monkeypatch):
    events, recs = _train_case()
    ctx = _ctx(events, recs, monkeypatch, steps=2)
    got = {m: spec.reader(m)(ctx) for m in SPAN_METRICS[:5]}
    assert got == pytest.approx({"augment_ms.train": 0.050 / 2, "forward_ms.train": 0.160 / 2,
                                 "loss_ms.train": 0.0, "backward_ms.train": 0.220 / 2,
                                 "optimizer_ms.train": 0.040 / 2})


def test_steps_under_an_epoch_span_are_the_units(monkeypatch):
    """A step whose root is its epoch's span, which no window holds, is
    kept and read as a step alone; a launch under the epoch alone is
    outside."""
    alone = {m: spec.reader(m)(_ctx(*_train_case(), monkeypatch, steps=2))
             for m in SPAN_METRICS[:5]}
    events, recs = _train_case(epoch=True)
    j = _spans.join(Trace(events), recs)
    assert [u.start for u in j.units_named("train.step")] == [1010, 2000]
    assert "cli.train" not in {s.name for s in j.spans.values()}
    assert [e["dur"] for e in j.outside()] == [40]
    got = {m: spec.reader(m)(_ctx(events, recs, monkeypatch, steps=2)) for m in SPAN_METRICS[:5]}
    assert got == pytest.approx(alone) and None not in got.values()


def _serve_case():
    """Two requests at 1000-1400 and 2000-2400 us in a 990-3000 us window,
    each: put, k1, forward (an int8 op holding a K2 call), head, fetch."""
    s = _Spans()
    events = [_launch(990, 0)]  # the window starts here
    for i, t in enumerate((1000, 2000)):
        r = s.add("serve.request", t, t + 400)
        s.add("serve.put", t + 10, t + 60, parent=r)
        s.add("serve.k1", t + 60, t + 70, parent=r)
        fwd = s.add("serve.forward", t + 70, t + 200, parent=r)
        op = s.add("int8.double_conv", t + 80, t + 150, parent=fwd)
        s.add("kernel.k2", t + 90, t + 100, parent=op)
        s.add("serve.head", t + 200, t + 220, parent=r)
        s.add("serve.fetch", t + 220, t + 400, parent=r)
        c = 10 * i
        events += [
            _launch(t + 20, c + 1, name="cudaMemcpyAsync"),
            _kernel(t + 30, 40, c + 1, cat="gpu_memcpy"),        # put: busy t+30..t+70
            _launch(t + 65, c + 2), _kernel(t + 100, 10, c + 2),  # k1: t+100..t+110
            _launch(t + 95, c + 3), _kernel(t + 110, 100, c + 3),   # K2: t+110..t+210
            _launch(t + 120, c + 4), _kernel(t + 210, 30, c + 4),   # glue: t+210..t+240
            _launch(t + 180, c + 5), _kernel(t + 240, 20, c + 5),   # glue: t+240..t+260
            _launch(t + 210, c + 6), _kernel(t + 260, 10, c + 6),   # head: t+260..t+270
        ]
    events.append(_launch(2995, 99))  # the window ends at 3000
    return events, s.recs


def test_the_serving_metrics(monkeypatch):
    events, recs = _serve_case()
    ctx = _ctx(events, recs, monkeypatch, requests=2)
    got = {m: spec.reader(m)(ctx) for m in SPAN_METRICS[5:]}
    # busy inside each request: 40 + 10 + 100 + 30 + 20 + 10 = 210 us of 400
    assert got == pytest.approx({"put_ms.serve": 0.050, "put_ms.latency": 0.050,
                                 "int8_glue_ms.serve": 0.050,
                                 "dispatch_ms.latency": (0.010 + 0.130 + 0.020),
                                 "launches.latency": 5.0,
                                 "idle_program.latency": 100.0 * 2 * 190 / 2010})


def test_a_program_without_the_recorder_has_no_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_unet_torch.utils.spans", None)
    assert _spans.program_spans() is None


@pytest.mark.parametrize("recs", [None, []], ids=["no recorder", "nothing recorded"])
def test_every_span_metric_is_none_without_spans(monkeypatch, recs):
    events, _ = _serve_case()
    ctx = _ctx(events, recs, monkeypatch, steps=2, requests=2)
    assert {m: spec.reader(m)(ctx) for m in SPAN_METRICS} == dict.fromkeys(SPAN_METRICS)
    assert spec.reader("put_ms.serve")(Context({}, {}, ctx.window, None, None)) is None


def test_the_device_metrics_are_none_on_a_trace_without_device_work(monkeypatch):
    events, recs = _serve_case()
    host_only = [e for e in events if e["cat"] == "cuda_runtime"]
    ctx = _ctx(host_only, recs, monkeypatch, requests=2)
    assert spec.reader("int8_glue_ms.serve")(ctx) is None
    assert spec.reader("launches.latency")(ctx) is None
    assert spec.reader("put_ms.serve")(ctx) == pytest.approx(0.050)
