"""The trace reader on a hand-made chrome trace."""

import json

import pytest

from port_bench.trace import Trace


def _trace():
    ev = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts,  # noqa: E731
                                     "dur": dur}
    return [
        ev("cudaMemcpyAsync", "cuda_runtime", 1000, 100),  # the window starts here
        ev("k_a", "kernel", 1100, 200),        # busy 1100-1300
        ev("k_b", "kernel", 1250, 100),        # overlaps: busy to 1350
        ev("cudaLaunchKernel", "cuda_runtime", 1400, 250),
        ev("Memcpy HtoD", "gpu_memcpy", 1700, 100),
        ev("k_c", "kernel", 1900, 100),        # the window ends at 2000
        ev("gpu_annot", "gpu_user_annotation", 500, 2000),  # neither device work nor host
        {"ph": "i", "name": "marker", "ts": 3000},          # not a complete event
    ]


def test_idle_share_and_busy_time():
    t = Trace(_trace())
    assert (t.start, t.end) == (1000.0, 2000.0)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((250 + 100 + 100) / 1e6)
    assert t.idle_pct() == pytest.approx(55.0)
    assert t.busy_within_s(1000, 1500) == pytest.approx(250 / 1e6)
    assert t.kernel_seconds(lambda n: n.startswith("k_")) == pytest.approx(400 / 1e6)


def test_breakdown_names_the_host_in_each_gap(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    b = Trace.from_file(str(path)).breakdown()
    gaps = dict(b["idle_gaps"])
    assert gaps["cudaMemcpyAsync"] == pytest.approx(100 / 1e6)        # 1000-1100
    assert gaps["cudaLaunchKernel"] == pytest.approx(350 / 1e6)       # 1350-1700
    assert gaps["host_outside_calls"] == pytest.approx(100 / 1e6)     # 1800-1900
    assert dict(b["device_ops"])["k_a"] == pytest.approx(200 / 1e6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_a_trace_without_device_work_has_no_idle_share():
    t = Trace([e for e in _trace() if e.get("cat") not in ("kernel", "gpu_memcpy")])
    assert t.idle_pct() is None


def test_a_trace_with_nothing_to_read_is_refused():
    with pytest.raises(ValueError):
        Trace([e for e in _trace() if e.get("cat") == "gpu_user_annotation"])
