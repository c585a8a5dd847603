"""Reading a ``torch.profiler`` chrome trace of a traced window.

The profiler wraps the window alone, so the window is the extent of the
trace's kernels, copies, sets and host calls. Device activity is the union
of the intervals of kernels, copies and sets (``kernel``, ``gpu_memcpy``,
``gpu_memset``). The host's events are whatever the profiler recorded on
the CPU: CUDA runtime and driver calls on a card, operators on the CPU.
CPU and device times share the trace's microsecond clock.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SHORT_GAP_US = 50.0  # gaps shorter than this are counted together


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """The events of one traced window."""

    def __init__(self, events: List[Dict]):
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        known = [e for e in events if e.get("cat") in DEVICE_CATS + HOST_CATS]
        if not known:
            raise ValueError("the trace holds no device work and no host calls")
        self.start = min(float(e["ts"]) for e in known)
        self.end = max(float(e["ts"]) + float(e["dur"]) for e in known)
        self.device = [e for e in known if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in known if e.get("cat") in HOST_CATS]
        self.busy = _union([(max(float(e["ts"]), self.start),
                             min(float(e["ts"]) + float(e["dur"]), self.end))
                            for e in self.device])

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def idle_pct(self) -> Optional[float]:
        """100 x the share of the window in which nothing ran on the device;
        None when the trace holds no device activity."""
        if not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def busy_within_s(self, a: float, b: float) -> float:
        """Seconds of device activity inside [a, b] (trace microseconds)."""
        return sum(max(0.0, min(y, b) - max(x, a)) for x, y in self.busy) / 1e6

    def kernel_seconds(self, select) -> float:
        """Seconds of the device events whose name ``select`` accepts."""
        return sum(float(e["dur"]) for e in self.device if select(e.get("name", ""))) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing in their middle: the
        innermost host event there (a CUDA call on a card),
        ``host_outside_calls`` where there was none (the host in its own
        Python), and gaps under 50 us together as ``shorter_gaps``."""
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device:
            ops[e.get("name", "")[:64]] += float(e["dur"]) / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        edges = [self.start] + [t for iv in self.busy for t in iv] + [self.end]
        host = sorted(self.host, key=lambda e: e["ts"])
        nxt, active = 0, []
        for a, b in zip(edges[0::2], edges[1::2]):  # in time order
            if b <= a:
                continue
            if b - a < SHORT_GAP_US:
                gaps["shorter_gaps"] += (b - a) / 1e6
                continue
            mid = (a + b) / 2
            while nxt < len(host) and host[nxt]["ts"] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [e for e in active if e["ts"] + e["dur"] >= mid]
            name = min(active, key=lambda e: e["dur"])["name"] if active else "host_outside_calls"
            gaps[name[:64]] += (b - a) / 1e6
        def rank(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
