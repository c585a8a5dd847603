"""The program's own spans joined to the traced window's device trace.

The port records spans (``tpu_unet_torch/utils/spans.py``: name, start and
end in ``time.time_ns()``, parent, root, thread) while a ``torch.profiler``
session runs, so in the traced window alone; :func:`program_spans` reads
them, and returns None where the program has no recorder. A chrome trace's
``ts`` is ``time.time_ns()`` in microseconds less a base, the epoch second
floored to a multiple of 7,889,238 s (``baseTimeNanoseconds``), so a span
goes onto the trace's clock by that rule alone. The readers count per
unit: a ``train.step`` or ``serve.request`` span, taken by name at any
depth (under the trainers' default hook a step's root is its epoch's pass).
Each unit that lies wholly inside the trace's window is kept with its
descendants; spans outside every unit are not.

Each device event (kernel, copy or set) is joined to the CUDA runtime or
driver call that issued it through ``args["correlation"]``; the call's
host time assigns the event to the innermost kept span open at that
moment, on any thread: the one that began last. So the backward's kernels,
which the autograd thread launches while the calling thread sits in
``train.backward``, fall there. (The trace's thread ids for CUDA calls are
not the system's, so the join cannot prefer the calling thread's spans.)
Device events with no such call are ``unmatched``; those issued while no
kept span was open are ``outside``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

TRACE_BASE_S = 7889238
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNITS = ("train.step", "serve.request")


class Span(NamedTuple):
    """A program span on the trace's clock (microseconds), with the id of
    the unit it belongs to (its own for a unit)."""
    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    unit: int
    thread: int

    @property
    def us(self) -> float:
        return self.end - self.start


def trace_us(ns: int) -> float:
    """A ``time.time_ns()`` reading on the chrome trace's clock."""
    base = ns // 10**9 // TRACE_BASE_S * TRACE_BASE_S * 10**9
    return (ns - base) / 1e3


def program_spans() -> Optional[list]:
    """The spans the program's recorder holds; None where it has none."""
    try:
        from tpu_unet_torch.utils.spans import recorded
    except ImportError:
        return None
    return recorded()


@dataclass
class Joined:
    """The kept spans and where each device event of the trace came from."""
    spans: Dict[int, Span]
    units: List[Span]
    issued: List[tuple] = field(default_factory=list)  # (device event, innermost Span or None)
    unmatched: List[dict] = field(default_factory=list)

    def units_named(self, name: str) -> List[Span]:
        return [u for u in self.units if u.name == name]

    def names_above(self, s: Optional[Span]) -> List[str]:
        """``s``'s name and those of its ancestors, innermost first."""
        out = []
        while s is not None:
            out.append(s.name)
            s = self.spans.get(s.parent) if s.parent is not None else None
        return out

    def under(self, s: Optional[Span], name: str) -> bool:
        return name in self.names_above(s)

    def outside(self) -> List[dict]:
        return [e for e, s in self.issued if s is None]

    def device_us(self, select: Callable[[Optional[Span]], bool]) -> float:
        """Device microseconds of the matched events whose innermost span
        ``select`` accepts."""
        return sum(float(e["dur"]) for e, s in self.issued if select(s))

    def count(self, select: Callable[[Optional[Span]], bool], cats: tuple) -> int:
        return sum(1 for e, s in self.issued if e.get("cat") in cats and select(s))

    def host_us(self, units: List[Span], names) -> float:
        """Host microseconds of the descendants of ``units`` named in
        ``names`` (one under another of ``names`` counts once, in it)."""
        ids = {u.id for u in units}
        return sum(s.us for s in self.spans.values()
                   if s.unit in ids and s.id != s.unit and s.name in names
                   and not any(n in names for n in self.names_above(self.spans.get(s.parent))))


def join(trace, recorded) -> Optional[Joined]:
    """Join ``recorded`` (the program's spans) to ``trace``; None where no
    span was recorded or no unit lies inside the window."""
    if not recorded:
        return None
    every = {s.id: s for s in recorded}
    spans = {}
    for s in recorded:
        u = s  # the innermost unit at or above s
        while u is not None and u.name not in UNITS:
            u = every.get(u.parent)
        if u is not None and trace.start <= trace_us(u.start_ns) and trace_us(u.end_ns) <= trace.end:
            spans[s.id] = Span(s.name, trace_us(s.start_ns), trace_us(s.end_ns), s.id, s.parent,
                               u.id, s.thread)
    if not spans:
        return None
    out = Joined(spans, sorted((s for s in spans.values() if s.id == s.unit),
                               key=lambda u: u.start))

    launches = {}
    for e in trace.host:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches.setdefault(corr, e)
    matched = []
    for e in trace.device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            out.unmatched.append(e)
        else:
            matched.append((float(launch["ts"]), e))
    matched.sort(key=lambda m: m[0])

    # One sweep in time: the spans open at each launch.
    order = sorted(spans.values(), key=lambda s: (s.start, s.id))
    nxt, active = 0, []
    for ts, e in matched:
        while nxt < len(order) and order[nxt].start <= ts:
            active.append(order[nxt])
            nxt += 1
        active = [s for s in active if s.end >= ts]
        out.issued.append((e, active[-1] if active else None))
    return out


def joined(ctx) -> Optional[Joined]:
    """The traced window's join, or None where the run traced nothing or
    the program recorded no spans."""
    return None if ctx.trace is None else join(ctx.trace, program_spans())


def per_unit(ctx, unit: str, value: Callable[[Joined, List[Span]], float],
             device: bool = True) -> Optional[float]:
    """``value(joined, units)`` over the kept spans named ``unit``, divided
    by their number; None where there are none, or where ``device`` and the
    trace holds no device work."""
    j = joined(ctx)
    units = j.units_named(unit) if j is not None else []
    if not units or device and not ctx.trace.device:
        return None
    return value(j, units) / len(units)


def phase_device_ms(ctx, unit: str, phase: str) -> Optional[float]:
    """Device milliseconds per kept ``unit`` span issued under ``phase``."""
    def value(j, units):
        ids = {u.id for u in units}
        return j.device_us(lambda s: s is not None and s.unit in ids and j.under(s, phase)) / 1e3

    return per_unit(ctx, unit, value)


def host_ms(ctx, unit: str, names) -> Optional[float]:
    """Host milliseconds per kept ``unit`` span in its descendants ``names``."""
    return per_unit(ctx, unit, lambda j, units: j.host_us(units, set(names)) / 1e3,
                    device=False)

