"""Spans: named, nested intervals of the port's own work on the host clock.

``with span("serve.put"): ...`` marks a layer boundary. A span records
nothing unless the calling thread is inside a ``torch.profiler`` session
(any activities) or some thread is inside :func:`recording`; otherwise
``span`` returns one shared object whose ``with`` costs a few hundred
nanoseconds and allocates nothing, so the spans stay in the serving and
training paths for good.

A recorded span keeps its name, its start and end (``time.time_ns()``), its
parent (the innermost span open on the same thread when it began, or None),
its root (the outermost span open on that thread: the request or train step
itself where an engine or step is called directly, the epoch's pass under
the trainers' default hook) and its thread (``threading.get_native_id()``,
read once a thread: it is a system call). A reader that wants one request
or step takes the ``serve.request`` or ``train.step`` span by name and its
descendants by parent. Finished spans go into one process-wide ring of
``CAPACITY``; once it is full the oldest are overwritten and counted
(:func:`overwritten`). :func:`recorded` returns what the ring holds, oldest
first, and :func:`write` saves it as JSON (the trainers' ``--profile_dir``
writes ``spans.json`` beside ``trace.json``); nothing else is written.

A chrome trace exported by ``torch.profiler`` puts its events on the same
clock: its ``ts`` is ``time.time_ns()`` less the trace's
``baseTimeNanoseconds`` (the epoch second floored to a multiple of
7,889,238 s), in microseconds.

Names the port uses: ``serve.request`` (each engine call) over
``serve.put``, ``serve.k1``, ``serve.forward``, ``serve.head`` and
``serve.fetch``; ``int8.<op>`` for each op of an int8 plan
(``ops/quantize.py::_run``) and ``kernel.k2`` for each call of
``conv3x3_int8``; ``train.step`` over ``train.augment``,
``train.forward``, ``train.loss``, ``train.backward``,
``train.optimizer`` and ``train.confusion`` (seg); ``transunet.hybrid``,
``transunet.embed``, ``transunet.encoder`` (over ``transunet.attention``)
and ``transunet.decoder`` in TransUNet's forward; ``segformer.encoder``
(over ``segformer.attention`` and ``segformer.dwconv``) and
``segformer.decoder`` in SegFormer's; ``cli.train`` and
``cli.validate`` for the trainers' epoch passes.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import List, NamedTuple, Optional

import torch

CAPACITY = 65536


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    thread: int


_profiling = torch._C._autograd._profiler_enabled
_forced = 0  # open recording() blocks, in any thread
_ids = itertools.count(1)
_lock = threading.Lock()
_ring: List[Optional[Span]] = [None] * CAPACITY
_kept = 0  # spans ever kept; the ring holds the last CAPACITY of them
_local = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "start", "id", "parent", "root", "stack", "thread")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        state = getattr(_local, "state", None)
        if state is None:
            state = _local.state = ([], threading.get_native_id())
        stack, self.thread = state
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        self.stack = stack
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, kind, value, tb):
        end = time.time_ns()
        self.stack.pop()
        _keep(Span(self.name, self.start, end, self.id, self.parent, self.root, self.thread))
        return False


def _keep(s: Span) -> None:
    global _kept
    with _lock:
        _ring[_kept % CAPACITY] = s
        _kept += 1


def span(name: str):
    """A context manager around one piece of the program's work: recorded
    while this thread is under ``torch.profiler`` or a :func:`recording`
    block is open, else a shared no-op."""
    if _forced or _profiling():
        return _On(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans on every thread while the block is open, with or
    without a profiler (for operators and tests)."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def recorded() -> List[Span]:
    """The finished spans the ring holds, oldest first."""
    with _lock:
        if _kept <= CAPACITY:
            return list(_ring[:_kept])
        i = _kept % CAPACITY
        return _ring[i:] + _ring[:i]


def write(path: str) -> None:
    """Save :func:`recorded` and :func:`overwritten` to ``path`` as JSON:
    ``{"spans": [{name, start_ns, end_ns, id, parent, root, thread}],
    "overwritten": n}``."""
    doc = {"spans": [s._asdict() for s in recorded()], "overwritten": overwritten()}
    with open(path, "w") as f:
        json.dump(doc, f)


def overwritten() -> int:
    """How many spans the ring has dropped to make room."""
    return max(0, _kept - CAPACITY)


def clear() -> None:
    """Empty the ring and its count of overwritten spans."""
    global _kept
    with _lock:
        _ring[:] = [None] * CAPACITY
        _kept = 0

