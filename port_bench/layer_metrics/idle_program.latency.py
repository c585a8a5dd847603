"""100 x the device-idle time inside traced ``serve.request`` spans, over
the traced window, in %: the program's part of ``device_idle.latency``;
the rest is the client's own time between requests (the program's spans on
the trace's clock, ``_spans.py``)."""

import bisect

from port_bench.layer_metrics._spans import joined


def read(ctx):
    j = joined(ctx)
    units = j.units_named("serve.request") if j is not None else []
    if not units or not ctx.trace.device:
        return None
    busy = ctx.trace.busy  # sorted, disjoint
    starts = [a for a, _ in busy]
    idle_us = 0.0
    for r in units:
        i = max(bisect.bisect_right(starts, r.start) - 1, 0)
        covered = 0.0
        while i < len(busy) and busy[i][0] < r.end:
            covered += max(0.0, min(busy[i][1], r.end) - max(busy[i][0], r.start))
            i += 1
        idle_us += r.us - covered
    return 100.0 * idle_us / (1e6 * ctx.trace.window_s)
