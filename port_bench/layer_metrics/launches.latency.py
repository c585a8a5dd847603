"""Kernels per traced ``serve.request`` issued under it (the program's
spans joined to the trace, ``_spans.py``; copies and sets not counted)."""

from port_bench.layer_metrics._spans import per_unit


def read(ctx):
    def value(j, units):
        ids = {u.id for u in units}
        return j.count(lambda s: s is not None and s.unit in ids, ("kernel",))

    return per_unit(ctx, "serve.request", value)
