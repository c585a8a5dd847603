"""Device milliseconds per traced ``serve.request`` issued under
``serve.forward`` but not under ``kernel.k2``: everything the int8
executor runs beside K2, that is its requantisation, copies and float
islands and also its ``torch._int_mm`` GEMMs (the transposed convs and the
head), which a GEMM change moves too (the program's spans joined to the
trace, ``_spans.py``)."""

from port_bench.layer_metrics._spans import per_unit


def read(ctx):
    def value(j, units):
        ids = {u.id for u in units}
        return j.device_us(lambda s: s is not None and s.unit in ids
                           and j.under(s, "serve.forward") and not j.under(s, "kernel.k2")) / 1e3

    return per_unit(ctx, "serve.request", value)
