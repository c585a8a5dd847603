"""Host milliseconds per traced ``serve.request`` spent in ``serve.put``:
the host batch's upload to the device (the program's spans, ``_spans.py``)."""

from port_bench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "serve.request", ("serve.put",))
