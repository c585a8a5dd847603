"""Host milliseconds per traced ``serve.request`` spent in ``serve.k1``,
``serve.forward`` and ``serve.head``: issuing K1, the forward and the
sliced argmax (the program's spans, ``_spans.py``)."""

from port_bench.layer_metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "serve.request", ("serve.k1", "serve.forward", "serve.head"))
