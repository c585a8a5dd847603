"""Device milliseconds per traced train step under ``transunet.hybrid``
within ``train.forward``: the hybrid ResNet's forward (the program's spans
joined to the trace)."""

from port_bench.layer_metrics._transunet import forward_span_ms


def read(ctx):
    return forward_span_ms(ctx, "transunet.hybrid")
