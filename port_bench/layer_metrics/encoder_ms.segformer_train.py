"""Device milliseconds per traced train step under ``segformer.encoder``
within ``train.forward``: the MiT encoder's forward, its patch embeddings,
blocks (attention cores and depthwise convs included) and stage norms."""

from port_bench.layer_metrics._transunet import forward_span_ms


def read(ctx):
    return forward_span_ms(ctx, "segformer.encoder")
