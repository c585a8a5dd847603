"""Device milliseconds per traced train step under ``transunet.encoder``
within ``train.forward``: the transformer blocks' forward and the final
LayerNorm, attention cores included."""

from port_bench.layer_metrics._transunet import forward_span_ms


def read(ctx):
    return forward_span_ms(ctx, "transunet.encoder")
