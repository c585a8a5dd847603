"""Device milliseconds per traced train step under ``segformer.decoder``
within ``train.forward``: the all-MLP head's forward, from the four stages'
linears through the upsamples, the concat, ``linear_fuse`` with its
BatchNorm, the dropout and ``linear_pred`` to the logits' upsample."""

from port_bench.layer_metrics._transunet import forward_span_ms


def read(ctx):
    return forward_span_ms(ctx, "segformer.decoder")
