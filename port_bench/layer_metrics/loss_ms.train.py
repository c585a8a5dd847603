"""Device milliseconds per traced ``train.step`` issued under
``train.loss``: the loss, and the mean of the microbatches' losses the
step returns (the program's spans joined to the trace, ``_spans.py``)."""

from port_bench.layer_metrics._spans import phase_device_ms


def read(ctx):
    return phase_device_ms(ctx, "train.step", "train.loss")
