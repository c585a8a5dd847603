"""Device milliseconds per traced ``train.step`` issued under
``train.backward``: ``.backward()``, whose kernels the autograd thread
launches (the program's spans joined to the trace, ``_spans.py``)."""

from port_bench.layer_metrics._spans import phase_device_ms


def read(ctx):
    return phase_device_ms(ctx, "train.step", "train.backward")
