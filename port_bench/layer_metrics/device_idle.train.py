"""The share of the traced window in which nothing ran on the device (no
kernel, copy or set), in % (``_common.idle``)."""

from port_bench.layer_metrics._common import idle


def read(ctx):
    return idle(ctx)
