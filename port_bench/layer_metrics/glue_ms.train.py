"""Device milliseconds per traced train step in the glue: every device
operation that is neither a convolution, nor BatchNorm, nor Adam."""

from port_bench.layer_metrics._common import is_glue


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.traced.steps:
        return None
    return 1e3 * ctx.trace.kernel_seconds(is_glue) / ctx.traced.steps
