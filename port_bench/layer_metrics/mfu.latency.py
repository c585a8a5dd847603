"""A lone request's forward at the bf16 dense peak: the frozen forward
FLOPs x images per second over the window, in %."""

from port_bench.layer_metrics._common import flops, mfu


def read(ctx):
    return mfu(ctx, flops.forward_per_image(ctx.config), flops.PEAK_BF16)
