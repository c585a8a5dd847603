"""The whole train step's share of the bf16 dense peak: 3 x the frozen
forward FLOPs (both decoders for AnomalyUNet) x images per second over the
window, in %."""

from port_bench.layer_metrics._common import flops, mfu


def read(ctx):
    return mfu(ctx, flops.forward_per_image(ctx.config), flops.PEAK_BF16, passes=3.0)
