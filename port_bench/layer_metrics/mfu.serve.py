"""The score-only forward's share of the int8 dense peak: its frozen FLOPs
(encoder, reconstruction decoder, head) x images per second over the window,
in %."""

from port_bench.layer_metrics._common import flops, mfu


def read(ctx):
    return mfu(ctx, flops.forward_per_image(ctx.config, score_only=True), flops.PEAK_INT8)
