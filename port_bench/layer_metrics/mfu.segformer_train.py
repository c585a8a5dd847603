"""The SegFormer train step's share of the bf16 dense peak: 3 x the forward
FLOPs of ``flops_segformer.py`` x images per second over the window, in %."""

from port_bench import flops_segformer
from port_bench.layer_metrics._common import flops, mfu


def read(ctx):
    return mfu(ctx, flops_segformer.forward_per_image(ctx.config), flops.PEAK_BF16, passes=3.0)
