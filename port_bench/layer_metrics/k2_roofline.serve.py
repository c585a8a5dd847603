"""K2's share of its roofline in the traced window: the least time the 3x3
convolutions of the score path need, each the larger of its operations at
the int8 dense peak and its bytes at the HBM peak, per batch served, over
the device time of the ``conv3x3_int8`` kernels, in %."""

from port_bench.layer_metrics._common import flops


def read(ctx):
    if ctx.trace is None or not ctx.traced.requests:
        return None
    kernel_s = ctx.trace.kernel_seconds(lambda name: "conv3x3_int8" in name)
    if kernel_s <= 0:
        return None
    c, n = ctx.config, ctx.traffic["batch"]
    bound = sum(flops.conv3x3_int8_bound_s(n, h, w, cin, cout)
                for h, w, cin, cout in flops.ladder_convs(c["base_features"], c["image_height"],
                                                          c["image_width"],
                                                          c.get("n_channels", 3), decoders=1))
    return 100.0 * bound * ctx.traced.requests / kernel_s
