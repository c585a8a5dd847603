"""The attention core's share of its roofline in the train step's forward:
the least time of a step's attention cores (per block the larger of 4 B T^2
D FLOP at the bf16 peak and the bf16 bytes of Q, K, V and the output at the
HBM peak; ``flops_transunet.attention_bound_s``) over the device time
under ``transunet.attention`` within ``train.forward`` per traced step, in
%. It reads whatever kernel implements the core."""

from port_bench import flops_transunet
from port_bench.layer_metrics._transunet import forward_span_ms


def read(ctx):
    ms = forward_span_ms(ctx, "transunet.attention")
    if not ms:
        return None
    return 100.0 * flops_transunet.attention_bound_s(ctx.config, ctx.traffic["batch"]) * 1e3 / ms
