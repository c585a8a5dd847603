"""The attention cores' share of their roofline in the SegFormer train step's
forward: the least time of a step's cores (per block the larger of 4 B T M C
FLOP at the bf16 peak and the bf16 bytes of q, k, v and the output at the
HBM peak; ``flops_segformer.attention_bound_s``) over the device time per
traced step of the fused attention kernels (``_segformer.ATTENTION``, any of
SDPA's backends) under ``segformer.encoder`` within ``train.forward``, in %."""

from port_bench import flops_segformer
from port_bench.layer_metrics._segformer import ATTENTION, encoder_kernel_ms


def read(ctx):
    ms = encoder_kernel_ms(ctx, ATTENTION)
    if not ms:
        return None
    return 100.0 * flops_segformer.attention_bound_s(ctx.config, ctx.traffic["batch"]) * 1e3 / ms
