"""Device milliseconds per traced train step of the Mix-FFN's depthwise 3x3
convs, every block's, in the forward: the kernels named as depthwise convs
(``_segformer.DWCONV``) under ``segformer.encoder`` within
``train.forward``."""

from port_bench.layer_metrics._segformer import DWCONV, encoder_kernel_ms


def read(ctx):
    return encoder_kernel_ms(ctx, DWCONV)
