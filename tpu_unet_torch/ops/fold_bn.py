"""Inference-time BatchNorm folding (counterpart of ``tpu_unet/ops/fold_bn.py``).

Every DoubleConv is Conv(no bias) -> BN -> ReLU. At inference BN is an affine
map with the running statistics, so it folds into the conv:

    w' = w * gamma / sqrt(var + eps)        (per output channel)
    b' = beta - mean * gamma / sqrt(var + eps)

The JAX fold keeps a residual identity-statistics BN to hold b' (its flax
modules have no conv bias). Here b' becomes the conv's bias and the BN an
``nn.Identity``; DoubleConv adds the bias in float32, where the JAX residual
BN adds it. Equivalent to BN(conv(x)) within float32 rounding.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpu_unet_torch.models.blocks import DoubleConv


@torch.no_grad()
def fold_batchnorm(model: nn.Module) -> nn.Module:
    """Fold every DoubleConv's BNs into its convs, in place; returns ``model``."""
    for module in model.modules():
        if not isinstance(module, DoubleConv):
            continue
        seq = module.double_conv
        for i in (0, 3):
            conv, bn = seq[i], seq[i + 1]
            if not isinstance(bn, nn.BatchNorm2d):
                continue  # already folded
            inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            conv_bias = conv.bias if conv.bias is not None else 0.0
            conv.weight = nn.Parameter(conv.weight * inv.view(-1, 1, 1, 1))
            conv.bias = nn.Parameter(bn.bias + (conv_bias - bn.running_mean) * inv)
            seq[i + 1] = nn.Identity()
    return model
