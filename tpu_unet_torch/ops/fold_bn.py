"""Inference-time BatchNorm folding (counterpart of ``tpu_unet/ops/fold_bn.py``).

Every DoubleConv is Conv(no bias) -> BN -> ReLU, and an attention gate's
three projections are Conv(no bias) -> BN. At inference BN is an affine map
with the running statistics, so it folds into the conv:

    w' = w * gamma / sqrt(var + eps)        (per output channel)
    b' = beta - mean * gamma / sqrt(var + eps)

The JAX fold keeps a residual identity-statistics BN to hold b' (its flax
modules have no conv bias). Here b' becomes the conv's bias and the BN an
``nn.Identity``; the blocks add the bias in float32, where the JAX residual
BN adds it. Equivalent to BN(conv(x)) within float32 rounding.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpu_unet_torch.models.attention import AttentionGate, _GateProj
from tpu_unet_torch.models.blocks import DoubleConv


def _conv_bn_pairs(module: nn.Module):
    """``(owner, conv name, bn name)`` of each conv -> BN pair ``module`` owns."""
    if isinstance(module, DoubleConv):
        return [(module.double_conv, "0", "1"), (module.double_conv, "3", "4")]
    if isinstance(module, _GateProj):
        return [(module, "conv1", "bn1")]
    if isinstance(module, AttentionGate):
        return [(module, "conv2", "bn2")]
    return []


@torch.no_grad()
def fold_batchnorm(model: nn.Module) -> nn.Module:
    """Fold every DoubleConv's and attention gate's BNs into their convs, in
    place; returns ``model``. A tensor-parallel model (channel slices) is
    refused: fold the whole weights of its checkpoint."""
    if getattr(model, "tp_dims", None):
        raise ValueError("fold_batchnorm: a tensor-parallel model holds channel slices; "
                         "fold the whole model its .pth holds (train/checkpoint.py "
                         "gathers the slices)")
    for module in list(model.modules()):
        for owner, conv_name, bn_name in _conv_bn_pairs(module):
            conv, bn = getattr(owner, conv_name), getattr(owner, bn_name)
            if not isinstance(bn, nn.BatchNorm2d):
                continue  # already folded
            inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            conv_bias = conv.bias if conv.bias is not None else 0.0
            conv.weight = nn.Parameter(conv.weight * inv.view(-1, 1, 1, 1))
            conv.bias = nn.Parameter(bn.bias + (conv_bias - bn.running_mean) * inv)
            setattr(owner, bn_name, nn.Identity())
    return model
