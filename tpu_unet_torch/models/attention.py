"""Attention U-Net: additive attention gates on the skip connections
(counterpart of ``tpu_unet/models/attention.py``; Oktay et al.,
arXiv:1804.03999 §3.1).

Before each decoder concat the skip x is reweighted by

    alpha = sigmoid(bn2(conv2(relu(W_g g + W_x x)))),   x_gated = x * alpha

where W_g and W_x are 1x1 convs (no bias) with a BatchNorm each, to
``f_int`` = skip channels // 2, and conv2 maps to one channel. The gate runs
at the coarse resolution: g is the decoder tensor before its upsample, W_x
strides by 2 to meet it (cropped to g's extent for odd sizes) and the
1-channel alpha is resized (align corners) to the skip's extent.

Dtypes follow the JAX gate step by step: the projections and conv2 run in
the compute dtype, their BatchNorms in float32, ``relu(gp + xp)`` is cast to
the compute dtype, the sigmoid, the resize and ``x * alpha`` run in float32,
and the gated skip is cast to the compute dtype.

State_dict names are the JAX module names: ``att.g.conv1``, ``att.g.bn1``,
``att.x.conv1``, ``att.x.bn1``, ``att.conv2``, ``att.bn2``. In train mode the
three BatchNorms update their running statistics as flax's do
(``models/blocks.py::BatchNorm2d``); ``ops/fold_bn.py`` folds all three.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.models.blocks import BatchNorm2d, conv_bn
from tpu_unet_torch.models.unet import SegmentationUNet
from tpu_unet_torch.ops.resize import resize_bilinear_align_corners
from tpu_unet_torch.parallel import spatial


class _GateProj(nn.Module):
    """One gate input projection: 1x1 conv (no bias), BatchNorm; stride 2 for
    the skip's W_x."""

    def __init__(self, in_channels: int, f_int: int, stride: int = 1,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy, self.stride = policy, stride
        self.conv1 = nn.Conv2d(in_channels, f_int, 1, bias=False)
        self.bn1 = BatchNorm2d(f_int)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return conv_bn(self.conv1, self.bn1, v, self.policy, stride=self.stride)


class AttentionGate(nn.Module):
    """``x * resize(sigmoid(psi(relu(W_g g + W_x x))))`` in the compute dtype;
    ``g`` (``g_channels`` wide) is the coarse gating signal, ``x``
    (``x_channels`` wide) the full-resolution skip at ``level`` (g one level
    below)."""

    def __init__(self, g_channels: int, x_channels: int, f_int: int,
                 policy: Policy = DEFAULT_POLICY, level: int = 0):
        super().__init__()
        self.policy, self.level = policy, level
        self.g = _GateProj(g_channels, f_int, policy=policy)
        self.x = _GateProj(x_channels, f_int, stride=2, policy=policy)
        self.conv2 = nn.Conv2d(f_int, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(1)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gp = self.g(g)
        # Odd skip extents make the stride-2 projection one row or column
        # larger than g (ceil against floor): crop, after its BatchNorm as
        # the JAX gate does. Under a 'space' scope the projection samples
        # the image's even rows, and the crop drops the row past g's last.
        xp = self.x(spatial.stride2_rows(x, self.level))[:, :, :gp.shape[2], :gp.shape[3]]
        a = F.relu(gp + xp).to(self.policy.compute_dtype)
        a = conv_bn(self.conv2, self.bn2, a, self.policy)
        alpha = resize_bilinear_align_corners(torch.sigmoid(a), x.shape[2], x.shape[3],
                                              self.level)
        return (x.to(alpha.dtype) * alpha).to(self.policy.compute_dtype)


class AttentionUNet(SegmentationUNet):
    """SegmentationUNet whose decoder Up blocks gate their skips (``upK.att``);
    31,562,476 parameters at base 64 and 4 classes."""

    def __init__(self, n_channels: int = 3, n_classes: int = 4,
                 bilinear: bool = False, dropout: float = 0.1,
                 policy: Policy = DEFAULT_POLICY, base_features: int = 64):
        super().__init__(n_channels, n_classes, bilinear, dropout, policy, base_features,
                         attention=True)
