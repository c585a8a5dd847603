"""UNet building blocks as PyTorch modules (counterpart of
``tpu_unet/models/blocks.py``).

Module and parameter names follow the reference state_dict
(``double_conv.{0,1,3,4}``, ``maxpool_conv.1``, ``up``/``conv``, ``conv``), so a
reference-layout checkpoint loads with ``strict=True``. Tensors are NCHW
(channels_last in memory on the GPU), PyTorch's habit.

Precision follows the policy, as in the JAX blocks: convolutions run in the
compute dtype with float32 parameters cast at use; the BN affine (or, once
``ops/fold_bn.py`` has folded it, the conv bias) and ReLU run in float32, and
the result is cast back to the compute dtype. The transposed conv and the
1x1 head add their bias in the compute dtype; heads return float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU) twice, optionally with a narrower mid width."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        mid = mid_channels if mid_channels is not None else out_channels
        self.policy = policy
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1, bias=False),
            nn.BatchNorm2d(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        for i in (0, 3):
            conv, norm = self.double_conv[i], self.double_conv[i + 1]
            y = F.conv2d(x.to(cd), conv.weight.to(cd), padding=1)
            y = y.to(self.policy.norm_dtype)
            if conv.bias is not None:  # BN folded into the conv (ops/fold_bn.py)
                y = y + conv.bias.view(-1, 1, 1)
            x = F.relu(norm(y)).to(cd)
        return x


class Down(nn.Module):
    """2x2 max-pool (stride 2) followed by DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_channels, out_channels, policy=policy))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """ConvTranspose k2s2 of x1, pad to the skip's extent, concat(skip, x1),
    DoubleConv. ``in_channels`` is x1's width; the transposed conv halves it."""

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = False,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        if bilinear:
            raise NotImplementedError(
                "bilinear decoders need ops/resize.py, which is not ported yet")
        self.policy = policy
        self.up = nn.ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
        self.conv = DoubleConv(in_channels, out_channels, policy=policy)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x1 = F.conv_transpose2d(x1.to(cd), self.up.weight.to(cd),
                                self.up.bias.to(cd), stride=2)
        # Static pad to the skip's extent (zero for power-of-two sizes).
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2.to(x1.dtype), x1], dim=1))


class OutConv(nn.Module):
    """1x1 convolution head; output cast to the policy's output dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        y = F.conv2d(x.to(cd), self.conv.weight.to(cd), self.conv.bias.to(cd))
        return self.policy.cast_to_output(y)
