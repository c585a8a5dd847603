"""UNet++ (nested UNet) for multi-class defect segmentation (counterpart of
``tpu_unet/models/unetpp.py``; Zhou et al., arXiv:1912.05074).

Encoder nodes X[i][0] on the b * 2^i channel ladder; nested decoder nodes
X[i][j] = DoubleConv(concat(X[i][0..j-1], up(X[i+1][j-1]))), each b * 2^i
wide. ``up`` is a k2s2 transposed conv (``up{i}_{j}``) or, with
``bilinear=True``, the parameter-free align-corners upsample. The level-up
is zero-padded to the row's extent (odd sizes), split as ``Up`` splits it.

``deep_supervision=True`` puts a 1x1 head on every top-row node X[0][1..4]
(``outc_1``..``outc_4``; else one ``outc`` on X[0][4]). In train mode the
model returns the four head logits, and the train step averages their
losses. In eval mode ``heads=4`` returns ``sum(logits) / 4`` (the paper's
accurate mode) and ``heads=k < 4`` head X[0][k] alone (its pruned fast
mode), computing only the nodes X[i][j] with i + j <= k: the columns deeper
than k do not run (the JAX package gets the same from XLA's dead-code
elimination).

The bottleneck X[4][0] takes SegmentationUNet's channel dropout, its mask a
draw (``models/unet.py::BottleneckDropout``). The class defaults to base 32,
as the JAX package's does; 9,045,924 parameters there at 4 classes.
State_dict names: ``x{i}_{j}.double_conv.*``, ``up{i}_{j}.{weight,bias}``,
``outc.conv.*`` or ``outc_{j}.conv.*``. Tensors are NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.models.blocks import DoubleConv, OutConv, max_pool, up_conv
from tpu_unet_torch.models.unet import BottleneckDropout
from tpu_unet_torch.ops.resize import upsample2x_bilinear_align_corners


def grid_nodes(max_j: int = 4):
    """The (i, j) nodes that head X[0][max_j] needs, in the order they run:
    the encoder column, then column by column."""
    return ([(i, 0) for i in range(max_j + 1)]
            + [(i, j) for j in range(1, max_j + 1) for i in range(max_j - j + 1)])


class UNetPlusPlus(BottleneckDropout, nn.Module):
    """Nested UNet of depth 5 (4 down and up levels)."""

    def __init__(self, n_channels: int = 3, n_classes: int = 4, bilinear: bool = False,
                 deep_supervision: bool = False, heads: int = 4, dropout: float = 0.0,
                 policy: Policy = DEFAULT_POLICY, base_features: int = 32):
        super().__init__()
        if not 1 <= heads <= 4:
            raise ValueError(f"heads must be in 1..4, got {heads}")
        self.policy, self.bilinear = policy, bilinear
        self.deep_supervision, self.heads, self.dropout = deep_supervision, heads, dropout
        b = base_features
        self.bottleneck_channels = 16 * b
        for i, j in grid_nodes():
            if j == 0:
                cin = n_channels if i == 0 else b * 2 ** (i - 1)
            else:
                below = b * 2 ** (i + 1) if bilinear else b * 2 ** i
                cin = j * b * 2 ** i + below
                if not bilinear:
                    self.add_module(f"up{i}_{j}", nn.ConvTranspose2d(
                        b * 2 ** (i + 1), b * 2 ** i, 2, stride=2))
            self.add_module(f"x{i}_{j}", DoubleConv(cin, b * 2 ** i, policy=policy, level=i))
        if deep_supervision:
            for j in range(1, 5):
                self.add_module(f"outc_{j}", OutConv(b, n_classes, policy=policy))
        else:
            self.outc = OutConv(b, n_classes, policy=policy)

    def _up(self, t: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """The level-up of X[i+1][j-1] to level i (under a 'space' scope,
        padded to the level's rows already)."""
        cd = self.policy.compute_dtype
        if self.bilinear:
            return upsample2x_bilinear_align_corners(t, i)
        return up_conv(getattr(self, f"up{i}_{j}"), t, cd, i)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None):
        ds = self.deep_supervision
        max_j = self.heads if ds and not self.training else 4
        grid = {}
        t = self.policy.cast_to_compute(x)
        for i, j in grid_nodes(max_j):
            node = getattr(self, f"x{i}_{j}")
            if j == 0:
                t = node(t if i == 0 else max_pool(t, i))
                grid[i, 0] = self._drop(t, keep) if i == 4 else t
                continue
            below = self._up(grid[i + 1, j - 1], i, j)
            row = [grid[i, k] for k in range(j)]
            dh = row[0].shape[2] - below.shape[2]
            dw = row[0].shape[3] - below.shape[3]
            if dh or dw:
                below = F.pad(below, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            grid[i, j] = node(torch.cat([r.to(below.dtype) for r in row] + [below], dim=1))
        if not ds:
            return self.outc(grid[0, 4])
        if not self.training and self.heads < 4:
            return getattr(self, f"outc_{self.heads}")(grid[0, self.heads])
        logits = tuple(getattr(self, f"outc_{j}")(grid[0, j]) for j in range(1, 5))
        if self.training:
            return logits
        return sum(logits) / 4
