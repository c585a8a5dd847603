"""Model FLOPs from the layer shapes, and the card's peak rates.

The forward counts are 2 FLOPs per multiply-add over a model's convolutions,
transposed convolutions, 1x1 heads and gate projections, with every tap of a
3x3 SAME conv counted (the zero padding included). PyTorch's
``torch.utils.flop_counter.FlopCounterMode`` counts the same on the port's
models (tested; on the attention UNet it adds the gates' resize products);
XLA's cost analysis counts only the taps that land inside the input, and
adds elementwise work, so it differs (PERF.md).

The peaks are one NVIDIA H100 SXM's published dense rates at its 700 W
limit.
"""

from __future__ import annotations

from typing import Sequence

PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core rate
PEAK_HBM_BPS = 3.35e12    # HBM3
PEAK_INT8_OPS = 1979e12   # dense int8 tensor-core rate
PEAK_F32_FLOPS = 67e12    # float32 outside the tensor cores


def _conv(cin: int, cout: int, h: int, w: int, k: int = 3) -> int:
    return 2 * cin * cout * k * k * h * w


def _unet_flops(base: int, h: int, w: int, n_channels: int, heads: Sequence[int]) -> int:
    """Model FLOPs of one ladder-UNet forward on one h x w image: the shared
    encoder, then one decoder per entry of ``heads`` (its head's output
    channels), each level-up a k2s2 transposed conv."""
    chans = [base * 2 ** i for i in range(5)]
    total = _conv(n_channels, base, h, w) + _conv(base, base, h, w)
    for i in range(1, 5):
        total += (_conv(chans[i - 1], chans[i], h >> i, w >> i)
                  + _conv(chans[i], chans[i], h >> i, w >> i))
    for head in heads:
        for i in range(4):
            cin, cout, hh, ww = chans[4 - i], chans[3 - i], h >> (3 - i), w >> (3 - i)
            total += (2 * cin * (cin // 2) * hh * ww + _conv(cin, cout, hh, ww)
                      + _conv(cout, cout, hh, ww))
        total += 2 * base * head * h * w
    return total


def forward_flops(base: int, size: int, n_channels: int = 3) -> int:
    """Model FLOPs of one AnomalyUNet forward (the reconstruction and
    segmentation decoders) on one size x size image."""
    return _unet_flops(base, size, size, n_channels, (n_channels, 1))


def seg_forward_flops(base: int, h: int, w: int, n_classes: int, n_channels: int = 3) -> int:
    """Model FLOPs of one UNet or SegmentationUNet forward on one h x w image."""
    return _unet_flops(base, h, w, n_channels, (n_classes,))


def unetpp_convs(base: int, h: int, w: int, max_j: int = 4):
    """(H, W, Cin, Cout) of UNet++'s 3x3 convs (two per node X[i][j], in the
    int8 plan's order: the encoder column, then column by column) for the
    head X[0][max_j]: 30 at max_j 4, 6 at max_j 1."""
    nodes = ([(i, 0) for i in range(max_j + 1)]
             + [(i, j) for j in range(1, max_j + 1) for i in range(max_j - j + 1)])
    convs = []
    for i, j in nodes:
        c = base * 2 ** i
        cin = (3 if i == 0 else c // 2) if j == 0 else (j + 1) * c
        convs += [(h >> i, w >> i, cin, c), (h >> i, w >> i, c, c)]
    return convs


def unetpp_forward_flops(base: int, h: int, w: int, n_classes: int,
                         n_channels: int = 3) -> int:
    """Model FLOPs of one UNet++ forward with deep supervision (every node,
    the four heads) on one h x w image: the 3x3 convs, the k2s2 level-ups
    and the heads."""
    total = sum(2 * 9 * hh * ww * cin * cout for hh, ww, cin, cout in unetpp_convs(base, h, w))
    total += 2 * 9 * h * w * (n_channels - 3) * base  # the first conv's other inputs
    for j in range(1, 5):
        for i in range(5 - j):
            c = base * 2 ** i
            total += 2 * (2 * c) * c * (h >> i) * (w >> i)
    return total + 4 * 2 * base * n_classes * h * w


def attn_forward_flops(base: int, h: int, w: int, n_classes: int, n_channels: int = 3) -> int:
    """Model FLOPs of one attention UNet forward: SegmentationUNet's and the
    four gates' 1x1 projections at the coarse resolution."""
    total = seg_forward_flops(base, h, w, n_classes, n_channels)
    for level in range(1, 5):  # up4..up1 gate at levels 1..4 (coarse = level)
        cg, cx = base * 2 ** level, base * 2 ** (level - 1)
        f_int = max(1, cx // 2)
        total += 2 * (cg + cx + 1) * f_int * (h >> level) * (w >> level)
    return total

