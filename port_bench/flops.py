"""Model FLOPs from the layer shapes, and one NVIDIA H100 SXM's published
dense peaks (at its 700 W limit). A frozen copy of the program's
``utils/flops.py`` formulas for the ladder UNets: 2 FLOPs per multiply-add
over the convolutions, the k2s2 transposed convolutions and the 1x1 heads,
every tap of a 3x3 SAME conv counted. ``torch.utils.flop_counter`` counts
the same on the reference models (tested)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

PEAK_BF16 = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_INT8 = 1979e12  # dense int8 tensor-core OP/s
PEAK_HBM = 3.35e12   # HBM3 bytes/s


def _conv(cin: int, cout: int, h: int, w: int, k: int = 3) -> int:
    return 2 * cin * cout * k * k * h * w


def ladder_convs(base: int, h: int, w: int, n_channels: int, decoders: int
                 ) -> List[Tuple[int, int, int, int]]:
    """(H, W, Cin, Cout) of every 3x3 conv: the encoder's, then each
    decoder's."""
    chans = [base << i for i in range(5)]
    convs = [(h, w, n_channels, base), (h, w, base, base)]
    for i in range(1, 5):
        convs += [(h >> i, w >> i, chans[i - 1], chans[i]), (h >> i, w >> i, chans[i], chans[i])]
    for _ in range(decoders):
        for i in range(4):
            hh, ww = h >> (3 - i), w >> (3 - i)
            convs += [(hh, ww, chans[4 - i], chans[3 - i]), (hh, ww, chans[3 - i], chans[3 - i])]
    return convs


def ladder_forward(base: int, h: int, w: int, n_channels: int, heads: Sequence[int]) -> int:
    """One image's forward through the encoder and one decoder per entry of
    ``heads`` (its head's output channels)."""
    total = sum(_conv(ci, co, hh, ww)
                for hh, ww, ci, co in ladder_convs(base, h, w, n_channels, len(heads)))
    chans = [base << i for i in range(5)]
    for head in heads:
        for i in range(4):
            cin, hh, ww = chans[4 - i], h >> (3 - i), w >> (3 - i)
            total += 2 * cin * (cin // 2) * hh * ww
        total += 2 * base * head * h * w
    return total


def config_heads(config: Dict, score_only: bool = False) -> Tuple[int, ...]:
    """The head widths a configuration's forward runs, as its family's
    module (``port_bench/models/<model>.py``) gives them."""
    from port_bench import models

    return tuple(models.load(config["family"]).heads(config, score_only))


def forward_per_image(config: Dict, score_only: bool = False) -> int:
    return ladder_forward(config["base_features"], config["image_height"],
                          config["image_width"], config.get("n_channels", 3),
                          config_heads(config, score_only))


def conv3x3_int8_bound_s(n: int, h: int, w: int, cin: int, cout: int) -> float:
    """The least time one int8 3x3 SAME conv of a batch of ``n`` needs: the
    larger of its operations at the int8 peak and its bytes at the HBM peak
    (the int8 input and output once, the int8 weights and the float32 scale
    and bias per output channel once)."""
    ops = 2 * 9 * cin * cout * h * w * n
    nbytes = n * h * w * (cin + cout) + 9 * cin * cout + 8 * cout
    return max(ops / PEAK_INT8, nbytes / PEAK_HBM)
