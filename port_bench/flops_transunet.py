"""Model FLOPs of TransUNet (R50-ViT-B/16 hybrid, ``reference/transunet.py``)
from its shapes: 2 FLOPs per multiply-add over every convolution (the
hybrid ResNet's, the 1x1 patch embedding, the decoder's and the head),
every linear and both attention products, Q K^T and P V; norms, softmax,
the upsample and the elementwise work are not counted.
``torch.utils.flop_counter`` counts the same on the reference (tested).
Also the least time of the attention core (the ``attention_roofline``
metric's bound)."""

from __future__ import annotations

from typing import Dict

from port_bench.flops import PEAK_BF16, PEAK_HBM
from port_bench.reference.transunet import skip_widths


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def hybrid_forward(config: Dict) -> int:
    """One image through the hybrid ResNet: root, max-pool, the stages."""
    w, c = config["base_features"], config.get("n_channels", 3)
    h, ww = _out(config["image_height"], 7, 2, 3), _out(config["image_width"], 7, 2, 3)
    total = 2 * c * w * 49 * h * ww
    h, ww = _out(h, 3, 2, 0), _out(ww, 3, 2, 0)
    cin = w
    for s, n in enumerate(config["resnet_units"]):
        cout = w * 4 << s
        mid = cout // 4
        for u in range(n):
            stride = 2 if s > 0 and u == 0 else 1
            ho, wo = _out(h, 3, stride, 1), _out(ww, 3, stride, 1)
            total += 2 * cin * mid * h * ww + 2 * mid * mid * 9 * ho * wo + 2 * mid * cout * ho * wo
            if stride != 1 or cin != cout:
                total += 2 * cin * cout * ho * wo
            cin, h, ww = cout, ho, wo
    return total


def tokens(config: Dict) -> int:
    return (config["image_height"] // 16) * (config["image_width"] // 16)


def attention_core_per_image(config: Dict) -> int:
    """Q K^T and P V of every block, one image: 4 T^2 D a block."""
    return 4 * tokens(config) ** 2 * config["hidden_size"] * config["num_layers"]


def encoder_forward(config: Dict) -> int:
    """One image through the patch embedding and the encoder's blocks."""
    t, d, m = tokens(config), config["hidden_size"], config["mlp_dim"]
    embed = 2 * (config["base_features"] * 4 << (len(config["resnet_units"]) - 1)) * d * t
    linears = config["num_layers"] * (4 * 2 * t * d * d + 2 * 2 * t * d * m)
    return embed + linears + attention_core_per_image(config)


def decoder_forward(config: Dict) -> int:
    """One image through conv_more, the decoder blocks and the head."""
    gh, gw = config["image_height"] // 16, config["image_width"] // 16
    total = 2 * config["hidden_size"] * 512 * 9 * gh * gw
    cin = 512
    for i, (cout, skip) in enumerate(zip(config["decoder_channels"], skip_widths(config))):
        hw = (gh << (i + 1)) * (gw << (i + 1))
        total += 2 * (cin + skip) * cout * 9 * hw + 2 * cout * cout * 9 * hw
        cin = cout
    return total + 2 * cin * config["n_classes"] * 9 * config["image_height"] * \
        config["image_width"]


def forward_per_image(config: Dict) -> int:
    return hybrid_forward(config) + encoder_forward(config) + decoder_forward(config)


def attention_bound_s(config: Dict, n: int) -> float:
    """The least time of one forward's attention cores over a batch of
    ``n``: per block the larger of its products at the bf16 peak and the
    bf16 bytes of Q, K, V and the output, read or written once, at the HBM
    peak."""
    t, d = tokens(config), config["hidden_size"]
    per_block = max(4 * n * t * t * d / PEAK_BF16, 4 * n * t * d * 2 / PEAK_HBM)
    return config["num_layers"] * per_block
