"""Model FLOPs of SegFormer (MiT encoder and all-MLP head,
``reference/segformer.py``) from its shapes: 2 FLOPs per multiply-add over
every convolution (the patch embeddings, the reduction convs, the depthwise
convs, the head's 1x1 convs), every linear and both attention products, Q K^T
and P V; norms, softmax, the resizes and the elementwise work are not
counted. ``torch.utils.flop_counter`` counts the same on the reference
(tested). Also the least time of the attention cores (the
``attention_roofline`` metric's bound)."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from port_bench.flops import PEAK_BF16, PEAK_HBM


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def stages(config: Dict) -> Iterator[Tuple[int, int, int, int, int]]:
    """(C, T, M, depth, the patch embedding's FLOPs) of each stage for one
    image: width, query tokens, key tokens (T over R^2 where R > 1)."""
    h, w, cin = config["image_height"], config["image_width"], config.get("n_channels", 3)
    for i, (c, depth, r) in enumerate(zip(config["embed_dims"], config["depths"],
                                          config["sr_ratios"])):
        k, s = (7, 4) if i == 0 else (3, 2)
        h, w = _out(h, k, s, k // 2), _out(w, k, s, k // 2)
        keys = (h // r) * (w // r) if r > 1 else h * w
        yield c, h * w, keys, depth, 2 * cin * c * k * k * h * w
        cin = c


def encoder_forward(config: Dict) -> int:
    """One image through the four stages."""
    total = 0
    for (c, t, m, depth, embed), r, ratio in zip(stages(config), config["sr_ratios"],
                                                 config["mlp_ratios"]):
        hidden = ratio * c
        per_block = (2 * t * c * c                         # q
                     + (2 * c * c * r * r * m if r > 1 else 0)  # the reduction conv
                     + 2 * m * c * 2 * c                   # kv
                     + 4 * t * m * c                       # Q K^T and P V
                     + 2 * t * c * c                       # proj
                     + 2 * 2 * t * c * hidden              # fc1, fc2
                     + 2 * hidden * 9 * t)                 # the depthwise conv
        total += embed + depth * per_block
    return total


def decoder_forward(config: Dict) -> int:
    """One image through the head: the four linears, linear_fuse and
    linear_pred."""
    e = config["embedding_dim"]
    parts = list(stages(config))
    t1 = parts[0][1]
    return (sum(2 * t * c * e for c, t, _, _, _ in parts) + 2 * t1 * len(parts) * e * e
            + 2 * t1 * e * config["n_classes"])


def forward_per_image(config: Dict) -> int:
    return encoder_forward(config) + decoder_forward(config)


def attention_bound_s(config: Dict, n: int) -> float:
    """The least time of one forward's attention cores over a batch of
    ``n``: per block the larger of 4 n T M C FLOP at the bf16 peak and the
    bf16 bytes of q and the output (n T C each) and of k and v (n M C each),
    read or written once, at the HBM peak."""
    total = 0.0
    for c, t, m, depth, _ in stages(config):
        per_block = max(4 * n * t * m * c / PEAK_BF16, 2 * (2 * n * t * c + 2 * n * m * c) / PEAK_HBM)
        total += depth * per_block
    return total
