"""Everything a run makes from its ``--seed``: the model's weights (on the
device, in a few large calls of a ``torch.Generator`` there), the images,
masks and label maps (uint8, on the host), and the augment and dropout
draws (on the device). The same seed gives the same inputs; the program and
the reference are handed the same ones.

Each use draws from its own stream of the seed, so adding a draw to one
leaves the others as they were.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

STREAM_WEIGHTS, STREAM_IMAGES, STREAM_TARGETS, STREAM_DRAWS, STREAM_ORDER, STREAM_CALIB, \
    STREAM_SAMPLE = range(7)


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    seq = np.random.SeedSequence([seed % 2 ** 64, stream])
    return torch.Generator(device=device).manual_seed(int(seq.generate_state(1, np.uint64)[0]) >> 1)


def weights(specs: List[Tuple[str, Tuple[int, ...], str]], seed: int, device
            ) -> Dict[str, torch.Tensor]:
    """float32 weights for the reference's ``specs``: He-normal 3x3 convs,
    normal level-ups and heads (std 1/sqrt(fan in)), biases uniform in
    [-0.1, 0.1], BatchNorm scales 1 + 0.1 z and shifts 0.1 z, running means
    0.1 z and variances uniform in [0.5, 1.5] (a served model's statistics
    are not the identity). One normal and one uniform draw cover them all."""
    g = device_generator(seed, STREAM_WEIGHTS, device)
    normal = [s for s in specs if s[2] in ("conv", "up_weight", "head_weight", "bn_weight",
                                           "bn_bias", "running_mean")]
    uniform = [s for s in specs if s[2] in ("bias", "running_var")]
    z = torch.randn(sum(int(np.prod(s[1])) for s in normal), generator=g, device=device)
    u = torch.rand(sum(int(np.prod(s[1])) for s in uniform), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape, role in normal:
        n = int(np.prod(shape))
        t = z[offset:offset + n].view(shape)
        offset += n
        if role == "conv":
            t = t * (2.0 / (shape[1] * 9)) ** 0.5
        elif role == "up_weight":
            t = t * (1.0 / shape[0]) ** 0.5
        elif role == "head_weight":
            t = t * (1.0 / shape[1]) ** 0.5
        elif role == "bn_weight":
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.clone()
    offset = 0
    for name, shape, role in uniform:
        n = int(np.prod(shape))
        t = u[offset:offset + n].view(shape)
        offset += n
        out[name] = (t - 0.5) * 0.2 if role == "bias" else t + 0.5
    for name, shape, role in specs:
        if role == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return out


def images(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 3) uint8: a random 16-pixel mosaic at half contrast plus
    uniform texture, so flat areas, edges and noise all occur."""
    low = rng.integers(0, 128, (n, -(-h // 16), -(-w // 16), 3), dtype=np.uint8)
    img = low.repeat(16, axis=1).repeat(16, axis=2)[:, :h, :w]
    return img + rng.integers(0, 128, (n, h, w, 3), dtype=np.uint8)


def region_map(rng: np.random.Generator, n: int, h: int, w: int, probs, cell: int
               ) -> np.ndarray:
    """(n, h, w) uint8 class ids, constant on cells of ``cell`` pixels,
    each cell's class drawn with ``probs``: defect regions on a background."""
    low = rng.choice(len(probs), size=(n, -(-h // cell), -(-w // cell)), p=probs)
    return low.astype(np.uint8).repeat(cell, axis=1).repeat(cell, axis=2)[:, :h, :w]


def augment_draws(n: int, aug: Dict, g: torch.Generator) -> Dict[str, torch.Tensor]:
    """One train step's augment draws, with the JAX package's
    distributions: flip with probability ``p_flip``, one angle per batch
    uniform in [-degrees, degrees], brightness, contrast and saturation
    factors uniform in [1 - x, 1 + x], a hue shift uniform in [-hue, hue]."""
    dev = g.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    d = aug["degrees"]
    return {"flip": torch.rand(n, generator=g, device=dev) < aug["p_flip"],
            "angle": uniform((), -d, d),
            "fb": uniform((n, 1, 1, 1), 1 - aug["brightness"], 1 + aug["brightness"]),
            "fc": uniform((n, 1, 1, 1), 1 - aug["contrast"], 1 + aug["contrast"]),
            "fs": uniform((n, 1, 1, 1), 1 - aug["saturation"], 1 + aug["saturation"]),
            "fh": uniform((n, 1, 1), -aug["hue"], aug["hue"])}


def dropout_keep(n: int, channels: int, rate: float, g: torch.Generator) -> torch.Tensor:
    """The bottleneck's (n, channels) channel-dropout keep mask."""
    return torch.rand((n, channels), generator=g, device=g.device) < 1.0 - rate
