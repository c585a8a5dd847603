"""Post-training integer quantization of a ladder UNet and the integer
arithmetic of its forward, in plain PyTorch (the JAX package's scheme, which
the program follows):

- BatchNorm folded into the convs (``Ladder.fold``);
- weights: symmetric, one scale per output channel, amax / qmax;
- activations: symmetric, one scale per tensor, the absolute maximum over
  the calibration images of the float forward (the input, every ReLU
  output, every level-up) / qmax; a level-up and the skip it is
  concatenated after share one scale, the larger of theirs;
- a conv sums integer products exactly, then y = acc * (s_in * s_w) + b,
  ReLU, and q = round(y / s_out) clipped to [-qmax, qmax]; the max-pool runs
  on the integers; the level-up's output is quantized straight to the
  concat's scale and the skip requantized to it; a head is y = acc * (s_in *
  s_w) + b, then its sigmoid.

``qmax`` is 127 for int8 and 7 for int4, the control's precision. Integer
sums are taken in float64, exact for these widths (|sum| < 2^53).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.augment import normalize, to_unit


def nchw_input(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> the normalised float32 NCHW input."""
    return normalize(to_unit(images_u8)).permute(0, 3, 1, 2)


@torch.no_grad()
def calibrate(model, folded: Dict[str, torch.Tensor], chunks: Iterable[torch.Tensor],
              decoders: Tuple) -> Dict[str, float]:
    """Each tagged tensor's absolute maximum over the calibration chunks
    (uint8 NHWC batches) in the float32 folded forward of ``decoders``."""
    absmax: Dict[str, float] = {}

    def tap(tag, t):
        absmax[tag] = max(absmax.get(tag, 0.0), float(t.abs().amax()))

    for chunk in chunks:
        x = nchw_input(chunk)
        tap("input", x)
        model.forward(folded, x, bn="folded", tap=tap, decoders=decoders)
    return absmax


def _scale(v: float, qmax: int, device) -> torch.Tensor:
    return torch.tensor(np.float32(max(v, 1e-12) / qmax), device=device)


def _per_channel(k: torch.Tensor, dims, qmax: int):
    amax = torch.clamp_min(torch.amax(torch.abs(k), dim=dims), 1e-12)
    s = amax / torch.tensor(float(qmax), device=k.device)
    shape = [-1 if d not in dims else 1 for d in range(k.dim())]
    return torch.round(k / s.view(shape)).clamp(-qmax, qmax), s


def _skip_block(up_index: int) -> str:
    """The block whose output the level-up ``up_index`` (1..4) is
    concatenated after."""
    return "inc" if up_index == 4 else f"down{4 - up_index}.maxpool_conv.1"


@torch.no_grad()
def quantize(folded: Dict[str, torch.Tensor], absmax: Dict[str, float], qmax: int,
             decoders: Tuple) -> Dict:
    """The integer weights with their per-channel scales, and the
    activation scales by tag."""
    device = next(iter(folded.values())).device
    scales = {tag: _scale(v, qmax, device) for tag, v in absmax.items()}
    for suffix, _, _ in decoders:
        for i in range(1, 5):
            up = f"up{i}{suffix}"
            skip = absmax[f"{_skip_block(i)}.relu3"]
            scales[f"{up}.cat"] = _scale(max(skip, absmax[f"{up}.up"]), qmax, device)
    weights = {}
    for name, t in folded.items():
        if not name.endswith("weight"):
            continue
        dims = (0, 2, 3) if name.endswith(".up.weight") else (1, 2, 3)
        weights[name] = _per_channel(t, dims, qmax)
    return {"scales": scales, "weights": weights, "bias": folded, "qmax": qmax}


def _requant(y: torch.Tensor, s: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.clamp(torch.round(y / s), -qmax, qmax)


def _affine(acc: torch.Tensor, s_in, s_w, bias) -> torch.Tensor:
    return acc.to(torch.float32) * (s_in * s_w)[None, :, None, None] + bias[None, :, None, None]


@torch.no_grad()
def forward(q: Dict, images_u8: torch.Tensor, decoder: Tuple) -> torch.Tensor:
    """The head output (NCHW float32, after its sigmoid if it has one) of
    one decoder in integer arithmetic."""
    qmax, scales, weights, bias = q["qmax"], q["scales"], q["weights"], q["bias"]
    x = nchw_input(images_u8)
    s = scales["input"]
    xq = _requant(x, s, qmax)

    def block(prefix, t, s_in):
        for i in (0, 3):
            conv = f"{prefix}.double_conv.{i}"
            wq, sw = weights[f"{conv}.weight"]
            acc = F.conv2d(t.double(), wq.double(), padding=1)
            y = torch.relu(_affine(acc, s_in, sw, bias[f"{conv}.bias"]))
            s_in = scales[f"{prefix}.relu{i}"]
            t = _requant(y, s_in, qmax)
        return t, s_in

    skips = [block("inc", xq, s)]
    for i in range(1, 5):
        t, s_in = skips[-1]
        skips.append(block(f"down{i}.maxpool_conv.1", F.max_pool2d(t, 2), s_in))
    suffix, _, sigmoid = decoder
    t, s_in = skips[4]
    for i in range(1, 5):
        up = f"up{i}{suffix}"
        s_cat = scales[f"{up}.cat"]
        wq, sw = weights[f"{up}.up.weight"]
        acc = F.conv_transpose2d(t.double(), wq.double(), stride=2)
        u = _requant(_affine(acc, s_in, sw, bias[f"{up}.up.bias"]), s_cat, qmax)
        skip, s_skip = skips[4 - i]
        skip = _requant(skip.to(torch.float32) * s_skip, s_cat, qmax)
        t, s_in = block(f"{up}.conv", torch.cat([skip, u], dim=1), s_cat)
    wq, sw = weights[f"outc{suffix}.conv.weight"]
    y = _affine(F.conv2d(t.double(), wq.double()), s_in, sw, bias[f"outc{suffix}.conv.bias"])
    return torch.sigmoid(y) if sigmoid else y
