"""The paired train-time augment under given draws, in plain float32
PyTorch. Images NHWC uint8 in, normalised float32 NHWC out; the mask or
label map follows the image's geometry by nearest neighbour.

Order: to [0, 1], horizontal flip, rotation, colour jitter (brightness,
contrast, saturation, hue), ImageNet normalisation.

The rotation is the default mode of the configurations, one angle per batch
realised as three shears (Paeth): x-shear by -tan(theta/2), y-shear by
sin(theta), x-shear again, each about the image centre, each a 1-D linear
interpolation (the mask: the shift rounded half to even), zero outside the
image, and each pass cropped back to the image. Written here as gathers.

Draws (a dict of tensors): ``flip`` (N,) bool, ``angle`` 0-dim degrees,
``fb``, ``fc``, ``fs`` (N, 1, 1, 1) factors, ``fh`` (N, 1, 1) hue shift.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
GRAY = (0.299, 0.587, 0.114)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC -> (x - mean) / std per channel."""
    mean = torch.tensor(MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def to_unit(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.to(torch.float32) / torch.tensor(255.0, device=images_u8.device)


def _shear_rows(x: torch.Tensor, coef: torch.Tensor, nearest: bool) -> torch.Tensor:
    """out[n, r, c] = x[n, r, c + s_r] interpolated, s_r = coef * (r - (R-1)/2),
    zero where the source lies outside the row. x: (N, R, C, K)."""
    n, rows, cols, k = x.shape
    r = torch.arange(rows, dtype=torch.float32, device=x.device) - (rows - 1) / 2.0
    shift = coef.to(torch.float32) * r
    if nearest:
        shift = torch.round(shift)
    lo = torch.floor(shift)
    frac = (shift - lo)[None, :, None, None]
    src = torch.arange(cols, device=x.device)[None, :] + lo.to(torch.int64)[:, None]  # (R, C)

    def take(index):
        inside = ((index >= 0) & (index < cols)).to(x.dtype)[None, :, :, None]
        idx = index.clamp(0, cols - 1)[None, :, :, None].expand(n, rows, cols, k)
        return torch.gather(x, 2, idx) * inside

    return take(src) * (1.0 - frac) + take(src + 1) * frac


def rotate(x: torch.Tensor, angle_deg: torch.Tensor, nearest: bool) -> torch.Tensor:
    """Rotate an NHWC batch counter-clockwise by one angle (degrees)."""
    theta = torch.deg2rad(angle_deg.to(torch.float32))
    a, b = -torch.tan(theta / 2.0), torch.sin(theta)
    x = _shear_rows(x, a, nearest)
    x = _shear_rows(x.transpose(1, 2), b, nearest).transpose(1, 2)
    return _shear_rows(x, a, nearest)


def _gray(x):
    return torch.sum(x * torch.tensor(GRAY, dtype=x.dtype, device=x.device), dim=-1,
                     keepdim=True)


def _hue_shift(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """RGB -> HSV, hue + shift (mod 1), -> RGB (the hexcone model)."""
    r, g, b = x.unbind(-1)
    maxc, minc = x.amax(-1), x.amin(-1)
    delta = maxc - minc
    v = maxc
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, torch.ones_like(maxc)),
                    torch.zeros_like(maxc))
    d = torch.where(delta > 0, delta, torch.ones_like(delta))
    h = torch.where(maxc == r, (g - b) / d,
                    torch.where(maxc == g, 2.0 + (b - r) / d, 4.0 + (r - g) / d))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    h = torch.remainder(h + shift, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    sector = torch.remainder(i, 6).to(torch.int64)
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = torch.zeros_like(x)
    for k, rgb in enumerate(table):
        out = torch.where((sector == k)[..., None], torch.stack(rgb, -1), out)
    return out


def color_jitter(x: torch.Tensor, d: Dict[str, torch.Tensor], aug: Dict) -> torch.Tensor:
    if aug["brightness"] > 0:
        x = torch.clamp(x * d["fb"], 0.0, 1.0)
    if aug["contrast"] > 0:
        mean = _gray(x).mean(dim=(1, 2), keepdim=True)
        x = torch.clamp(d["fc"] * x + (1 - d["fc"]) * mean, 0.0, 1.0)
    if aug["saturation"] > 0:
        x = torch.clamp(d["fs"] * x + (1 - d["fs"]) * _gray(x), 0.0, 1.0)
    if aug["hue"] > 0:
        x = _hue_shift(x, d["fh"])
    return x


def paired_augment(images_u8: torch.Tensor, target: Optional[torch.Tensor],
                   d: Dict[str, torch.Tensor], aug: Dict
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The augmented, normalised images and the target (NHWC, as float32)
    moved with them."""
    if aug.get("rotation_mode", "per_batch_shear") != "per_batch_shear":
        raise ValueError("the reference augment takes rotation_mode 'per_batch_shear'")
    x = to_unit(images_u8)
    flip = d["flip"][:, None, None, None]
    x = torch.where(flip, x.flip(2), x)
    m = None
    if target is not None:
        m = target.to(torch.float32)
        m = torch.where(flip, m.flip(2), m)
    if aug["degrees"] > 0:
        x = rotate(x, d["angle"], nearest=False)
        if m is not None:
            m = rotate(m, d["angle"], nearest=True)
    return normalize(color_jitter(x, d, aug)), m

