"""Rotation as three shears (counterpart of ``tpu_unet/ops/rotate_shear.py``).

    R(theta) = Shear_x(-tan(theta/2)) . Shear_y(sin(theta)) . Shear_x(-tan(theta/2))

Row y of an x-shear moves by a subpixel shift; the y-shear is an x-shear of
the transposed image. Zero fill at the borders. ``order=1`` lerps the two
taps of each output value; ``order=0`` takes one tap at the shift rounded
half to even, so mask values are only permuted.

- :func:`rotate_batch_shear`: ONE angle for the batch; each shear is a
  batched matmul of zero-padded (N*C, H, W') planes by (H, W', W') banded
  lerp operators (the composed route's 'per_batch_shear').
- :func:`rotate_batch_shear_per_sample`: one angle per image, or a 0-dim
  angle for the batch; each shear is cropped to the image and evaluated as
  a gather of its one or two taps (the composed route's 'per_sample_shear',
  and under both shear modes the plain version of the one-pass augment
  kernel, ``ops/kernels/augment.py``, whose ``csrc/augment_u8.cu`` computes
  the same gathers).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def shear_coefficients(angle_deg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The x- and y-shear coefficients ``-tan(theta / 2)`` and ``sin(theta)``
    of an angle in degrees (the kernel's launch passes these same values)."""
    theta = torch.deg2rad(angle_deg.to(torch.float32))
    return -torch.tan(theta / 2.0), torch.sin(theta)


def _row_shifts(coef: torch.Tensor, h: int, nearest: bool) -> torch.Tensor:
    """Row y's shift coef * (y - (H - 1) / 2), (N or 1, H); rounded half to
    even under ``nearest``."""
    rows = torch.arange(h, dtype=torch.float32, device=coef.device) - (h - 1) / 2.0
    s = coef.reshape(-1, 1) * rows
    return torch.round(s) if nearest else s


# ---------------------------------------------------------------------------
# One angle for the batch: dense banded operators
# ---------------------------------------------------------------------------

def _shear_operator(shifts: torch.Tensor, size: int) -> torch.Tensor:
    """(H, size, size) banded lerp matrices: out[h, o] = in[h, o + shifts[h]]."""
    lo = torch.floor(shifts)
    frac = (shifts - lo)[:, None, None].to(torch.float32)
    lo = lo.to(torch.int32)[:, None, None]
    o = torch.arange(size, dtype=torch.int32, device=shifts.device)[None, :, None]
    i = torch.arange(size, dtype=torch.int32, device=shifts.device)[None, None, :]
    d = i - o - lo
    zero = torch.zeros((), dtype=torch.float32, device=shifts.device)
    return torch.where(d == 0, 1.0 - frac, torch.where(d == 1, frac, zero))


def _pad_shear_crop_x(x: torch.Tensor, shear: torch.Tensor, pad: int,
                      order: int) -> torch.Tensor:
    w = x.shape[2]
    xp = torch.nn.functional.pad(x, (pad, pad))
    m = _shear_operator(_row_shifts(shear, x.shape[1], order == 0)[0], w + 2 * pad)
    out = torch.einsum("hoi,bhi->bho", m, xp)
    return out[:, :, pad:pad + w]


def rotate_batch_shear(images: torch.Tensor, angle_deg: torch.Tensor,
                       max_degrees: float, order: int = 1) -> torch.Tensor:
    """Rotate an NHWC batch CCW by ONE shared angle (a 0-dim tensor, degrees)
    through three shear matmuls. ``max_degrees`` sizes the zero padding."""
    a, b = shear_coefficients(angle_deg)
    n, h, w, c = images.shape
    pad_x = int(math.ceil(math.tan(math.radians(max_degrees) / 2.0) * (h / 2.0))) + 2
    pad_y = int(math.ceil(math.sin(math.radians(max_degrees)) * (w / 2.0 + pad_x))) + 2
    x = images.to(torch.float32).permute(0, 3, 1, 2).reshape(n * c, h, w)
    x = _pad_shear_crop_x(x, a, pad_x, order)                                # horizontal
    x = _pad_shear_crop_x(x.transpose(1, 2), b, pad_y, order).transpose(1, 2)  # vertical
    x = _pad_shear_crop_x(x, a, pad_x, order)                                # horizontal
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1).to(images.dtype)


# ---------------------------------------------------------------------------
# One angle per image (or one for the batch): cropped gathers
# ---------------------------------------------------------------------------

def _shear_x(x: torch.Tensor, coef: torch.Tensor, nearest: bool) -> torch.Tensor:
    """One cropped x-shear of (N, H, W, C): row y moves by s = coef * (y - (H
    - 1) / 2), out[y, x] = (1 - f) in[y, x + l] + f in[y, x + l + 1] with l =
    floor(s), f = s - l, zero where the column lies outside [0, W). Under
    ``nearest`` the shift is rounded half to even and one tap is taken."""
    n, h, w, c = x.shape
    s = _row_shifts(coef, h, nearest)                       # (N or 1, H)
    lo = torch.floor(s)
    col = torch.arange(w, device=x.device) + lo.to(torch.int64)[..., None]  # (N or 1, H, W)

    def take(idx):
        inside = ((idx >= 0) & (idx < w)).expand(n, h, w)[..., None]
        idx = idx.clamp(0, w - 1).expand(n, h, w)[..., None].expand(n, h, w, c)
        return torch.where(inside, torch.gather(x, 2, idx),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    if nearest:
        return take(col)
    f = (s - lo)[..., None, None]
    return (1.0 - f) * take(col) + f * take(col + 1)


def rotate_batch_shear_per_sample(images: torch.Tensor, angle_deg: torch.Tensor,
                                  order: int = 1) -> torch.Tensor:
    """Rotate an NHWC batch CCW by ``angle_deg`` degrees, an (N,) angle (one
    per image) or a 0-dim one (the batch's), by three cropped shears
    evaluated as gathers. Works in the input's dtype; ``order=1`` lerps (a
    floating input), ``order=0`` takes the nearest tap (any dtype, masks
    included)."""
    a, b = shear_coefficients(angle_deg)
    nearest = order == 0
    x = _shear_x(images, a, nearest)
    x = _shear_x(x.transpose(1, 2), b, nearest).transpose(1, 2)
    return _shear_x(x, a, nearest)
