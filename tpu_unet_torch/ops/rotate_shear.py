"""Rotation as three shears (counterpart of ``tpu_unet/ops/rotate_shear.py``).

    R(theta) = Shear_x(-tan(theta/2)) . Shear_y(sin(theta)) . Shear_x(-tan(theta/2))

A 1-D subpixel shear of row y is a banded matrix product, out[y] = M_y @
in[y], where M_y holds two diagonals (1 - f, f) at offset floor(shift_y).

- :func:`rotate_batch_shear`: ONE angle for the batch; the three banded
  operator stacks are (H, W', W') and each shear is a batched matmul over
  (N*C, H, W) planes (the augmentation default, 'per_batch_shear').
- :func:`rotate_batch_shear_per_sample`: one angle per image; each shear is a
  K-tap contraction over statically shifted slices of the padded rows, with
  the tap band narrowed per block of rows and the patch stack capped at
  256 MB ('per_sample_shear').

Zero fill at the borders. ``order=1`` lerps each shear; ``order=0`` rounds
each shift to an integer (half to even), so mask values are only permuted.
"""

from __future__ import annotations

import math

import torch


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


def rotate_batch_shear(images: torch.Tensor, angle_deg: torch.Tensor,
                       max_degrees: float, order: int = 1) -> torch.Tensor:
    """Rotate an NHWC batch CCW by ONE shared angle (a 0-dim tensor, degrees)
    through three shear matmuls. ``max_degrees`` sizes the zero padding."""
    theta = torch.deg2rad(angle_deg.to(torch.float32))
    return _rotate_3shear_planes(images, -torch.tan(theta / 2.0), torch.sin(theta),
                                 max_degrees, order, _pad_shear_crop_x)


def _rotate_3shear_planes(images: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                          max_degrees: float, order: int, shear_rows) -> torch.Tensor:
    """Pad sizing and the plane/transpose sandwich shared by both modes.

    ``shear_rows(x, shear, pad, order)`` shears the rows of (B, H, W) planes;
    ``a``/``b`` are the x-/y-shear coefficients (0-dim, or per plane (N*C,)).
    """
    n, h, w, c = images.shape
    tmax = math.tan(math.radians(max_degrees) / 2.0)
    smax = math.sin(math.radians(max_degrees))
    pad_x = int(math.ceil(tmax * (h / 2.0))) + 2
    pad_y = int(math.ceil(smax * (w / 2.0 + pad_x))) + 2

    x = images.to(torch.float32).permute(0, 3, 1, 2).reshape(n * c, h, w)
    x = shear_rows(x, a, pad_x, order)                       # horizontal
    x = shear_rows(x.transpose(1, 2), b, pad_y, order).transpose(1, 2)  # vertical
    x = shear_rows(x, a, pad_x, order)                       # horizontal
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1).to(images.dtype)


def _row_shifts(shear: torch.Tensor, h: int, order: int) -> torch.Tensor:
    cy = (h - 1) / 2.0
    rows = torch.arange(h, dtype=torch.float32, device=shear.device) - cy
    shifts = shear[..., None] * rows
    if order == 0:
        shifts = torch.round(shifts)  # integer shifts: a pure permutation
    return shifts


def _pad_shear_crop_x(x: torch.Tensor, shear: torch.Tensor, pad: int,
                      order: int = 1) -> torch.Tensor:
    w = x.shape[2]
    xp = torch.nn.functional.pad(x, (pad, pad))
    m = _shear_operator(_row_shifts(shear, x.shape[1], order), w + 2 * pad)
    out = torch.einsum("hoi,bhi->bho", m, xp)
    return out[:, :, pad:pad + w]


# ---------------------------------------------------------------------------
# Per-sample angles
# ---------------------------------------------------------------------------
#
# With one angle per image the shared (H, W', W') operator would become
# (N, H, W', W'). Each output row still mixes only two adjacent taps inside a
# static band of K = 2*pad + 1 shifts, so a shear is a K-tap contraction over
# shifted slices of the padded rows: out[n,h,o] = sum_k wgt[n,h,k] *
# xp[n,h,o+k], with wgt 2-sparse per (n, h).

_PATCH_CHUNK_BYTES = 256 * 1024 * 1024  # cap on a materialized patch stack
_SHEAR_ROW_BLOCK = 32  # least rows per static tap band


def rotate_batch_shear_per_sample(images: torch.Tensor, angles_deg: torch.Tensor,
                                  max_degrees: float, order: int = 1) -> torch.Tensor:
    """Rotate an NHWC batch CCW with one angle per image ((N,) degrees), by the
    same three shears as :func:`rotate_batch_shear`."""
    c = images.shape[3]
    theta = torch.deg2rad(angles_deg.to(torch.float32))
    # Per-image coefficients repeated per channel plane, in the (N, C) -> N*C order.
    a = torch.repeat_interleave(-torch.tan(theta / 2.0), c)
    b = torch.repeat_interleave(torch.sin(theta), c)
    return _rotate_3shear_planes(images, a, b, max_degrees, order,
                                 _shear_rows_per_sample)


def _shear_rows_per_sample(x: torch.Tensor, shear: torch.Tensor, pad: int,
                           order: int = 1) -> torch.Tensor:
    """Shear the rows of (B, H, W) planes by per-(plane, row) subpixel shifts.

    |shift(row)| <= max|shear| * |row - cy| is a static bound per row, so the
    rows of a block near the centre can only reach a narrow band of taps:
    each block of rows contracts over its own static band, which skips taps
    whose weight is 0 for every angle within ``max_degrees``.
    """
    bsz, h, w = x.shape
    xp = torch.nn.functional.pad(x, (pad, pad))
    cy = (h - 1) / 2.0
    shifts = _row_shifts(shear, h, order)                   # (B, H)
    lo = torch.floor(shifts).to(torch.int32)
    frac = (shifts - lo).to(torch.float32)[:, :, None]       # (B, H, 1)

    k_total = 2 * pad + 1  # |shifts| <= pad - 2, so lo+pad and lo+pad+1 fit
    kidx = torch.arange(k_total, dtype=torch.int32, device=x.device)[None, None, :]
    kk = lo[:, :, None] + pad
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    wgt = torch.where(kidx == kk, 1.0 - frac,
                      torch.where(kidx == kk + 1, frac, zero))  # (B, H, K)

    # The pads are ceil(max|shear| * extent) + 2 with extent >= cy, so this
    # recovered bound dominates the true max|shear| in every pass.
    shear_max = (pad - 2) / max(cy, 1.0)
    blk = max(_SHEAR_ROW_BLOCK, ((h + 7) // 8 + 7) // 8 * 8)  # at most ~8 blocks
    out_blocks = []
    for r0 in range(0, h, blk):
        r1 = min(r0 + blk, h)
        bound = shear_max * max(abs(r0 - cy), abs(r1 - 1 - cy))
        # floor(+-bound) + 1 covers the lerp pair and order-0 rounding.
        k_lo = max(pad - (int(math.floor(bound)) + 1), 0)
        k_hi = min(pad + int(math.floor(bound)) + 1, k_total - 1)
        out_blocks.append(_banded_contract(xp[:, r0:r1], wgt[:, r0:r1], k_lo, k_hi, w))
    return torch.cat(out_blocks, dim=1)


def _banded_contract(xp: torch.Tensor, wgt: torch.Tensor, k_lo: int, k_hi: int,
                     w: int) -> torch.Tensor:
    """sum_k wgt[b,h,k] * xp[b,h,k:k+w] over taps k in [k_lo, k_hi], in chunks
    of taps so that the materialized patch stack stays under 256 MB."""
    bsz, rows = xp.shape[0], xp.shape[1]
    chunk = max(1, min(k_hi - k_lo + 1, _PATCH_CHUNK_BYTES // (bsz * rows * w * 4)))
    out = torch.zeros((bsz, rows, w), dtype=torch.float32, device=xp.device)
    for k0 in range(k_lo, k_hi + 1, chunk):
        ks = range(k0, min(k0 + chunk, k_hi + 1))
        patches = torch.stack([xp[:, :, k:k + w] for k in ks], dim=2)  # (B, r, k, W)
        out = out + torch.einsum("bhk,bhkw->bhw", wgt[:, :, k0:k0 + len(ks)], patches)
    return out
