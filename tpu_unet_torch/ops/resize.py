"""Bilinear resize with align_corners=True, as matmuls (counterpart of
``tpu_unet/ops/resize.py``), and the half-pixel upsample by an integer
factor that SegFormer's head takes (:func:`upsample_bilinear_half_pixel`).

The reference's bilinear decoder upsamples with ``nn.Upsample(scale_factor=2,
mode='bilinear', align_corners=True)``. The JAX package computes each 1-D
interpolation as one matmul by an (out, in) matrix holding the two lerp
weights of each output row, built in float64 and cast to the tensor's dtype,
H first, then W. The port keeps that arithmetic: in bf16 the weights are
bf16-rounded (15/31, for instance) and the two products accumulate in
float32, which ``F.interpolate`` would not reproduce.

Each matrix is built once per (in, out, dtype, device) and kept: a
host-to-device copy per call would wait for the stream to drain.
Tensors are NCHW; :func:`interp_axis` resizes any one axis,
:func:`interp_rows` and :func:`upsample2x_rows` the rows, which under a
'space' scope are this rank's block of a level's rows
(``parallel/spatial.py::resize_rows``, ``upsample_rows``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_MATRICES: Dict[Tuple, torch.Tensor] = {}


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) align-corners lerp weights, float64; at most two
    nonzeros per row."""
    m = np.zeros((out_size, in_size), np.float64)
    if out_size == 1 or in_size == 1:
        m[:, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    coords = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = coords - lo
    rows = np.arange(out_size)
    m[rows, lo] += 1.0 - w
    m[rows, hi] += w
    return m


def interp_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """The kept (out_size, in_size) matrix: float64 -> float32 -> ``dtype``,
    as the JAX package casts it."""
    key = (in_size, out_size, dtype, torch.device(device))
    m = _MATRICES.get(key)
    if m is None:
        m = _MATRICES[key] = kept_constant(_interp_matrix(in_size, out_size), dtype, device)
    return m


def kept_constant(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """``a`` (float64) -> float32 -> ``dtype`` on ``device``, made outside
    inference mode: a matrix first made while serving is kept and later
    read by a train step's autograd, which refuses inference tensors."""
    with torch.inference_mode(False):
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)


def interp_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """Resize axis ``dim`` of ``x`` to ``out_size``; ``x`` itself when the
    size is unchanged (the matrix would be the identity)."""
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    m = interp_matrix(in_size, out_size, x.dtype, x.device)
    return torch.movedim(torch.movedim(x, dim, -1) @ m.t(), -1, dim)


def interp_rows(x: torch.Tensor, out_size: int, dim: int, level: int = 0) -> torch.Tensor:
    """Resize the rows (axis ``dim``) of ``x`` to ``out_size``. Under a
    'space' scope ``x`` holds this rank's rows of ``level + 1``, the image's
    rows resize to ``level``'s height and the result is the rank's rows of
    ``level`` (``out_size`` of them)."""
    from tpu_unet_torch.parallel import spatial

    if spatial.current() is None:
        return interp_axis(x, out_size, dim)
    y = spatial.resize_rows(x, level, dim)
    if y.shape[dim] != out_size:
        raise ValueError(f"a resize to {out_size} rows of which this rank holds "
                         f"{y.shape[dim]} at level {level}")
    return y


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int,
                                  level: int = 0) -> torch.Tensor:
    """Resize an NCHW tensor to (out_h, out_w), align_corners=True bilinear
    (under a 'space' scope, from the rank's rows of ``level + 1`` to its
    ``out_h`` rows of ``level``)."""
    return interp_axis(interp_rows(x, out_h, 2, level), out_w, 3)


def upsample2x_rows(x: torch.Tensor, dim: int, level: int = 0) -> torch.Tensor:
    """The 2x upsample of the rows (axis ``dim``); under a 'space' scope
    ``x`` holds this rank's rows of ``level + 1`` and the result is its rows
    of ``level``, the upsampled image zero-padded to the level's height as
    ``models/blocks.py::Up`` pads it (``parallel/spatial.py::upsample_rows``)."""
    from tpu_unet_torch.parallel import spatial

    if spatial.current() is None:
        return interp_axis(x, 2 * x.shape[dim], dim)
    return spatial.upsample_rows(x, level, dim)


def upsample2x_bilinear_align_corners(x: torch.Tensor, level: int = 0) -> torch.Tensor:
    """2x upsampling of an NCHW tensor, torch's ``Upsample(scale_factor=2,
    mode='bilinear', align_corners=True)`` (its rows as
    :func:`upsample2x_rows` gives them)."""
    return interp_axis(upsample2x_rows(x, 2, level), 2 * x.shape[3], 3)


def _half_pixel_matrix(in_size: int, factor: int) -> np.ndarray:
    """(in_size x factor, in_size) half-pixel lerp weights, float64: output
    row ``i`` reads the input at ``(i + 0.5) / factor - 0.5``, below 0 read at
    0, its upper neighbour clamped to the last row (PyTorch's
    ``align_corners=False``); at most two nonzeros a row."""
    out = in_size * factor
    m = np.zeros((out, in_size), np.float64)
    src = np.maximum((np.arange(out, dtype=np.float64) + 0.5) / factor - 0.5, 0.0)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = src - lo
    rows = np.arange(out)
    m[rows, lo] += 1.0 - w
    m[rows, hi] += w
    return m


def upsample_bilinear_half_pixel(x: torch.Tensor, factor: int) -> torch.Tensor:
    """An NCHW tensor upsampled by the whole ``factor`` on both axes,
    ``align_corners=False`` (half-pixel centres), as ``F.interpolate(mode=
    'bilinear', align_corners=False)`` computes it, to rounding: output pixel
    ``i`` reads the input at ``(i + 0.5) / factor - 0.5``. Each axis is one
    product with a kept (out, in) matrix (:func:`_half_pixel_matrix`; for a
    factor of 2, 4 or 8 every weight is a multiple of ``1 / (2 factor)``,
    exact in bf16), H first, in the tensor's dtype with the products' float32
    sums; so its backward sums in float32 too, where ``F.interpolate``'s adds
    each of up to ``(2 factor)^2`` contributions into a bf16 gradient. A
    channels_last input is contracted in its own memory order and gives a
    channels_last output."""
    factor = int(factor)
    if factor < 1:
        raise ValueError(f"the half-pixel upsample takes a whole factor of 1 or more, got "
                         f"{factor}")
    if factor == 1:
        return x
    n, c, h, w = x.shape
    key = ("half_pixel", h, factor, x.dtype, x.device)
    mh = _MATRICES.get(key)
    if mh is None:
        mh = _MATRICES[key] = kept_constant(_half_pixel_matrix(h, factor), x.dtype, x.device)
    key = ("half_pixel", w, factor, x.dtype, x.device)
    mw = _MATRICES.get(key)
    if mw is None:
        mw = _MATRICES[key] = kept_constant(_half_pixel_matrix(w, factor), x.dtype, x.device)
    if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous():
        # memory (N, H, W, C): rows, then columns, each a contiguous product
        y = torch.matmul(mh, x.permute(0, 2, 3, 1).reshape(n, h, w * c))
        y = torch.matmul(mw, y.view(n * h * factor, w, c))
        return y.view(n, h * factor, w * factor, c).permute(0, 3, 1, 2)
    y = torch.matmul(mh, x.reshape(n * c, h, w))
    return torch.matmul(y, mw.t()).view(n, c, h * factor, w * factor)
