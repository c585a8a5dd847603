"""Bilinear resize with align_corners=True, as matmuls (counterpart of
``tpu_unet/ops/resize.py``).

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
:func:`interp_rows` the rows, which under a 'space' scope are this rank's
block of the image's (``parallel/spatial.py::resize_rows``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_MATRICES: Dict[Tuple[int, int, torch.dtype, torch.device], torch.Tensor] = {}


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


def interp_rows(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """Resize the rows (axis ``dim``) of ``x`` to ``out_size``; under a
    'space' scope ``x`` holds this rank's rows and ``out_size`` is its
    share of the output's."""
    from tpu_unet_torch.parallel import spatial

    ex = spatial.current()
    if ex is None:
        return interp_axis(x, out_size, dim)
    return spatial.resize_rows(x, out_size, dim, ex)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize an NCHW tensor to (out_h, out_w), align_corners=True bilinear
    (under a 'space' scope, ``out_h`` is this rank's rows)."""
    return interp_axis(interp_rows(x, out_h, 2), out_w, 3)


def upsample2x_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x upsampling of an NCHW tensor, torch's ``Upsample(scale_factor=2,
    mode='bilinear', align_corners=True)``."""
    return resize_bilinear_align_corners(x, 2 * x.shape[2], 2 * x.shape[3])
