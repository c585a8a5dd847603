"""Rounding to float8, the precision below bfloat16 that the controls of the
bfloat16 cells compute in: a tensor is scaled by its absolute maximum to
the format's largest value and rounded to e4m3 (forward), and the gradient
that flows back through it to e5m2, each with a scale per tensor, as fp8
training recipes do."""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / fmax
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, _E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 (its gradient to e5m2 on the way back)."""
    return _Fp8.apply(x)
