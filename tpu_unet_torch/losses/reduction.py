"""Sample-weighted reductions for loss functions (counterpart of
``tpu_unet/losses/reduction.py``).

A binary ``sample_weight`` of shape (N,) excludes the zero-padded rows of a
fixed-shape eval batch: every reduction then equals the same loss computed
over the valid rows only.
"""

from __future__ import annotations

from typing import Optional

import torch


def weighted_mean(x: torch.Tensor,
                  sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of per-sample values x (N, ...) under (N,) sample weights, in float32.

    With ``sample_weight=None`` this is ``x.mean()``. With binary weights it
    equals ``x[valid].mean()``: each sample contributes its own mean, weighted,
    normalized by the weight sum.
    """
    x = x.to(torch.float32)
    if sample_weight is None:
        return x.mean()
    w = sample_weight.to(torch.float32)
    per_sample = x.mean(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else x
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1e-12)
