"""Sample-weighted reductions for loss functions (counterpart of
``tpu_unet/losses/reduction.py``).

A binary ``sample_weight`` of shape (N,) excludes the zero-padded rows of a
fixed-shape eval batch: every reduction then equals the same loss computed
over the valid rows only.

Under a data-parallel process group (``group``) each rank holds its rows of
the global batch. A loss that is a ratio of global sums is not the mean of
the ranks' ratios, and neither is its gradient, so a rank's loss is its own
numerator over the group's denominator times W
(:func:`global_denominator`): the mean of the ranks' losses is the global
loss, and the mean of their gradients (what the train steps all-reduce) is
its gradient. A plain mean needs no exchange, since every rank holds as
many rows. Under tensor parallelism ``group`` is the 'data' group: the
model ranks of a data index hold the same rows, so their denominators are
not added again. Under the 'space' axis ``group`` is the batch group
(data x space): each rank holds a block of every image's rows, as many
pixels as the others, so the same holds pixel for pixel; a per-image
weight counted by each space rank of the image is added n_space times and
divided by n_space more ranks, which cancels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def global_denominator(den: torch.Tensor, group=None) -> torch.Tensor:
    """``max(den, 1e-12)`` of the global batch over W: ``den`` summed over
    the ranks of ``group`` (no gradient flows through it: no denominator
    depends on the parameters), clipped as the JAX package clips, divided by
    the world size. ``max(den, 1e-12)`` without a group."""
    if group is None:
        return torch.clamp(den, min=1e-12)
    total = den.detach().clone()
    dist.all_reduce(total, group=group)
    return torch.clamp(total, min=1e-12) / dist.get_world_size(group)


def weighted_mean(x: torch.Tensor, sample_weight: Optional[torch.Tensor] = None,
                  group=None) -> torch.Tensor:
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
    return (per_sample * w).sum() / global_denominator(w.sum(), group)
