"""Channel-sliced prediction heads for small-C segmentation logits
(counterpart of ``tpu_unet/ops/seg_head.py``).

The seg models emit logits with C = 3 or 4 classes. For small C the argmax
and the softmax confidence are computed from C channel slices, each an
(N, H, W) plane, with the JAX package's semantics:

- first-max tie-breaking: a later equal value never displaces the incumbent;
- NaN wins: the first NaN channel is the argmax (``jnp.argmax``'s rule).
  ``torch.argmax`` promises neither, so it is not used where JAX slices;
- the confidence ``1 / sum_c exp(l_c - lmax)`` equals the largest softmax
  probability, as JAX computes it.

``SMALL_C_MAX`` is the cutoff shared by the sliced heads, the sliced loss
(``losses/segmentation.py``) and the sliced confusion matrix
(``metrics/confusion.py``). Logits are NHWC, as in the JAX package: the
class axis is the last.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

SMALL_C_MAX = 8


def _argmax_and_max(slices: List[torch.Tensor], dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmax, max) over a list of equal-shape planes by a strict-``>``
    scan that lets the first NaN win; one scan serves both heads."""
    best = slices[0]
    am = torch.zeros(best.shape, dtype=dtype, device=best.device)
    for i in range(1, len(slices)):
        l_i = slices[i]
        take = (l_i > best) | (torch.isnan(l_i) & ~torch.isnan(best))
        am = torch.where(take, torch.full((), i, dtype=dtype, device=best.device), am)
        best = torch.where(take, l_i, best)
    return am, best


def _argmax_first_nan(logits: torch.Tensor, dtype) -> torch.Tensor:
    """argmax over the last axis with first-max ties and the first NaN
    winning, for any C (the path above SMALL_C_MAX)."""
    c = logits.shape[-1]
    idx = torch.arange(c, device=logits.device)
    nan = torch.isnan(logits)
    mx = logits.masked_fill(nan, float("-inf")).amax(dim=-1, keepdim=True)
    hit = torch.where(nan.any(dim=-1, keepdim=True), nan, logits == mx)
    # the smallest index that is a hit
    return torch.where(hit, idx, c).amin(dim=-1).to(dtype)


def sliced_argmax(logits: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """argmax over the last (class) axis of (..., C) logits, with JAX's
    first-max and NaN rules. int64 by default: torch's gathers take it."""
    c = logits.shape[-1]
    if c > SMALL_C_MAX:
        return _argmax_first_nan(logits, dtype)
    am, _ = _argmax_and_max([logits[..., i] for i in range(c)], dtype)
    return am


def sliced_pred_confidence(logits: torch.Tensor, pred_dtype=torch.uint8
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(preds, per-pixel largest softmax probability) from (..., C) logits,
    in float32."""
    c = logits.shape[-1]
    if c > SMALL_C_MAX:
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return _argmax_first_nan(logits, pred_dtype), probs.amax(dim=-1)
    ls = [logits[..., i].to(torch.float32) for i in range(c)]
    am, best = _argmax_and_max(ls, pred_dtype)
    se = torch.exp(ls[0] - best)
    for i in range(1, c):
        se = se + torch.exp(ls[i] - best)
    return am, torch.reciprocal(se)
