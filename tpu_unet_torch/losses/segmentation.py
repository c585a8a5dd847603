"""Multi-class segmentation losses: weighted CE, Dice and focal (counterpart
of ``tpu_unet/losses/segmentation.py``).

The reference's semantics:
- cross entropy with class weights takes torch's weighted mean,
  ``sum(w[y_i] * ce_i) / sum(w[y_i])`` (KolektorSDD's 1:50:50 weights);
- Dice on softmax probabilities against one-hot targets, smooth 1e-8;
- focal is CE-based with alpha 1, gamma 2;
- the combined loss gates each term on its weight being > 0.

Logits are NHWC (N, H, W, C) and labels integer (N, H, W), the JAX
package's layout; every term runs in float32, whatever the logits' dtype.
Out-of-range labels: CE clips the label into [0, C - 1] before it reads the
logit (then masks ``ignore_index``), Dice one-hot-encodes it as a zero row.
A (N,) ``sample_weight`` of 0/1 keeps the padded rows of an eval batch out
of every term. Under a data-parallel ``group`` every ratio divides by the
global batch's denominator (``losses/reduction.py``), the class-weighted
CE's ``sum(w[y_i])`` included.

Under the 'space' axis (``space``, an exchanger of
``parallel/spatial.py``) each rank holds a block of every image's rows and
``group`` is the batch group (data x space). CE and focal need nothing
more: every rank holds as many pixels. Dice is the one per-image ratio: its
(N, C) intersection and union sums are added over the space ranks before
the ratio (:func:`~tpu_unet_torch.parallel.spatial.space_sum`), so every
space rank of an image holds its whole-image Dice. The sum's backward
all-reduces too: rank s's Dice term then carries the sum over the space
ranks r of d(loss_r)/d(its logits), and the train step's mean of the
ranks' gradients is the global loss's gradient, as for the other terms.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from tpu_unet_torch.losses.reduction import global_denominator, weighted_mean
from tpu_unet_torch.ops.augment import device_constant
from tpu_unet_torch.ops.seg_head import SMALL_C_MAX
from tpu_unet_torch.parallel.spatial import space_sum


def _row_weight(sample_weight: torch.Tensor) -> torch.Tensor:
    return sample_weight.to(torch.float32).reshape(-1, 1, 1)


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: Optional[int] = None):
    """Per-pixel cross entropy (N, H, W) and its validity mask (1 where counted)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels_safe = torch.clamp(labels, 0, logits.shape[-1] - 1).long()
    ce = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    if ignore_index is not None:
        valid = (labels != ignore_index).to(torch.float32)
    else:
        valid = torch.ones_like(ce)
    return ce * valid, valid


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[Sequence[float]] = None,
                       ignore_index: Optional[int] = None,
                       sample_weight: Optional[torch.Tensor] = None,
                       group=None) -> torch.Tensor:
    """Weighted softmax cross entropy with torch's F.cross_entropy mean."""
    ce, valid = _per_pixel_ce(logits, labels, ignore_index)
    if sample_weight is not None:
        sw = _row_weight(sample_weight)
        valid = valid * sw
        ce = ce * sw
    if class_weights is not None:
        w = device_constant(tuple(float(x) for x in class_weights), torch.float32,
                            logits.device)
        w_y = w[torch.clamp(labels, 0, len(class_weights) - 1).long()]
        return torch.sum(ce * w_y) / global_denominator(torch.sum(w_y * valid), group)
    return torch.sum(ce) / global_denominator(torch.sum(valid), group)


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot; an out-of-range label gives a zero row."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


def dice_loss(probs: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-8,
              sample_weight: Optional[torch.Tensor] = None, group=None,
              space=None) -> torch.Tensor:
    """Dice loss on softmax probabilities (N, H, W, C) against labels (N, H, W)."""
    probs = probs.to(torch.float32)
    one_hot = _one_hot(labels, probs.shape[-1])
    sums = space_sum(torch.stack([
        torch.sum(probs * one_hot, dim=(1, 2)),  # (N, C)
        torch.sum(probs, dim=(1, 2)) + torch.sum(one_hot, dim=(1, 2))]), space)
    intersection, union = sums[0], sums[1]
    dice = (2.0 * intersection + smooth) / (union + smooth)
    return 1.0 - weighted_mean(dice, sample_weight, group)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0,
               gamma: float = 2.0, ignore_index: Optional[int] = None,
               sample_weight: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Multi-class focal loss (CE-based): the mean over all pixels, zeros at
    ignored ones (the reference's reduction='none' then .mean())."""
    ce, _ = _per_pixel_ce(logits, labels, ignore_index)
    pt = torch.exp(-ce)
    return weighted_mean(alpha * (1.0 - pt) ** gamma * ce, sample_weight, group)


def _combined_unsliced(logits: torch.Tensor, labels: torch.Tensor, *,
                       ce_weight: float = 1.0, dice_weight: float = 1.0,
                       focal_weight: float = 0.0,
                       class_weights: Optional[Sequence[float]] = None,
                       ignore_index: Optional[int] = None,
                       sample_weight: Optional[torch.Tensor] = None, group=None,
                       space=None) -> Dict[str, torch.Tensor]:
    """The per-term losses composed on (N, H, W, C) tensors: the oracle of
    the sliced path and the path for C > SMALL_C_MAX."""
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    out: Dict[str, torch.Tensor] = {}
    if ce_weight > 0:
        ce = cross_entropy_loss(logits, labels, class_weights, ignore_index,
                                sample_weight=sample_weight, group=group)
        out["ce_loss"] = ce
        total = total + ce_weight * ce
    if dice_weight > 0:
        d = dice_loss(torch.softmax(logits.to(torch.float32), dim=-1), labels,
                      sample_weight=sample_weight, group=group, space=space)
        out["dice_loss"] = d
        total = total + dice_weight * d
    if focal_weight > 0:
        f = focal_loss(logits, labels, ignore_index=ignore_index,
                       sample_weight=sample_weight, group=group)
        out["focal_loss"] = f
        total = total + focal_weight * f
    out["total_loss"] = total
    return out


def _combined_sliced(logits: torch.Tensor, labels: torch.Tensor, *,
                     ce_weight: float, dice_weight: float, focal_weight: float,
                     class_weights: Optional[Sequence[float]],
                     ignore_index: Optional[int],
                     sample_weight: Optional[torch.Tensor], group=None, space=None
                     ) -> Dict[str, torch.Tensor]:
    """CE, Dice and focal from the C channel slices of the logits, each an
    (N, H, W) plane: the JAX package's small-C path, the same shifted
    log-sum-exp arithmetic as the unsliced one."""
    num_classes = logits.shape[-1]
    ls = [logits[..., c].to(torch.float32) for c in range(num_classes)]
    m = ls[0]
    for c in range(1, num_classes):
        m = torch.maximum(m, ls[c])
    shifted = [v - m for v in ls]
    es = [torch.exp(s) for s in shifted]
    se = es[0]
    for c in range(1, num_classes):
        se = se + es[c]

    # CE selects with the clipped label, Dice with one_hot's rule; the two
    # differ only on out-of-range labels.
    labels_safe = torch.clamp(labels, 0, num_classes - 1)
    ce_masks = [(labels_safe == c).to(torch.float32) for c in range(num_classes)]
    dice_masks = [(labels == c).to(torch.float32) for c in range(num_classes)]

    out: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=logits.device)

    ce_pp = valid = None
    if ce_weight > 0 or focal_weight > 0:
        shifted_y = ce_masks[0] * shifted[0]
        for c in range(1, num_classes):
            shifted_y = shifted_y + ce_masks[c] * shifted[c]
        ce_pp = torch.log(se) - shifted_y  # (N, H, W)
        if ignore_index is not None:
            valid = (labels != ignore_index).to(torch.float32)
        else:
            valid = torch.ones_like(ce_pp)
        ce_pp = ce_pp * valid

    if ce_weight > 0:
        ce_v, val = ce_pp, valid
        if sample_weight is not None:
            sw = _row_weight(sample_weight)
            val = val * sw
            ce_v = ce_v * sw
        if class_weights is not None:
            w = [float(x) for x in class_weights]
            w_y = w[0] * ce_masks[0]
            for c in range(1, num_classes):
                w_y = w_y + w[c] * ce_masks[c]
            ce = torch.sum(ce_v * w_y) / global_denominator(torch.sum(w_y * val), group)
        else:
            ce = torch.sum(ce_v) / global_denominator(torch.sum(val), group)
        out["ce_loss"] = ce
        total = total + ce_weight * ce

    if dice_weight > 0:
        smooth = 1e-8
        inters, unions = [], []
        for c in range(num_classes):
            p_c = es[c] / se
            inters.append(torch.sum(p_c * dice_masks[c], dim=(1, 2)))
            unions.append(torch.sum(p_c, dim=(1, 2)) + torch.sum(dice_masks[c], dim=(1, 2)))
        sums = space_sum(torch.stack([torch.stack(inters, -1), torch.stack(unions, -1)]),
                         space)
        dice = (2.0 * sums[0] + smooth) / (sums[1] + smooth)
        d = 1.0 - weighted_mean(dice, sample_weight, group)
        out["dice_loss"] = d
        total = total + dice_weight * d

    if focal_weight > 0:
        pt = torch.exp(-ce_pp)
        f = weighted_mean(1.0 * (1.0 - pt) ** 2.0 * ce_pp, sample_weight, group)
        out["focal_loss"] = f
        total = total + focal_weight * f

    out["total_loss"] = total
    return out


def combined_segmentation_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                               ce_weight: float = 1.0, dice_weight: float = 1.0,
                               focal_weight: float = 0.0,
                               class_weights: Optional[Sequence[float]] = None,
                               ignore_index: Optional[int] = None,
                               sample_weight: Optional[torch.Tensor] = None,
                               group=None, space=None) -> Dict[str, torch.Tensor]:
    """Weighted CE + Dice + focal, each term gated on its weight being > 0;
    returns the terms and ``total_loss``, float32 0-dim tensors. ``space``:
    the exchanger of a rank that holds a block of the images' rows (module
    docstring).

    2 <= C <= SMALL_C_MAX on 4-d logits (with class weights, if any, one
    per class) takes the sliced path, as the JAX package does; anything else
    the unsliced composition.
    """
    kw = dict(ce_weight=ce_weight, dice_weight=dice_weight, focal_weight=focal_weight,
              class_weights=class_weights, ignore_index=ignore_index,
              sample_weight=sample_weight, group=group, space=space)
    num_classes = logits.shape[-1]
    if (2 <= num_classes <= SMALL_C_MAX and logits.dim() == 4
            and (class_weights is None or len(class_weights) == num_classes)):
        return _combined_sliced(logits, labels, **kw)
    return _combined_unsliced(logits, labels, **kw)
