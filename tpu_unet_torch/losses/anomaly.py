"""Anomaly-detection losses (counterpart of ``tpu_unet/losses/anomaly.py``):
reconstruction plus binary focal segmentation.

total = w_r * recon + w_s * focal, focal = mean(alpha * (1 - pt)^gamma * BCE),
pt = exp(-BCE), as the reference's CombinedLoss. Inputs are NHWC
probabilities (the models apply the sigmoid); each function returns float32
scalars.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tpu_unet_torch.losses.reduction import weighted_mean
from tpu_unet_torch.ops.ssim import ssim
from tpu_unet_torch.ops.ssim import ssim_loss  # noqa: F401  (re-export, public API)

_EPS = 1e-7  # representable next to 1.0 in float32 (1 - 1e-12 rounds to 1.0)


def binary_focal_loss(probs: torch.Tensor, targets: torch.Tensor,
                      alpha: float = 0.25, gamma: float = 2.0,
                      sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Focal loss on probabilities, the probability clipped to [1e-7, 1 - 1e-7].

    The clip, not ``F.binary_cross_entropy``'s clamp of the log at -100, is
    the JAX package's semantics: a saturated probability (p == 1.0) gives a
    finite loss of about 16.1 per pixel and a zero gradient.
    """
    p = torch.clamp(probs.to(torch.float32), _EPS, 1.0 - _EPS)
    t = targets.to(torch.float32)
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    pt = torch.exp(-bce)
    return weighted_mean(alpha * (1.0 - pt) ** gamma * bce, sample_weight)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    return weighted_mean((pred - target) ** 2, sample_weight)


def combined_anomaly_loss(
    reconstruction: torch.Tensor,
    anomaly_map: torch.Tensor,
    image: torch.Tensor,
    mask: torch.Tensor,
    *,
    recon_weight: float = 1.0,
    seg_weight: float = 1.0,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    recon_loss_type: str = "mse",
    sample_weight: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Combined anomaly loss; every input NHWC (mask (N, H, W, 1) binary).

    The reconstruction term compares the sigmoid reconstruction with
    ``image`` as given, the *normalized* image in the train step (the
    reference does the same). ``recon_loss_type``: 'mse' or 'ssim'.
    ``sample_weight``: optional (N,) weights; binary weights exclude padded
    rows. Returns ``{'total_loss', 'recon_loss', 'seg_loss'}``.
    """
    if recon_loss_type == "mse":
        recon_loss = mse_loss(reconstruction, image, sample_weight=sample_weight)
    elif recon_loss_type == "ssim":
        per_image = 1.0 - ssim(reconstruction.to(torch.float32),
                               image.to(torch.float32), size_average=False)
        recon_loss = weighted_mean(per_image, sample_weight)
    else:
        raise ValueError(f"Unknown recon_loss_type: {recon_loss_type!r}")

    seg_loss = binary_focal_loss(anomaly_map, mask, alpha=focal_alpha,
                                 gamma=focal_gamma, sample_weight=sample_weight)
    total = recon_weight * recon_loss + seg_weight * seg_loss
    return {"total_loss": total, "recon_loss": recon_loss, "seg_loss": seg_loss}
