"""The configurations' losses in plain float32 PyTorch, on NHWC tensors.

- anomaly: ``recon_weight`` x MSE(reconstruction, normalised image) +
  ``seg_weight`` x binary focal loss of the anomaly map against the mask,
  mean(alpha (1 - pt)^gamma BCE), pt = exp(-BCE), the probability clipped to
  [1e-7, 1 - 1e-7] (the reference repository's CombinedLoss);
- segmentation: ``ce_weight`` x cross entropy with class weights, taken as
  sum(w[y] ce) / sum(w[y]) (torch's weighted mean), + ``dice_weight`` x
  (1 - the mean over images and classes of the soft Dice, smooth 1e-8).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

_CLIP = 1e-7
_SMOOTH = 1e-8


def anomaly(recon: torch.Tensor, amap: torch.Tensor, image: torch.Tensor,
            mask: torch.Tensor, cfg: Dict) -> torch.Tensor:
    mse = torch.mean((recon - image) ** 2)
    p = torch.clamp(amap, _CLIP, 1.0 - _CLIP)
    bce = -(mask * torch.log(p) + (1.0 - mask) * torch.log(1.0 - p))
    focal = torch.mean(cfg["focal_alpha"] * (1.0 - torch.exp(-bce)) ** cfg["focal_gamma"] * bce)
    return cfg["recon_weight"] * mse + cfg["seg_weight"] * focal


def segmentation(logits: torch.Tensor, labels: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """``logits`` (N, H, W, C), ``labels`` (N, H, W) int64."""
    c = logits.shape[-1]
    total = torch.zeros((), device=logits.device)
    if cfg.get("ce_weight", 1.0) > 0:
        ce = -torch.gather(F.log_softmax(logits, -1), -1, labels[..., None])[..., 0]
        weights = cfg.get("class_weights")
        w = (torch.tensor(weights, dtype=torch.float32, device=logits.device)[labels]
             if weights else torch.ones_like(ce))
        total = total + cfg.get("ce_weight", 1.0) * torch.sum(ce * w) / torch.sum(w)
    if cfg.get("dice_weight", 1.0) > 0:
        probs = torch.softmax(logits, -1)
        onehot = F.one_hot(labels, c).to(torch.float32)
        inter = torch.sum(probs * onehot, dim=(1, 2))
        union = torch.sum(probs, dim=(1, 2)) + torch.sum(onehot, dim=(1, 2))
        dice = (2.0 * inter + _SMOOTH) / (union + _SMOOTH)
        total = total + cfg.get("dice_weight", 1.0) * (1.0 - dice.mean())
    return total
