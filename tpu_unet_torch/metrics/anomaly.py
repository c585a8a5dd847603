"""Anomaly scoring from reconstruction error (counterpart of
``tpu_unet/metrics/anomaly.py``). Tensors are NHWC, as in the JAX package.

- ``anomaly_score``: one scalar per image, the mean error over (H, W, C);
- ``anomaly_error_map``: the per-pixel (N, H, W) channel-mean error.

Methods 'mse' and 'l1'. 'ssim' needs ``ops/ssim.py``, not ported yet.
"""

from __future__ import annotations

import torch


def _per_pixel_error(reconstruction: torch.Tensor, original: torch.Tensor,
                     method: str = "mse") -> torch.Tensor:
    r = reconstruction.to(torch.float32)
    o = original.to(torch.float32)
    if method == "mse":
        return torch.mean((r - o) ** 2, dim=-1)
    if method == "l1":
        return torch.mean(torch.abs(r - o), dim=-1)
    if method == "ssim":
        raise NotImplementedError("the 'ssim' method needs ops/ssim.py, "
                                  "which is not ported yet")
    raise ValueError(f"Unknown method: {method!r}")


def anomaly_error_map(reconstruction: torch.Tensor, original: torch.Tensor,
                      method: str = "mse") -> torch.Tensor:
    """Per-pixel anomaly map (N, H, W): channel-mean reconstruction error."""
    return _per_pixel_error(reconstruction, original, method)


def anomaly_score(reconstruction: torch.Tensor, original: torch.Tensor,
                  method: str = "mse") -> torch.Tensor:
    """Scalar anomaly score per image (N,)."""
    return torch.mean(_per_pixel_error(reconstruction, original, method), dim=(1, 2))
