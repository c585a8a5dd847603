"""Gaussian-window SSIM over NHWC images (counterpart of ``tpu_unet/ops/ssim.py``).

The reference's SSIMLoss: an 11-tap Gaussian window (sigma 1.5), per-channel
window sums with window//2 zero padding, C1 = 0.01², C2 = 0.03².

The window is separable (outer(g, g)), so each windowed statistic is two
banded matmuls over (N*C, H, W) planes, ``A_H @ X @ A_W``, with A the
symmetric (n, n) band of the 1-D Gaussian: the JAX package's own
formulation, and a pair of plain matrix products on the GPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

C1, C2 = 0.01 ** 2, 0.03 ** 2


@functools.lru_cache(maxsize=8)
def _gaussian_band(n: int, window_size: int, sigma: float) -> np.ndarray:
    """(n, n) band A with A[i, j] = g[j - i + k//2]: ``A @ x`` convolves x's
    leading axis with the normalized 1-D Gaussian under zero padding."""
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    half = window_size // 2
    a = np.zeros((n, n), np.float32)
    for tap, off in enumerate(range(-half, half + 1)):
        if abs(off) >= n:  # the tap lands entirely in the zero pad
            continue
        a += np.diag(np.full(n - abs(off), g[tap], np.float32), k=off)
    return a


@functools.lru_cache(maxsize=8)
def _band_on(n: int, window_size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The band on ``device``, copied there once (a copy from host memory
    waits for the GPU to drain)."""
    return torch.from_numpy(_gaussian_band(n, window_size, sigma)).to(device)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """SSIM map as (N, C, H, W) from NHWC inputs, through separable banded matmuls."""
    n, h, w, c = img1.shape
    x = img1.to(torch.float32).permute(0, 3, 1, 2).reshape(n * c, h, w)
    y = img2.to(torch.float32).permute(0, 3, 1, 2).reshape(n * c, h, w)
    ah = _band_on(h, window_size, sigma, x.device)
    aw = _band_on(w, window_size, sigma, x.device)

    def blur(p):
        return torch.matmul(torch.matmul(ah, p), aw)

    mu1, mu2 = blur(x), blur(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(x * x) - mu1_sq
    sigma2_sq = blur(y * y) - mu2_sq
    sigma12 = blur(x * y) - mu1_mu2
    smap = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return smap.reshape(n, c, h, w)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """Structural similarity of two NHWC batches: a scalar
    (``size_average=True``) or the per-image (N,) means of the SSIM map."""
    smap = ssim_map(img1, img2, window_size, sigma)
    if size_average:
        return smap.mean()
    return smap.mean(dim=(1, 2, 3))


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              sigma: float = 1.5) -> torch.Tensor:
    """1 - SSIM, the reconstruction loss under ``recon_loss_type='ssim'``."""
    return 1.0 - ssim(img1, img2, window_size=window_size, sigma=sigma)
