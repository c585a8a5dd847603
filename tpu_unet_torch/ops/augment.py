"""Device input transform for evaluation and serving (counterpart of the eval
half of ``tpu_unet/ops/augment.py``).

Images are NHWC, as in the JAX package: the host ships uint8 and the device
normalizes. ``eval_transform`` runs kernel K1 (``ops/kernels/preprocess.py``)
on CUDA tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]."""
    # A tensor divisor, not a Python number: on CUDA PyTorch multiplies by the
    # reciprocal of a scalar divisor, which differs from x / 255 in the last bit.
    return images_u8.to(torch.float32) / torch.full((1,), 255.0,
                                                    device=images_u8.device)


def normalize(images: torch.Tensor,
              mean: Tuple[float, ...] = IMAGENET_MEAN,
              std: Tuple[float, ...] = IMAGENET_STD) -> torch.Tensor:
    """(images - mean[c]) / std[c] over the last (channel) axis."""
    mean_t = torch.tensor(mean, dtype=images.dtype, device=images.device)
    std_t = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean_t) / std_t


def eval_transform(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NHWC (no augmentation), through K1."""
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8
    return normalize_u8(images_u8)
