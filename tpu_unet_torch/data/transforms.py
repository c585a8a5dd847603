"""Host-side decode and resize (counterpart of ``tpu_unet/data/transforms.py``).

The host decodes and resizes to the target shape as uint8; normalization and
augmentation run on the device. Images resize with PIL's BILINEAR filter, the
JAX package's own path under ``TPU_UNET_NATIVE_RESIZE=0``. (Its native
resampler is not ported.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image


def load_image_rgb(path, size_hw: Tuple[int, int]) -> np.ndarray:
    """Decode an image (a path or a binary file object) to RGB and resize to
    (H, W); returns (H, W, 3) uint8."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        h, w = size_hw
        if im.size == (w, h):  # PIL size is (W, H)
            return np.asarray(im, dtype=np.uint8)
        return np.asarray(im.resize((w, h), Image.BILINEAR), dtype=np.uint8)


def load_mask(path, size_hw: Tuple[int, int], binarize: bool = False,
              method: str = "nearest") -> np.ndarray:
    """Decode a grayscale mask (a path or a binary file object) and resize to
    (H, W); returns (H, W) uint8.

    ``binarize=True`` maps any nonzero value to 1 (MVTec ground-truth masks).
    ``method='nearest'`` binarizes, then nearest-resizes: no invented values.
    ``method='bilinear'`` is the reference's raster (binarize to {0, 1}, then
    BILINEAR, whose uint8 rounding thresholds the interpolated edge at 0.5);
    it only means something with ``binarize=True``.
    """
    with Image.open(path) as im:
        im = im.convert("L")
        h, w = size_hw
        if method == "bilinear" and binarize:
            arr = (np.asarray(im, dtype=np.uint8) > 0).astype(np.uint8)
            im = Image.fromarray(arr, mode="L")
            if im.size != (w, h):
                im = im.resize((w, h), Image.BILINEAR)
            return np.asarray(im, dtype=np.uint8)
        if im.size != (w, h):
            im = im.resize((w, h), Image.NEAREST)
        arr = np.asarray(im, dtype=np.uint8)
    if binarize:
        arr = (arr > 0).astype(np.uint8)
    return arr


def resize_mask_array(mask: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-resize a (H, W) uint8 label map already in memory."""
    h, w = size_hw
    if mask.shape == (h, w):
        return mask
    im = Image.fromarray(mask, mode="L")
    return np.asarray(im.resize((w, h), Image.NEAREST), dtype=np.uint8)
