"""Host-side decode and resize (counterpart of ``load_image_rgb`` in
``tpu_unet/data/transforms.py``).

The host decodes and resizes to the target shape as uint8; normalization runs
on the device. Resizing uses PIL's BILINEAR filter, the JAX package's own path
under ``TPU_UNET_NATIVE_RESIZE=0``. (Its native resampler is not ported.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image


def load_image_rgb(path: str, size_hw: Tuple[int, int]) -> np.ndarray:
    """Decode an image to RGB and resize to (H, W); returns (H, W, 3) uint8."""
    with Image.open(path) as im:
        im = im.convert("RGB")
        h, w = size_hw
        if im.size == (w, h):  # PIL size is (W, H)
            return np.asarray(im, dtype=np.uint8)
        return np.asarray(im.resize((w, h), Image.BILINEAR), dtype=np.uint8)
