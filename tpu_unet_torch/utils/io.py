"""Image listing and JSON output (counterpart of parts of ``tpu_unet/utils/io.py``)."""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def _convert(obj):
    """numpy and torch scalars and arrays -> JSON-serializable Python values."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if hasattr(obj, "tolist") and hasattr(obj, "dtype"):  # numpy and torch arrays
        return obj.tolist()
    if isinstance(obj, dict):
        return {key: _convert(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_convert(item) for item in obj]
    return obj


def save_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(_convert(obj), f, indent=2)


def list_images(root: str):
    """All image files under ``root`` (recursive), sorted."""
    return sorted(p for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if p.lower().endswith(IMAGE_EXTENSIONS))


def list_calibration_images(root: str):
    """``list_images`` minus annotation rasters next to the images
    (KolektorSDD's ``X_label.bmp``, MVTec's ``X_mask.png``), which would skew
    int8 calibration."""
    return [p for p in list_images(root)
            if not re.search(r"_(label|mask)\.[^.]+$", p.lower())]
