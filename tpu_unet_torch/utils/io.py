"""Output directories, JSON artifacts and image listing (counterpart of
``tpu_unet/utils/io.py``), with the reference's layouts and schemas."""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict

import numpy as np

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def create_output_dirs(base_dir: str) -> Dict[str, str]:
    """checkpoints/ results/ visualizations/ logs/ under ``base_dir``."""
    created = {}
    for name in ("checkpoints", "results", "visualizations", "logs"):
        path = os.path.join(base_dir, name)
        os.makedirs(path, exist_ok=True)
        created[name] = path
    return created


def convert_numpy(obj):
    """numpy and torch scalars and arrays -> JSON-serializable Python values."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if hasattr(obj, "tolist") and hasattr(obj, "dtype"):  # numpy and torch arrays
        return obj.tolist()
    if isinstance(obj, dict):
        return {key: convert_numpy(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [convert_numpy(item) for item in obj]
    return obj


def save_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(convert_numpy(obj), f, indent=2)


def append_jsonl(record, path: str) -> None:
    """Append one JSON record as a line, opening and closing the file per call
    so that every completed epoch's entry survives a crash (the trainer's live
    ``history.jsonl``)."""
    with open(path, "a") as f:
        f.write(json.dumps(convert_numpy(record)) + "\n")


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
