"""Gear multi-class segmentation dataset: LabelMe-style polygon labels with
priority-based overlap resolution (counterpart of ``tpu_unet/data/gear.py``,
the same index order, masks and samples).

- images under ``images/<split>/``, labels ``labels/<split>/<stem>.txt``;
- one label line is ``class_id x1 y1 x2 y2 ...`` in normalized coordinates;
- each class's polygons are filled with PIL, then composed in priority order
  scrape < pitting < spalling, a higher class overwriting a lower one;
- final ids: background 0, pitting 1, spalling 2, scrape 3; masks are uint8.

The resolved mask at the training resolution is memoized per image, and
decoded samples are kept in a RAM cache (``data/cache.py``). The JAX
package's packed on-disk store is not ported: ``disk_cache_dir`` takes None
only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw

from tpu_unet_torch.data.cache import SampleCache, cached_load
from tpu_unet_torch.data.transforms import load_image_rgb, resize_mask_array

# Raster priority, lowest -> highest (scrape, pitting, spalling), original class ids.
CLASS_PRIORITY_ORDER = [2, 0, 1]
CLASS_ID_TO_FINAL_ID = {0: 1, 1: 2, 2: 3}  # pitting->1, spalling->2, scrape->3
CLASS_NAMES_MAP = {0: "pitting", 1: "spalling", 2: "scrape"}
CLASS_ORDER = ["pitting", "spalling", "scrape"]


def parse_label_file(label_path: str) -> List[Tuple[int, List[Tuple[float, float]]]]:
    """Parse a LabelMe-style txt: [(class_id, [(x, y) normalized]), ...]."""
    polygons = []
    with open(label_path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 5:
                continue
            try:
                class_id = int(parts[0])
                coords = [float(x) for x in parts[1:]]
            except ValueError:
                continue
            points = [(coords[i], coords[i + 1]) for i in range(0, len(coords) - 1, 2)]
            polygons.append((class_id, points))
    return polygons


def rasterize_labelme(label_path: str, img_width: int, img_height: int,
                      stats: Optional[Dict] = None) -> np.ndarray:
    """Rasterize polygons to an (H, W) uint8 label map, overlaps resolved by
    priority; ``stats`` (optional) counts the resolved overlaps."""
    class_masks: Dict[int, np.ndarray] = {}
    try:
        for class_id, points in parse_label_file(label_path):
            pixel_coords = [(int(x * img_width), int(y * img_height)) for x, y in points]
            if len(pixel_coords) < 3:
                continue
            im = Image.new("L", (img_width, img_height), 0)
            ImageDraw.Draw(im).polygon(pixel_coords, fill=1)
            poly = np.asarray(im, dtype=np.uint8)
            if class_id in class_masks:
                class_masks[class_id] = np.logical_or(class_masks[class_id], poly).astype(np.uint8)
            else:
                class_masks[class_id] = poly
    except OSError as e:
        print(f"Warning: Could not create mask from {label_path}: {e}")
        return np.zeros((img_height, img_width), dtype=np.uint8)

    final_mask = np.zeros((img_height, img_width), dtype=np.uint8)
    has_overlaps = False
    if stats is not None:
        stats["files_processed"] += 1
    for class_id in CLASS_PRIORITY_ORDER:
        if class_id not in class_masks:
            continue
        final_id = CLASS_ID_TO_FINAL_ID[class_id]
        current = class_masks[class_id] == 1
        if stats is not None and np.any(final_mask > 0):
            overlap = current & (final_mask > 0)
            if np.any(overlap):
                has_overlaps = True
                if class_id == 1:  # spalling over others
                    stats["pixels_resolved"]["spalling_over_pitting"] += int(
                        np.sum(overlap & (final_mask == 1)))
                    stats["pixels_resolved"]["spalling_over_scrape"] += int(
                        np.sum(overlap & (final_mask == 3)))
                elif class_id == 0:  # pitting over scrape
                    stats["pixels_resolved"]["pitting_over_scrape"] += int(
                        np.sum(overlap & (final_mask == 3)))
        final_mask[current] = final_id
    if stats is not None and has_overlaps:
        stats["files_with_overlaps"] += 1
    return final_mask


class GearDataset:
    """Index of one Gear split; loads fixed-size uint8 samples with cached masks."""

    def __init__(self, root_dir: str, split: str = "train",
                 image_size: Tuple[int, int] = (512, 512),
                 enable_priority_logging: bool = False,
                 cache_masks: bool = True, cache_samples: bool = True,
                 disk_cache_dir: Optional[str] = None):
        if disk_cache_dir is not None:
            raise NotImplementedError("the packed on-disk sample store is not ported "
                                      "yet; pass disk_cache_dir=None")
        self._cache = SampleCache() if cache_samples else None
        self.root_dir = root_dir
        self.split = split
        self.image_size = image_size
        self.enable_priority_logging = enable_priority_logging
        self.cache_masks = cache_masks
        self._mask_cache: Dict[int, np.ndarray] = {}
        self.priority_stats = {
            "files_processed": 0,
            "files_with_overlaps": 0,
            "pixels_resolved": {"spalling_over_pitting": 0, "spalling_over_scrape": 0,
                                "pitting_over_scrape": 0},
        }

        self.image_paths: List[str] = []
        self.label_paths: List[str] = []
        class_names = set()
        images_dir = os.path.join(root_dir, "images", split)
        labels_dir = os.path.join(root_dir, "labels", split)
        if not os.path.isdir(images_dir):
            raise ValueError(f"Images directory not found: {images_dir}")
        if not os.path.isdir(labels_dir):
            raise ValueError(f"Labels directory not found: {labels_dir}")

        present_final_ids = set()
        for img_file in sorted(os.listdir(images_dir)):
            if img_file.lower().endswith((".jpg", ".jpeg", ".png")):
                label_path = os.path.join(labels_dir, os.path.splitext(img_file)[0] + ".txt")
                if os.path.exists(label_path):
                    self.image_paths.append(os.path.join(images_dir, img_file))
                    self.label_paths.append(label_path)
                    for class_id, _ in parse_label_file(label_path):
                        if class_id in CLASS_NAMES_MAP:
                            class_names.add(CLASS_NAMES_MAP[class_id])
                            present_final_ids.add(CLASS_ID_TO_FINAL_ID[class_id])

        self.class_names = [n for n in CLASS_ORDER if n in class_names]
        # The ids are fixed (pitting 1, spalling 2, scrape 3) whichever classes
        # a split holds, so the class count covers the highest id rasterized
        # (the reference's len(names) + 1 leaves a label out of range when a
        # lower-id class is absent).
        self.num_classes = max(present_final_ids, default=0) + 1
        self.class_to_idx = {"background": 0, "pitting": 1, "spalling": 2, "scrape": 3}

        print(f"Found {len(self.image_paths)} images in {split} split")
        print(f"Classes: {self.class_names}")
        print(f"Number of classes (including background): {self.num_classes}")

    def __len__(self) -> int:
        return len(self.image_paths)

    def _mask_for(self, idx: int) -> np.ndarray:
        if self.cache_masks and idx in self._mask_cache:
            return self._mask_cache[idx]
        with Image.open(self.image_paths[idx]) as im:
            orig_w, orig_h = im.size
        stats = self.priority_stats if self.enable_priority_logging else None
        mask = rasterize_labelme(self.label_paths[idx], orig_w, orig_h, stats)
        mask = resize_mask_array(mask, self.image_size)
        if self.cache_masks:
            self._mask_cache[idx] = mask
        return mask

    def load(self, idx: int) -> Dict:
        return cached_load(self._cache, idx, lambda: self._load_uncached(idx))

    def _load_uncached(self, idx: int) -> Dict:
        image = load_image_rgb(self.image_paths[idx], self.image_size)
        return {
            "image": image,
            # uint8 (labels <= 3): 4x less to copy than int32; the steps cast
            # on the device.
            "mask": np.ascontiguousarray(self._mask_for(idx), dtype=np.uint8),
            "image_path": self.image_paths[idx],
        }

    def print_priority_stats(self):
        s = self.priority_stats
        if s["files_processed"] > 0:
            print(f"\nPriority Resolution Stats for {self.split} split:")
            print(f"   Files with overlaps resolved: "
                  f"{s['files_with_overlaps']}/{s['files_processed']}")
            for conflict, pixels in s["pixels_resolved"].items():
                if pixels > 0:
                    print(f"   {conflict.replace('_', ' ')}: {pixels:,} pixels resolved")


def get_datasets(root_dir: str, image_size: Tuple[int, int] = (512, 512),
                 enable_priority_logging: bool = False):
    """(train, val, test, num_classes)."""
    train = GearDataset(root_dir, "train", image_size, enable_priority_logging)
    val = GearDataset(root_dir, "val", image_size, enable_priority_logging)
    test = GearDataset(root_dir, "test", image_size, enable_priority_logging)
    return train, val, test, train.num_classes
