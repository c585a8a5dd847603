"""KolektorSDD surface-defect dataset: a walk of the ``kos*`` folders and a
seeded 70/15/15 split (counterpart of ``tpu_unet/data/kolektorsdd.py``, the
same split membership and samples).

- pairs ``kos*/X.jpg`` with ``kos*/X_label.bmp``;
- sorts every pair, shuffles with ``random.Random(42)`` and slices train,
  val and test by fractions: the reference's split for the same files;
- mask values clipped to {0, 1, 2}: 3 classes (background, defect_type_1,
  defect_type_2), shipped as uint8;
- default image size (1024, 512), H x W.

Samples come from a pack on disk (``data/diskcache.py``; ``disk_cache_dir``
'auto' by default) with the JAX package's fingerprint tag; without a pack
they are decoded and kept in a RAM cache (``data/cache.py``).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from tpu_unet_torch.data import diskcache
from tpu_unet_torch.data.cache import SampleCache, cached_load
from tpu_unet_torch.data.transforms import (load_image_rgb, resize_backend_tag,
                                            resize_mask_array)

CLASS_NAMES = ["background", "defect_type_1", "defect_type_2"]
NUM_CLASSES = 3


def build_split(root_dir: str, split: str, train_split: float = 0.7,
                val_split: float = 0.15) -> List[Tuple[str, str]]:
    """The (image, mask) path pairs of one split, the reference's shuffle."""
    if not os.path.isdir(root_dir):
        raise ValueError(f"Dataset root directory not found: {root_dir}")
    all_samples: List[Tuple[str, str]] = []
    for folder_name in sorted(os.listdir(root_dir)):
        folder_path = os.path.join(root_dir, folder_name)
        if os.path.isdir(folder_path) and folder_name.startswith("kos"):
            for file_name in sorted(os.listdir(folder_path)):
                if file_name.endswith(".jpg"):
                    img_path = os.path.join(folder_path, file_name)
                    mask_path = os.path.join(folder_path,
                                             file_name.replace(".jpg", "_label.bmp"))
                    if os.path.exists(mask_path):
                        all_samples.append((img_path, mask_path))
    all_samples.sort()
    total = len(all_samples)
    train_end = int(total * train_split)
    val_end = int(total * (train_split + val_split))
    rng = random.Random()
    rng.seed(42)
    rng.shuffle(all_samples)
    if split == "train":
        return all_samples[:train_end]
    if split == "val":
        return all_samples[train_end:val_end]
    if split == "test":
        return all_samples[val_end:]
    raise ValueError(f"Invalid split: {split}. Must be 'train', 'val', or 'test'")


class KolektorSDDDataset:
    """Index of one KolektorSDD split; loads fixed-size uint8 samples."""

    def __init__(self, root_dir: str, split: str = "train",
                 image_size: Tuple[int, int] = (1024, 512),
                 train_split: float = 0.7, val_split: float = 0.15,
                 cache_samples: bool = True,
                 disk_cache_dir: Optional[str] = "auto"):
        self._cache = SampleCache() if cache_samples else None
        self.root_dir = root_dir
        self.split = split
        self.image_size = image_size
        self.class_names = list(CLASS_NAMES)
        self.num_classes = NUM_CLASSES
        pairs = build_split(root_dir, split, train_split, val_split)
        self.image_paths = [p for p, _ in pairs]
        self.mask_paths = [m for _, m in pairs]
        print(f"Found {len(self.image_paths)} samples in {split} split")
        print(f"Classes: {self.class_names}")
        print(f"Number of classes: {self.num_classes}")
        self._pack = None
        root = diskcache.cache_root(disk_cache_dir)
        if root:
            fp = diskcache.fingerprint(
                f"ksdd|{split}|{image_size[0]}x{image_size[1]}|{train_split}|"
                f"{val_split}|{resize_backend_tag()}|mu8",
                self.image_paths + self.mask_paths)
            self._pack = diskcache.PackedStore.open_or_build(
                root, fp, len(self.image_paths), self._load_uncached, log=print)

    def __len__(self) -> int:
        return len(self.image_paths)

    def load(self, idx: int) -> Dict:
        if self._pack is not None:
            return self._pack.load(idx)
        return cached_load(self._cache, idx, lambda: self._load_uncached(idx))

    def _load_uncached(self, idx: int) -> Dict:
        image = load_image_rgb(self.image_paths[idx], self.image_size)
        with Image.open(self.mask_paths[idx]) as im:
            mask = np.asarray(im.convert("L"), dtype=np.uint8)
        mask = resize_mask_array(np.clip(mask, 0, 2), self.image_size)
        return {
            "image": image,
            "mask": np.ascontiguousarray(mask, dtype=np.uint8),
            "image_path": self.image_paths[idx],
        }


def get_datasets(root_dir: str, image_size: Tuple[int, int] = (1024, 512),
                 train_split: float = 0.7, val_split: float = 0.15):
    """(train, val, test, num_classes)."""
    train = KolektorSDDDataset(root_dir, "train", image_size, train_split, val_split)
    val = KolektorSDDDataset(root_dir, "val", image_size, train_split, val_split)
    test = KolektorSDDDataset(root_dir, "test", image_size, train_split, val_split)
    return train, val, test, NUM_CLASSES
