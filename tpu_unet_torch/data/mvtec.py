"""MVTec anomaly-detection dataset: filesystem index and sample loading
(counterpart of ``tpu_unet/data/mvtec.py``, the same index order and samples).

- train split: ``<category>/train/good/*.png`` only (label 0, zero mask);
- test split: ``test/good``, then every anomaly-type subdir in sorted order,
  with masks from ``ground_truth/<type>/<name>_mask.png`` binarized (> 0);
- a sample is ``{image (H, W, 3) uint8, mask (H, W, 1) float32, label int32,
  anomaly_type, image_path}``.

Decoded samples come from a pack on disk (``data/diskcache.py``) when
``disk_cache_dir`` names one ('auto', the default: ``TPU_UNET_DATA_CACHE``,
else ``~/.cache/tpu_unet_data``), with the JAX package's fingerprint tag;
without a pack they are decoded and kept in a RAM cache (``data/cache.py``).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpu_unet_torch.data import diskcache
from tpu_unet_torch.data.cache import SampleCache, cached_load
from tpu_unet_torch.data.transforms import load_image_rgb, load_mask, resize_backend_tag


@dataclasses.dataclass
class MVTecSample:
    image_path: str
    mask_path: Optional[str]
    label: int  # 0 normal, 1 anomalous
    anomaly_type: str


class MVTecDataset:
    """Index of one MVTec category split; loads fixed-size uint8 samples."""

    def __init__(self, root_dir: str, category: str, split: str = "train",
                 image_size: int = 256, is_train: bool = True,
                 cache_samples: bool = True,
                 disk_cache_dir: Optional[str] = "auto",
                 mask_resize: str = "nearest"):
        if mask_resize not in ("nearest", "bilinear"):
            raise ValueError(f"mask_resize must be 'nearest' or 'bilinear', "
                             f"got {mask_resize!r}")
        self.root_dir = root_dir
        self.category = category
        self.split = split
        self.image_size = image_size
        self.is_train = is_train
        self.mask_resize = mask_resize
        self.samples: List[MVTecSample] = []
        self._cache = SampleCache() if cache_samples else None
        self._load_index()
        self._pack = None
        root = diskcache.cache_root(disk_cache_dir)
        if root:
            paths = [s.image_path for s in self.samples] + [
                s.mask_path for s in self.samples if s.mask_path]
            fp = diskcache.fingerprint(
                f"mvtec|{category}|{split}|{image_size}|{is_train}|"
                f"{resize_backend_tag()}|mask={mask_resize}", paths)
            self._pack = diskcache.PackedStore.open_or_build(
                root, fp, len(self.samples), self._load_uncached, log=print)

    def _load_index(self):
        category_dir = os.path.join(self.root_dir, self.category)
        if self.split == "train":
            good_dir = os.path.join(category_dir, "train", "good")
            for p in sorted(glob.glob(os.path.join(good_dir, "*.png"))):
                self.samples.append(MVTecSample(p, None, 0, "good"))
        elif self.split == "test":
            test_dir = os.path.join(category_dir, "test")
            gt_dir = os.path.join(category_dir, "ground_truth")
            good_dir = os.path.join(test_dir, "good")
            for p in sorted(glob.glob(os.path.join(good_dir, "*.png"))):
                self.samples.append(MVTecSample(p, None, 0, "good"))
            if not self.is_train:
                types = sorted(os.listdir(test_dir)) if os.path.isdir(test_dir) else []
                for anomaly_type in types:
                    adir = os.path.join(test_dir, anomaly_type)
                    if anomaly_type == "good" or not os.path.isdir(adir):
                        continue
                    for p in sorted(glob.glob(os.path.join(adir, "*.png"))):
                        name = os.path.basename(p).replace(".png", "_mask.png")
                        mask_path = os.path.join(gt_dir, anomaly_type, name)
                        self.samples.append(MVTecSample(
                            p, mask_path if os.path.exists(mask_path) else None,
                            1, anomaly_type))
        else:
            raise ValueError(f"Unknown split: {self.split!r}")

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, idx: int) -> Dict:
        if self._pack is not None:
            return self._pack.load(idx)
        return cached_load(self._cache, idx, lambda: self._load_uncached(idx))

    def _load_uncached(self, idx: int) -> Dict:
        s = self.samples[idx]
        size = (self.image_size, self.image_size)
        image = load_image_rgb(s.image_path, size)
        if s.mask_path is not None:
            mask = load_mask(s.mask_path, size, binarize=True,
                             method=self.mask_resize).astype(np.float32)
        else:
            mask = np.zeros(size, dtype=np.float32)
        return {
            "image": image,
            "mask": mask[..., None],
            "label": np.int32(s.label),
            "anomaly_type": s.anomaly_type,
            "image_path": s.image_path,
        }


def get_available_categories(root_dir: str) -> List[str]:
    """Categories: the directories that hold both train/ and test/."""
    categories = []
    if not os.path.isdir(root_dir):
        return categories
    for item in os.listdir(root_dir):
        item_path = os.path.join(root_dir, item)
        if os.path.isdir(item_path) and not item.startswith("."):
            if (os.path.isdir(os.path.join(item_path, "train"))
                    and os.path.isdir(os.path.join(item_path, "test"))):
                categories.append(item)
    return sorted(categories)


def get_datasets(root_dir: str, category: str, image_size: int = 256
                 ) -> Tuple[MVTecDataset, MVTecDataset]:
    """(train, test) datasets; the test split holds the anomalous images and
    their masks."""
    train = MVTecDataset(root_dir, category, "train", image_size, is_train=True)
    test = MVTecDataset(root_dir, category, "test", image_size, is_train=False)
    return train, test
