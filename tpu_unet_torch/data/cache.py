"""Decoded-sample RAM cache for the host input pipeline (counterpart of
``tpu_unet/data/cache.py``).

After the first epoch every decode and resize becomes a dictionary lookup:
the post-resize uint8 arrays are the same every epoch (augmentation draws
live on the device), so caching them is exact. Caching stops silently once
``max_bytes`` is reached (default 2 GiB, or ``TPU_UNET_SAMPLE_CACHE_BYTES``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np

DEFAULT_MAX_BYTES = int(os.environ.get("TPU_UNET_SAMPLE_CACHE_BYTES",
                                       2 * 1024 * 1024 * 1024))


class SampleCache:
    """Thread-safe insert-once cache of numpy sample dicts, with a byte budget."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_bytes = max_bytes
        self._store: Dict[int, dict] = {}
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, idx: int) -> Optional[dict]:
        return self._store.get(idx)

    def put(self, idx: int, sample: dict) -> None:
        size = sum(v.nbytes for v in sample.values() if isinstance(v, np.ndarray))
        with self._lock:
            if idx in self._store or self._bytes + size > self.max_bytes:
                return
            self._store[idx] = sample
            self._bytes += size

    def __len__(self) -> int:
        return len(self._store)

    @property
    def nbytes(self) -> int:
        return self._bytes


def cached_load(cache: Optional[SampleCache], idx: int, loader_fn):
    """Fetch from the cache, or load and insert. ``loader_fn() -> dict``."""
    if cache is None:
        return loader_fn()
    hit = cache.get(idx)
    if hit is not None:
        return hit
    sample = loader_fn()
    cache.put(idx, sample)
    return sample
