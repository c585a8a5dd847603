"""Helpers shared by the CLIs (counterpart of ``tpu_unet/cli/_seg_common.py``;
the segmentation driver itself is not ported yet)."""

from __future__ import annotations

import numpy as np


class _Subset:
    """Random fixed-size subset: the reference's ``--debug`` sampling, shared
    by every CLI's ``--debug`` path (the MVTec trainer re-exports it)."""

    def __init__(self, dataset, n, seed):
        rng = np.random.default_rng(seed)
        self.indices = rng.choice(len(dataset), size=min(n, len(dataset)), replace=False)
        self.dataset = dataset

    def __len__(self):
        return len(self.indices)

    def load(self, i):
        return self.dataset.load(int(self.indices[i]))
