"""Prefetching batch loader: host threads decode while the device computes
(counterpart of ``tpu_unet/data/loader.py``).

A thread pool (PIL decode releases the GIL) assembles whole batches inside a
bounded in-flight window. Numeric fields are stacked into contiguous arrays,
string fields (paths, anomaly types) stay host lists. The last partial batch
is either dropped (training) or zero-padded to the full batch with a
``valid`` mask (evaluation). The shuffled order of an epoch comes from
``np.random.default_rng(seed + epoch)``, so it is the JAX loader's.

Under data parallelism every rank computes the same global index batches
and assembles only its rows: the JAX loader's contiguous block of process
r, or with ``grad_accum`` G its block of each of the G microbatches in turn
(``parallel/mesh.py::batch_rows``), which is what the train steps expect.

:func:`to_device` is the host-to-device transform: each numeric array goes
through a fresh pinned host tensor and a non-blocking copy, so the copy
neither waits for the device to drain nor blocks the host.
"""

from __future__ import annotations

import concurrent.futures as cf
import warnings
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from tpu_unet_torch.parallel.mesh import batch_rows, data_rank, data_size


def _collate(samples, valid: Optional[np.ndarray] = None) -> Dict:
    """Stack sample dicts; ``valid`` (bool rows) marks zero-padded entries."""
    batch: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            batch[key] = list(vals)
        else:
            batch[key] = np.stack(vals)
    if valid is not None:
        batch["valid"] = valid
    return batch


def _zero_like_sample(template: Dict) -> Dict:
    return {k: ("" if isinstance(v, str) else np.zeros_like(v))
            for k, v in template.items()}


def to_device(batch: Dict, device, mask_dtype=None) -> Dict:
    """Move a batch's numeric fields to ``device``; strings stay host lists.

    On CUDA each numpy array is copied into a fresh pinned host tensor and
    sent with ``non_blocking=True``. A copy from pageable memory would first
    wait for every kernel already queued on the stream. PyTorch's pinned-memory
    allocator does not hand a block out again before the copies that read it
    have completed, so the pinned tensor may be dropped right after the call.
    Tensors already present are moved with ``.to``. ``mask_dtype`` (a numpy
    dtype, e.g. ``np.uint8`` for binary training masks) casts the ``mask``
    field on the host first, which shrinks the copy.
    """
    device = torch.device(device)
    out: Dict = {}
    for key, value in batch.items():
        if isinstance(value, torch.Tensor):
            out[key] = value.to(device, non_blocking=True)
            continue
        if not isinstance(value, np.ndarray):
            out[key] = value
            continue
        if key == "mask" and mask_dtype is not None:
            value = value.astype(mask_dtype)
        src = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            pinned.copy_(src)
            out[key] = pinned.to(device, non_blocking=True)
        else:
            out[key] = src
    return out


class DataLoader:
    """Iterable over batches with background prefetch.

    Args:
      dataset: object with ``__len__`` and ``load(idx) -> dict``.
      batch_size: fixed batch size.
      shuffle: reshuffle each epoch (the epoch counter advances per full
        iteration; set ``loader.epoch`` to resume an order).
      seed: base seed of the shuffle.
      drop_last: drop the final partial batch (training).
      pad_last: zero-pad the final batch and add a 'valid' mask (evaluation).
      num_workers: decode threads.
      prefetch: batches kept in flight ahead of the consumer.
      transform: optional function applied to each assembled batch on the
        consumer's thread (e.g. ``lambda b: to_device(b, "cuda")``).
      process_count, process_index: data ranks of the run and this one's
        index; default from the mesh (``parallel/mesh.py::data_size``,
        ``data_rank``: 1 and 0 without a process group; every space and
        model rank of a data index gets the same rows, whole images, which
        the steps split over 'space'). ``batch_size`` is the global batch.
      grad_accum: microbatches of each global batch; a rank's rows are its
        block of each microbatch in turn.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, pad_last: bool = False,
                 num_workers: int = 8, prefetch: int = 2,
                 transform: Optional[Callable[[Dict], Dict]] = None,
                 process_count: Optional[int] = None,
                 process_index: Optional[int] = None, grad_accum: int = 1):
        if drop_last and pad_last:
            raise ValueError("drop_last and pad_last are mutually exclusive")
        if process_count is None:
            process_count, process_index = data_size(), data_rank()
        if batch_size % (process_count * grad_accum) != 0:
            raise ValueError(f"global batch_size {batch_size} not divisible by "
                             f"process_count {process_count} x grad_accum {grad_accum}")
        self.process_count = process_count
        self.process_index = process_index or 0
        self.local_rows = batch_rows(batch_size, grad_accum, process_count,
                                     self.process_index)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.transform = transform
        self.epoch = 0
        self._warned_ragged = False

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        """Index batches of this epoch; padded rows are -1."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        batches = []
        for start in range(0, n, self.batch_size):
            idxs = order[start:start + self.batch_size]
            if len(idxs) < self.batch_size:
                if self.drop_last:
                    continue
                if self.pad_last:
                    idxs = np.concatenate(
                        [idxs, np.full(self.batch_size - len(idxs), -1, idxs.dtype)])
                elif self.process_count > 1:
                    raise ValueError(
                        "multi-process loading needs drop_last or pad_last to keep "
                        "the global batch divisible across processes")
                elif not self._warned_ragged:
                    self._warned_ragged = True
                    warnings.warn(
                        f"final batch has {len(idxs)} rows (< batch_size "
                        f"{self.batch_size}); pass drop_last=True (training) or "
                        "pad_last=True (eval) to keep one batch shape", stacklevel=3)
            batches.append(idxs)
        return batches

    def _assemble(self, idxs: np.ndarray) -> Dict:
        if self.process_count > 1:
            idxs = idxs[self.local_rows]  # this rank decodes its rows only
        samples = [self.dataset.load(int(i)) if i >= 0 else None for i in idxs]
        template = next((s for s in samples if s is not None), None)
        if template is None:  # a batch that is entirely padding
            template = self.dataset.load(0)
        zero = _zero_like_sample(template)
        samples = [s if s is not None else zero for s in samples]
        valid = (idxs >= 0) if self.pad_last else None
        return _collate(samples, valid=valid)

    def __iter__(self) -> Iterator[Dict]:
        it = iter(self._index_batches())
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window: list = []
            for idxs in it:
                window.append(pool.submit(self._assemble, idxs))
                if len(window) == self.prefetch:
                    break
            while window:
                fut = window.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    window.append(pool.submit(self._assemble, nxt))
                batch = fut.result()
                yield self.transform(batch) if self.transform else batch
        self.epoch += 1
