"""Epoch drivers of the MVTec anomaly task and of the segmentation task: thin
host loops around the steps (counterpart of ``tpu_unet/train/loop.py``).

- Batches arrive as tensors on the state's device: the loader's transform
  is ``data/loader.py::to_device`` (pinned, non-blocking copies), so no step
  copies from pageable memory. The loops move nothing themselves.
- The per-step loss scalars stay on the device until the epoch ends; then one
  host copy fetches them all (:func:`_fetch_scalars`). Progress lines read a
  lagged step's loss from pinned memory after that step's event (:class:`_Progress`).
- The seg steps' confusion matrices are summed on the device; the sum comes
  to the host once per epoch, and a progress line's running mIoU reads the
  lagged step's running sum as it reads its loss.
- Draws: each epoch gets one ``torch.Generator`` on the state's device,
  seeded from ``(seed, epoch)``, and the steps draw from it in order, so a
  resumed run draws what an uninterrupted one would.
- Validation computes the reference's metrics on the host, as the JAX
  package does: loss scalars weighted by the valid rows, the image threshold
  at the 95th percentile of the float32 scores, pixel F1 at 0.3/0.5/0.7 over
  the anomalous images.
- Data parallelism: every rank runs the loop on its rows. The steps return
  the global batch's loss scalars and confusion matrices; validation
  gathers every rank's rows (``parallel/collectives.py``, in the global
  batch order) and the per-batch valid counts, so every rank computes the
  global metrics. Only rank 0 prints.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpu_unet_torch.metrics.binary import calculate_metrics
from tpu_unet_torch.metrics.confusion import SegmentationMetrics
from tpu_unet_torch.parallel.collectives import all_gather_host_values, gather_batches
from tpu_unet_torch.parallel.mesh import data_size, is_main_process

_LOSS_NAMES = ("total_loss", "recon_loss", "seg_loss")


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The draws' generator of one epoch, seeded from ``(seed, epoch)``."""
    epoch_seed = int(np.random.SeedSequence((seed, epoch)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(epoch_seed)


def _fetch_scalars(per_batch: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Every per-batch loss scalar in one device-to-host copy, as float64."""
    names = list(per_batch[0])
    stacked = torch.stack([torch.stack([d[n].detach().to(torch.float32) for n in names])
                           for d in per_batch])
    host = stacked.cpu().numpy().astype(np.float64)
    return {n: host[:, i] for i, n in enumerate(names)}


def _weighted_losses(per_batch: List[Dict[str, torch.Tensor]], counts) -> Dict[str, float]:
    """Each loss's mean over the batches, weighted by ``counts`` (one host fetch)."""
    weights = np.asarray(counts, np.float64)
    return {name: float((vals * weights).sum() / weights.sum())
            for name, vals in _fetch_scalars(per_batch).items()}


class _Progress:
    """Intra-epoch progress lines every ``every`` steps.

    The line after step ``i`` reads the loss of step ``_lagged(i)``, at least
    one step back. Only those steps' losses are kept (:meth:`record`): each
    is copied into pinned host memory with a non-blocking copy and an event
    behind it, and the line reads it after that event. ``.item()`` on a CUDA
    tensor would instead wait for everything queued on the stream, the step
    just launched included. The reported img/s counts the images known
    complete over the elapsed time, a lower bound.
    """

    def __init__(self, fn: Optional[Callable[[str], None]], every: int, n_total):
        # every <= 0 disables; ranks other than 0 print nothing
        self.fn = fn if every and every > 0 and is_main_process() else None
        self.every, self.n_total = max(int(every), 1), n_total
        self.t0 = time.perf_counter()
        self._losses: dict = {}  # step -> ([loss, running cm] on the host, event or None)

    def _lagged(self, i: int) -> int:
        """The step whose loss the line after step ``i`` reads: one behind
        even with every=1."""
        return min(i + 1 - self.every, i - 1)

    def record(self, i: int, loss: torch.Tensor,
               running_cm: Optional[torch.Tensor] = None) -> None:
        """Keep step ``i``'s loss (and ``running_cm``, the confusion matrix
        summed over steps 0..i, for a running mIoU) if a line reads it:
        ``_lagged`` of a line's step is a multiple of ``every``."""
        if self.fn is None or i % self.every != 0:
            return
        kept = [t.detach() for t in (loss, running_cm) if t is not None]
        done = None
        if loss.is_cuda:
            kept = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True) for t in kept]
            done = torch.cuda.Event()
            done.record()
        self._losses[i] = (kept, done)

    def tick(self, i: int, counts, extra: str = "") -> None:
        if self.fn is None or (i + 1) % self.every != 0:
            return
        j = self._lagged(i)
        if j < 0:
            return
        kept, done = self._losses.pop(j)
        if done is not None:
            done.synchronize()  # step j only, not the steps queued after it
        loss = float(kept[0])
        if len(kept) > 1 and int(kept[1].sum()) > 0:
            # 0 for a class not seen yet, as the epoch's compute_iou gives.
            running = SegmentationMetrics(kept[1].shape[0])
            running.confusion_matrix = kept[1].numpy().astype(np.int64)
            extra = f", mIoU {float(np.nanmean(running.compute_iou())):.4f}{extra}"
        imgs_done = float(np.sum(counts[: j + 1]))
        dt = max(time.perf_counter() - self.t0, 1e-9)
        total = f"/{self.n_total}" if self.n_total is not None else ""
        self.fn(f"  step {i + 1}{total}: loss {loss:.4f}"
                f"{extra} [{imgs_done / dt:.1f} img/s]")


def train_anomaly_epoch(state, step_fn, loader, seed: int, epoch: int,
                        log_fn: Optional[Callable[[str], None]] = None,
                        progress_fn: Optional[Callable[[str], None]] = None,
                        progress_every: int = 10,
                        should_stop: Optional[Callable[[], bool]] = None
                        ) -> Dict[str, float]:
    """One training epoch, updating ``state`` in place; returns the epoch's
    ``{'total_loss', 'recon_loss', 'seg_loss'}``, each the mean over the steps
    weighted by their batch sizes.

    ``step_fn(state, images, masks, generator)`` is called once per batch
    with the loader's batch fields (tensors on the state's device, from its
    ``to_device`` transform) and this epoch's generator. ``progress_fn``
    receives a progress line every ``progress_every`` steps. ``should_stop`` is polled
    between steps; True ends the epoch early (the trainer's SIGTERM latch),
    and the metrics cover the steps that ran.
    """
    device = state.device
    generator = epoch_generator(seed, epoch, device)
    per_batch, counts = [], []
    prog = _Progress(progress_fn, progress_every,
                     len(loader) if hasattr(loader, "__len__") else None)
    for i, batch in enumerate(loader):
        if should_stop is not None and should_stop():
            break
        losses = step_fn(state, batch["image"], batch["mask"], generator)
        per_batch.append(losses)
        counts.append(batch["image"].shape[0])
        prog.record(i, losses["total_loss"])
        prog.tick(i, counts)
    if not per_batch:
        return {name: 0.0 for name in _LOSS_NAMES}
    out = _weighted_losses(per_batch, counts)
    if log_fn and is_main_process():
        log_fn(f"Epoch {epoch}: loss {out['total_loss']:.4f} "
               f"(recon {out['recon_loss']:.4f}, seg {out['seg_loss']:.4f})")
    return out


def _host(parts: List[torch.Tensor]) -> np.ndarray:
    return torch.cat(parts).cpu().numpy()


def _global_counts(valids: List[torch.Tensor]) -> np.ndarray:
    """Each batch's valid rows over every rank, as float64."""
    local = torch.stack([v.sum() for v in valids]).cpu().numpy().astype(np.float64)
    if data_size() == 1:
        return local
    return all_gather_host_values(local).reshape(-1, len(valids)).sum(0)


def validate_anomaly_epoch(state, eval_fn, loader) -> Dict:
    """Validation pass with the reference's image and pixel metric recipe.

    ``eval_fn(state, images, masks, valid)`` runs once per batch on the
    loader's batches (tensors on the state's device, from its ``to_device``
    transform); its outputs stay on the device until the loader is drained,
    then come to the host in one go. Under data parallelism the rows of
    every rank are gathered, so each rank returns the global metrics and
    predictions (in the global batch order).
    """
    device = state.device
    losses, valids, labels, scores, masks_true, masks_pred = [], [], [], [], [], []
    for batch in loader:
        v = batch.get("valid")
        out = eval_fn(state, batch["image"], batch["mask"], v)
        n = batch["image"].shape[0]
        losses.append(out["losses"])
        valids.append(v.to(torch.bool) if v is not None
                      else torch.ones(n, dtype=torch.bool, device=device))
        labels.append(batch["label"])
        scores.append(out["score"])
        masks_true.append(batch["mask"][..., 0])
        masks_pred.append(out["anomaly_map"])

    if not losses:  # an empty validation split
        return {
            "total_loss": 0.0, "recon_loss": 0.0, "seg_loss": 0.0,
            "image_metrics": {}, "pixel_metrics": {},
            "predictions": {"labels": np.zeros(0, int), "scores": np.zeros(0),
                            "masks_true": np.zeros((0,)), "masks_pred": np.zeros((0,))},
        }
    scalars = _fetch_scalars(losses)
    counts = _global_counts(valids)
    loss_out = {name: float((scalars[name] * counts).sum() / counts.sum())
                for name in _LOSS_NAMES}

    nb = len(valids)
    valid = gather_batches(_host(valids), nb)
    labels = gather_batches(_host(labels), nb)[valid]
    scores = gather_batches(_host(scores), nb)[valid]
    masks_true = gather_batches(_host(masks_true), nb)[valid]
    masks_pred = gather_batches(_host(masks_pred), nb)[valid]

    if len(np.unique(labels)) > 1:
        threshold = np.percentile(scores, 95)
        predictions = (scores > threshold).astype(int)
        image_metrics = calculate_metrics(labels, predictions, scores)
    else:
        image_metrics = {
            "accuracy": 1.0 if labels[0] == 0 else 0.0,
            "precision": 0.0,
            "recall": 0.0,
            "specificity": 1.0 if labels[0] == 0 else 0.0,
            "f1_score": 0.0,
            "auroc": 0.0,
            "auprc": 0.0,
        }

    pixel_metrics: Dict[str, float] = {}
    anomaly_idx = labels == 1
    if anomaly_idx.sum() > 0:
        for threshold in (0.3, 0.5, 0.7):
            pred = (masks_pred[anomaly_idx] > threshold).astype(np.uint8).ravel()
            true = (masks_true[anomaly_idx] > 0.5).astype(np.uint8).ravel()
            if len(np.unique(true)) > 1:
                pixel_metrics[f"pixel_f1_@{threshold}"] = calculate_metrics(true, pred)["f1_score"]

    return {
        **loss_out,
        "image_metrics": image_metrics,
        "pixel_metrics": pixel_metrics,
        "predictions": {
            "labels": labels,
            "scores": scores,
            "masks_true": masks_true,
            "masks_pred": masks_pred,
        },
    }


# ---------------------------------------------------------------------------
# Segmentation (Gear / KolektorSDD)
# ---------------------------------------------------------------------------

def train_seg_epoch(state, step_fn, loader, seed: int, epoch: int, num_classes: int,
                    progress_fn: Optional[Callable[[str], None]] = None,
                    progress_every: int = 10,
                    should_stop: Optional[Callable[[], bool]] = None):
    """One segmentation training epoch, updating ``state`` in place; returns
    ``(losses, metrics)``: each loss the mean over the steps weighted by
    their batch sizes ({} when no step ran), and a
    :class:`SegmentationMetrics` holding the epoch's confusion matrix.

    ``step_fn(state, images, labels, generator) -> (losses, cm)`` is called
    once per batch with the loader's batch fields (tensors on the state's
    device) and this epoch's generator. The steps' matrices are summed on
    the device; the losses and the sum come to the host once, at the end.
    ``progress_fn`` receives a line every ``progress_every`` steps with a
    lagged step's loss and running mIoU. ``should_stop`` is polled between
    steps; True ends the epoch early (the trainer's SIGTERM latch).
    """
    generator = epoch_generator(seed, epoch, state.device)
    metrics = SegmentationMetrics(num_classes)
    per_batch, counts = [], []
    running = None
    prog = _Progress(progress_fn, progress_every,
                     len(loader) if hasattr(loader, "__len__") else None)
    for i, batch in enumerate(loader):
        if should_stop is not None and should_stop():
            break
        losses, cm = step_fn(state, batch["image"], batch["mask"], generator)
        per_batch.append(losses)
        counts.append(batch["image"].shape[0])
        if cm is not None:
            running = cm if running is None else running + cm
        prog.record(i, losses["total_loss"], running)
        prog.tick(i, counts)
    if running is not None:
        metrics.confusion_matrix = running.cpu().numpy().astype(np.int64)
    return (_weighted_losses(per_batch, counts) if per_batch else {}), metrics


def validate_seg_epoch(state, eval_fn, loader, num_classes: int,
                       ignore_index: Optional[int] = None):
    """Validation pass; returns ``(losses, metrics)``.

    ``eval_fn(state, images, labels, valid) -> (losses, preds, cm)`` runs
    once per batch on the loader's batches (tensors on the state's device).
    The steps' matrices leave padded rows out (``valid``) and are summed on
    the device; the sum, the losses and the valid counts come to the host
    once the loader is drained. Each batch's losses weigh by its valid rows.
    ``ignore_index`` must be the eval step's: the matrices exclude it.
    Under data parallelism the step's losses and matrices are the global
    batch's and the valid counts are summed over the ranks.
    """
    device = state.device
    metrics = SegmentationMetrics(num_classes, ignore_index)
    per_batch, valids = [], []
    total = None
    for batch in loader:
        v = batch.get("valid")
        losses, _, cm = eval_fn(state, batch["image"], batch["mask"], v)
        per_batch.append(losses)
        n = batch["image"].shape[0]
        valids.append(v.to(torch.bool) if v is not None
                      else torch.ones(n, dtype=torch.bool, device=device))
        total = cm if total is None else total + cm
    if not per_batch:
        return {}, metrics
    metrics.confusion_matrix = total.cpu().numpy().astype(np.int64)
    return _weighted_losses(per_batch, _global_counts(valids)), metrics
