"""Confusion matrices on the device and the segmentation metrics derived from
them (counterpart of ``tpu_unet/metrics/confusion.py``).

A batch's (C, C) matrix (rows = target, columns = prediction) is computed on
the device where its tensors lie and stays there; the epoch drivers add
them up on the device and fetch the sum once per epoch. The derived metrics
(IoU, Dice, pixel and mean accuracy, precision, recall, F1) are the
reference's formulas, with its 1e-8 clamps and nan-mean reductions, on a
host int64 matrix.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tpu_unet_torch.ops.seg_head import SMALL_C_MAX, sliced_argmax

_F32_EXACT_MAX = 1 << 24  # the largest count a float32 accumulator holds exactly


def _pixel_valid(targets: torch.Tensor, ignore_index: Optional[int],
                 valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Flat bool mask of the pixels that count, or None when all do."""
    keep = None
    if ignore_index is not None:
        keep = targets != ignore_index
    if valid is not None:
        rows = valid.to(torch.bool).reshape((-1,) + (1,) * (targets.dim() - 1))
        rows = rows.expand(targets.shape)
        keep = rows if keep is None else keep & rows
    return None if keep is None else keep.reshape(-1)


def _confusion_matrix_sliced(preds: torch.Tensor, targets: torch.Tensor,
                             num_classes: int, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """C² mask sums, the small-C path: every operand is a flat plane and
    the sums count exactly in int64."""
    t = targets.reshape(-1)
    p = preds.reshape(-1)
    p_masks = [p == d for d in range(num_classes)]
    rows = []
    for c in range(num_classes):
        tc = t == c
        if keep is not None:
            tc = tc & keep
        rows.append(torch.stack([(tc & p_masks[d]).sum() for d in range(num_classes)]))
    return torch.stack(rows)


def _one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows; an out-of-range id gives a zero row (as
    ``jax.nn.one_hot``; ``F.one_hot`` would raise)."""
    return (x[:, None] == torch.arange(num_classes, device=x.device)).to(torch.float32)


def _confusion_matrix_impl(preds: torch.Tensor, targets: torch.Tensor,
                           num_classes: int, keep: Optional[torch.Tensor],
                           max_exact: int = _F32_EXACT_MAX) -> torch.Tensor:
    """onehot(t)^T @ onehot(p), the large-C path, in chunks of at most
    2^24 pixels so that each float32 product counts exactly."""
    t = targets.reshape(-1)
    p = preds.reshape(-1)
    w = None if keep is None else keep.to(torch.float32)
    n = t.numel()
    n_chunks = max(1, -(-n // max_exact))
    chunk = max(1, -(-n // n_chunks))
    cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=t.device)
    for lo in range(0, n, chunk):
        t_oh = _one_hot(t[lo:lo + chunk], num_classes)
        if w is not None:
            t_oh = t_oh * w[lo:lo + chunk, None]
        p_oh = _one_hot(p[lo:lo + chunk], num_classes)
        cm += (t_oh.t() @ p_oh).to(torch.int64)
    return cm


def confusion_matrix_batch(preds: torch.Tensor, targets: torch.Tensor, num_classes: int,
                           ignore_index: Optional[int] = None,
                           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, C) int64 confusion matrix of one batch, on the tensors' device.

    ``preds`` and ``targets`` are integer tensors of one shape (N, ...).
    Pixels whose target is ``ignore_index`` count nowhere, nor do the rows
    where ``valid`` ((N,) bool or 0/1; the port's addition) is false: the
    padded rows of an eval batch. C <= SMALL_C_MAX takes C² mask sums,
    larger C a chunked one-hot matmul.
    """
    keep = _pixel_valid(targets, ignore_index, valid)
    if num_classes <= SMALL_C_MAX:
        return _confusion_matrix_sliced(preds, targets, num_classes, keep)
    return _confusion_matrix_impl(preds, targets, num_classes, keep)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


class SegmentationMetrics:
    """Running confusion-matrix metrics for semantic segmentation.

    The reference class's API: reset / update / compute_* /
    compute_all_metrics / print_metrics / plot_confusion_matrix. ``update``
    takes logits (N, H, W, C) or hard predictions (N, H, W), as tensors or
    numpy arrays; the batch's matrix is computed where the tensors lie and
    added to a host int64 accumulator.
    """

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reset()

    def reset(self):
        self.confusion_matrix = np.zeros((self.num_classes, self.num_classes), np.int64)
        self.total_samples = 0

    def update(self, pred, target):
        pred, target = _as_tensor(pred), _as_tensor(target)
        if pred.dim() == target.dim() + 1:  # logits (N, H, W, C)
            pred = sliced_argmax(pred)
        cm = confusion_matrix_batch(pred.to(torch.int64), target.to(torch.int64),
                                    self.num_classes, self.ignore_index)
        self.confusion_matrix = self.confusion_matrix + cm.cpu().numpy().astype(np.int64)
        self.total_samples += int(np.prod(tuple(target.shape)))

    def _cm(self) -> np.ndarray:
        return np.asarray(self.confusion_matrix)

    def compute_iou(self, per_class: bool = True):
        cm = self._cm()
        intersection = np.diag(cm)
        union = cm.sum(axis=1) + cm.sum(axis=0) - intersection
        iou = intersection / np.maximum(union, 1e-8)
        return iou if per_class else np.nanmean(iou)

    def compute_dice(self, per_class: bool = True):
        cm = self._cm()
        intersection = np.diag(cm)
        denom = cm.sum(axis=1) + cm.sum(axis=0)
        dice = 2 * intersection / np.maximum(denom, 1e-8)
        return dice if per_class else np.nanmean(dice)

    def compute_pixel_accuracy(self) -> float:
        cm = self._cm()
        return float(np.diag(cm).sum() / max(cm.sum(), 1e-8))

    def compute_mean_accuracy(self) -> float:
        cm = self._cm()
        acc = np.diag(cm) / np.maximum(cm.sum(axis=1), 1e-8)
        return float(np.nanmean(acc))

    def compute_precision_recall_f1(self, per_class: bool = True):
        cm = self._cm()
        tp = np.diag(cm)
        fp = cm.sum(axis=0) - tp
        fn = cm.sum(axis=1) - tp
        precision = tp / np.maximum(tp + fp, 1e-8)
        recall = tp / np.maximum(tp + fn, 1e-8)
        f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-8)
        if per_class:
            return precision, recall, f1
        return np.nanmean(precision), np.nanmean(recall), np.nanmean(f1)

    def compute_all_metrics(self) -> Dict:
        iou = self.compute_iou(per_class=True)
        dice = self.compute_dice(per_class=True)
        precision, recall, f1 = self.compute_precision_recall_f1(per_class=True)
        return {
            "iou_per_class": iou,
            "mean_iou": float(np.nanmean(iou)),
            "dice_per_class": dice,
            "mean_dice": float(np.nanmean(dice)),
            "pixel_accuracy": self.compute_pixel_accuracy(),
            "mean_accuracy": self.compute_mean_accuracy(),
            "precision_per_class": precision,
            "recall_per_class": recall,
            "f1_per_class": f1,
            "mean_precision": float(np.nanmean(precision)),
            "mean_recall": float(np.nanmean(recall)),
            "mean_f1": float(np.nanmean(f1)),
            "confusion_matrix": self._cm(),
        }

    def print_metrics(self, class_names=None):
        m = self.compute_all_metrics()
        if class_names is None:
            class_names = [f"Class_{i}" for i in range(self.num_classes)]
        print("=" * 60)
        print("SEMANTIC SEGMENTATION METRICS")
        print("=" * 60)
        print(f"Pixel Accuracy:     {m['pixel_accuracy']:.4f}")
        print(f"Mean Accuracy:      {m['mean_accuracy']:.4f}")
        print(f"Mean IoU:          {m['mean_iou']:.4f}")
        print(f"Mean Dice:         {m['mean_dice']:.4f}")
        print(f"Mean Precision:    {m['mean_precision']:.4f}")
        print(f"Mean Recall:       {m['mean_recall']:.4f}")
        print(f"Mean F1:           {m['mean_f1']:.4f}")
        print("\n" + "=" * 60)
        print("PER-CLASS METRICS")
        print("=" * 60)
        print(f"{'Class':<15} {'IoU':<8} {'Dice':<8} {'Prec':<8} {'Rec':<8} {'F1':<8}")
        print("-" * 60)
        for i, name in enumerate(class_names):
            print(f"{name:<15} "
                  f"{m['iou_per_class'][i]:.4f}   "
                  f"{m['dice_per_class'][i]:.4f}   "
                  f"{m['precision_per_class'][i]:.4f}   "
                  f"{m['recall_per_class'][i]:.4f}   "
                  f"{m['f1_per_class'][i]:.4f}")

    def plot_confusion_matrix(self, class_names=None, save_path=None, figsize=(10, 8)):
        """Row-normalized confusion-matrix heatmap (matplotlib, imported here)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if class_names is None:
            class_names = [f"Class_{i}" for i in range(self.num_classes)]
        cm = self._cm().astype(float)
        cm_norm = cm / (cm.sum(axis=1, keepdims=True) + 1e-8)
        fig, ax = plt.subplots(figsize=figsize)
        im = ax.imshow(cm_norm, cmap="Blues", vmin=0, vmax=1)
        ax.set_xticks(range(self.num_classes), class_names)
        ax.set_yticks(range(self.num_classes), class_names)
        for i in range(self.num_classes):
            for j in range(self.num_classes):
                ax.text(j, i, f"{cm_norm[i, j]:.3f}", ha="center", va="center",
                        color="white" if cm_norm[i, j] > 0.5 else "black")
        ax.set_title("Normalized Confusion Matrix")
        ax.set_xlabel("Predicted Label")
        ax.set_ylabel("True Label")
        fig.colorbar(im)
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=300, bbox_inches="tight")
        return fig


def compute_metrics_from_predictions(predictions, targets, num_classes, class_names=None):
    """The reference's convenience wrapper: every metric of one set of
    predictions (or logits) against targets."""
    calc = SegmentationMetrics(num_classes)
    calc.update(predictions, targets)
    return calc.compute_all_metrics()
