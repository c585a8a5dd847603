"""Binary (image-level and pixel-level) anomaly metrics (counterpart of
``tpu_unet/metrics/binary.py``): accuracy, precision, recall, specificity and
F1 from the confusion counts, plus AUROC and AUPRC when scores are given, with
the reference's ValueError -> 0.0 fallback."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tpu_unet_torch.metrics.curves import auprc, auroc


def calculate_metrics(y_true, y_pred, y_scores: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Binary classification metrics from hard predictions (and optional scores)."""
    y_true = np.asarray(y_true, dtype=int).ravel()
    y_pred = np.asarray(y_pred, dtype=int).ravel()

    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))

    metrics: Dict[str, float] = {}
    total = tp + tn + fp + fn
    metrics["accuracy"] = (tp + tn) / total if total > 0 else 0.0
    metrics["precision"] = tp / (tp + fp) if (tp + fp) > 0 else 0
    metrics["recall"] = tp / (tp + fn) if (tp + fn) > 0 else 0
    metrics["specificity"] = tn / (tn + fp) if (tn + fp) > 0 else 0
    pr = metrics["precision"] + metrics["recall"]
    metrics["f1_score"] = 2 * metrics["precision"] * metrics["recall"] / pr if pr > 0 else 0

    if y_scores is not None:
        try:
            scores = np.asarray(y_scores, dtype=np.float64).ravel()
            metrics["auroc"] = auroc(y_true, scores)
            metrics["auprc"] = auprc(y_true, scores)
        except ValueError:
            metrics["auroc"] = 0.0
            metrics["auprc"] = 0.0

    return metrics


def calculate_pixel_metrics(y_true_masks, y_pred_masks, threshold: float = 0.5) -> Dict[str, float]:
    """Pixel-level metrics: ground truth binarized at 0.5, predictions at
    ``threshold``; the scores are the raw prediction map."""
    y_true_binary = (np.asarray(y_true_masks) > 0.5).astype(np.uint8)
    y_pred = np.asarray(y_pred_masks)
    y_pred_binary = (y_pred > threshold).astype(np.uint8)
    return calculate_metrics(y_true_binary.ravel(), y_pred_binary.ravel(), y_pred.ravel())
