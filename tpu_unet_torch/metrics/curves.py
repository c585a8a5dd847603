"""Threshold-sweep curves: AUROC, AUPRC, the PR curve and the optimal
threshold (counterpart of ``tpu_unet/metrics/curves.py``, with the same
arithmetic, so both packages give identical numbers, ties included).

Host-side numpy with sklearn's numerics, sort-based, O(n log n):

- auroc: the Mann-Whitney rank statistic with tie correction, equal to the
  trapezoidal area under the full ROC curve;
- precision_recall_curve: sklearn's semantics (distinct-score thresholds,
  the (1, 0) end point appended, arrays in decreasing-recall order);
- auprc: trapezoidal auc(recall, precision), as the reference computes it
  (``sklearn.metrics.auc``, not average precision);
- get_optimal_threshold: the threshold that maximizes F1 over the PR curve.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rankdata_average(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based) with ties sharing the mean rank.

    The JAX package's copy loops over the tied groups in Python, which takes
    seconds for pixel-level scores (millions of distinct values); here each
    group's rank is the same expression, evaluated for all groups at once.
    """
    order = np.argsort(x, kind="mergesort")
    sx = x[order]
    boundaries = np.flatnonzero(np.r_[True, sx[1:] != sx[:-1], True])
    start, stop = boundaries[:-1], boundaries[1:]
    ranks = np.empty(len(x), dtype=np.float64)
    ranks[order] = np.repeat(0.5 * (start + stop - 1) + 1.0, stop - start)
    return ranks


def auroc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve. Raises ValueError if only one class is
    present (as sklearn does; ``calculate_metrics`` maps it to 0.0)."""
    y_true = np.asarray(y_true).astype(np.int64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined.")
    ranks = _rankdata_average(y_score)
    return float((ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Cumulative TPs/FPs at each distinct score threshold (descending scores)."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    desc = np.argsort(-y_score, kind="mergesort")
    y_score = y_score[desc]
    y_true = y_true[desc]
    distinct = np.flatnonzero(np.diff(y_score)) if len(y_score) > 1 else np.array([], dtype=int)
    threshold_idxs = np.r_[distinct, len(y_true) - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, y_score[threshold_idxs]


def precision_recall_curve(y_true: np.ndarray, y_score: np.ndarray):
    """sklearn-compatible PR curve: (precision, recall, thresholds)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps > 0)
    if tps[-1] == 0:
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    # Recall decreasing, with the (precision=1, recall=0) end point appended.
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1])


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under y(x); x increasing or decreasing (sklearn.auc)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    dx = np.diff(x)
    if np.all(dx <= 0):
        sign = -1.0
    elif np.all(dx >= 0):
        sign = 1.0
    else:
        raise ValueError("x is neither increasing nor decreasing.")
    return float(sign * np.trapezoid(y, x)) if hasattr(np, "trapezoid") else float(sign * np.trapz(y, x))


def auprc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """auc(recall, precision), the reference's AUPRC."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return auc(recall, precision)


def get_optimal_threshold(y_true: np.ndarray, y_score: np.ndarray) -> Tuple[float, float]:
    """The threshold that maximizes F1 over the PR curve; returns
    (threshold, best_f1)."""
    precision, recall, thresholds = precision_recall_curve(y_true, y_score)
    f1 = 2 * (precision * recall) / (precision + recall + 1e-8)
    idx = int(np.argmax(f1))
    threshold = float(thresholds[idx]) if idx < len(thresholds) else 0.5
    return threshold, float(f1[idx])
