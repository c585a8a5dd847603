from tpu_unet_torch.metrics.anomaly import anomaly_error_map, anomaly_score
from tpu_unet_torch.metrics.binary import calculate_metrics, calculate_pixel_metrics
from tpu_unet_torch.metrics.confusion import (
    SegmentationMetrics,
    compute_metrics_from_predictions,
    confusion_matrix_batch,
)
from tpu_unet_torch.metrics.curves import (
    auc,
    auprc,
    auroc,
    get_optimal_threshold,
    precision_recall_curve,
)

__all__ = [
    "anomaly_error_map",
    "anomaly_score",
    "calculate_metrics",
    "calculate_pixel_metrics",
    "SegmentationMetrics",
    "compute_metrics_from_predictions",
    "confusion_matrix_batch",
    "auc",
    "auprc",
    "auroc",
    "get_optimal_threshold",
    "precision_recall_curve",
]
