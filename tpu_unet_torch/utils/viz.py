"""Host-side visualization renderers, matplotlib with the Agg backend
(counterpart of ``tpu_unet/utils/viz.py``), on NHWC numpy arrays fetched
from the device. matplotlib is imported on first use only."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from tpu_unet_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """Undo ImageNet normalization on an (H, W, 3) array, clip to [0, 1]."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return np.clip(img * std + mean, 0.0, 1.0)


def visualize_results(images, masks_true, masks_pred, reconstructions=None,
                      save_path: Optional[str] = None, max_samples: int = 8):
    """3-4 column panel: original | true mask | predicted map [| reconstruction]."""
    plt = _plt()
    n = min(len(images), max_samples)
    n_cols = 4 if reconstructions is not None else 3
    fig, axes = plt.subplots(n, n_cols, figsize=(n_cols * 4, n * 3))
    axes = np.atleast_2d(axes)
    if axes.shape[0] == 1 and n == 1:
        axes = axes.reshape(1, -1)
    for i in range(n):
        axes[i, 0].imshow(denormalize_image(np.asarray(images[i])))
        axes[i, 0].set_title("Original")
        axes[i, 0].axis("off")
        axes[i, 1].imshow(np.asarray(masks_true[i]).squeeze(), cmap="gray")
        axes[i, 1].set_title("True Mask")
        axes[i, 1].axis("off")
        axes[i, 2].imshow(np.asarray(masks_pred[i]).squeeze(), cmap="hot")
        axes[i, 2].set_title("Predicted Mask")
        axes[i, 2].axis("off")
        if reconstructions is not None:
            axes[i, 3].imshow(np.clip(np.asarray(reconstructions[i]), 0, 1))
            axes[i, 3].set_title("Reconstruction")
            axes[i, 3].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        print(f"Visualization saved to {save_path}")
    plt.close(fig)


def plot_training_curves(train_losses: Sequence[float],
                         val_losses: Optional[Sequence[float]] = None,
                         save_path: Optional[str] = None):
    plt = _plt()
    fig = plt.figure(figsize=(10, 6))
    epochs = range(1, len(train_losses) + 1)
    plt.plot(epochs, train_losses, "b-", label="Training Loss")
    if val_losses:
        plt.plot(range(1, len(val_losses) + 1), val_losses, "r-", label="Validation Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title("Training Curves")
    plt.legend()
    plt.grid(True)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        print(f"Training curves saved to {save_path}")
    plt.close(fig)


def plot_confusion_matrix(y_true, y_pred, class_names=("Normal", "Anomaly"),
                          save_path: Optional[str] = None):
    plt = _plt()
    y_true = np.asarray(y_true, int).ravel()
    y_pred = np.asarray(y_pred, int).ravel()
    n = len(class_names)
    cm = np.zeros((n, n), np.int64)
    for t, p in zip(y_true, y_pred):
        if 0 <= t < n and 0 <= p < n:
            cm[t, p] += 1
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(n), class_names)
    ax.set_yticks(range(n), class_names)
    for i in range(n):
        for j in range(n):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > cm.max() / 2 else "black")
    ax.set_xlabel("Predicted")
    ax.set_ylabel("Actual")
    ax.set_title("Confusion Matrix")
    fig.colorbar(im)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        print(f"Confusion matrix saved to {save_path}")
    plt.close(fig)


def overlay_segmentation(image: np.ndarray, mask: np.ndarray,
                         colors: Optional[np.ndarray] = None,
                         alpha: float = 0.5) -> np.ndarray:
    """Blend a class-coloured (H, W) label map over a normalized (H, W, 3)
    image, denormalized first (the reference's Gear overlays); float [0, 1]."""
    if colors is None:
        colors = np.asarray([
            [0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255],
            [255, 255, 0], [255, 0, 255], [0, 255, 255],
        ], np.float32) / 255.0
    img = denormalize_image(image)
    out = img.copy()
    for cls in np.unique(mask):
        if cls == 0:
            continue
        sel = mask == cls
        out[sel] = (1 - alpha) * img[sel] + alpha * colors[int(cls) % len(colors)]
    return out
