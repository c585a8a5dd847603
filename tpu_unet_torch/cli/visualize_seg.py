#!/usr/bin/env python3
"""Visualize segmentation results for Gear and KolektorSDD on the GPU
(counterpart of ``tpu_unet/cli/visualize_seg.py``: the same flags and
figures).

For the first ``--num_samples`` images of a split: a stats line each
(accuracy against the ground truth, the confidence's mean and spread);
individual panels ``prediction_NNN_<stem>.png`` (original | ground truth |
prediction | class-colored overlay [| ``--show_confidence``: the largest
softmax probability]); the ``predictions_grid.png`` overlays (ground truth
and prediction side by side); and ``class_distribution.png``, the pixel
share of each class in the ground truth and the predictions. With neither
``--save_individual`` nor ``--save_grid`` both are drawn; a selector alone
narrows to it, and ``--always_save`` draws both again.

Every model of ``build_model`` is accepted, UNet++ with
``--deep_supervision`` and ``--heads`` (k < 4: the pruned mode, head
X[0][k] alone). ``main`` runs two halves: :func:`collect_samples` runs
``eval_transform`` (kernel K1 on CUDA, once per batch), the model, the
softmax and the first-max argmax on the device and needs no matplotlib;
:func:`render` draws with matplotlib. Runs on ``cuda`` unless ``--device
cpu``.

Example:
  python -m tpu_unet_torch.cli.visualize_seg --dataset gear --data_root datasets/gear \\
      --checkpoint outputs/<exp>/checkpoints/best_model.pth --show_confidence
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np
import torch

from tpu_unet_torch.cli._seg_common import cli_device
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models.unet import check_model_flags
from tpu_unet_torch.ops.augment import eval_transform
from tpu_unet_torch.ops.seg_head import sliced_pred_confidence
from tpu_unet_torch.train.checkpoint import load_params
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.utils.viz import _plt, denormalize_image, overlay_segmentation


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Visualize segmentation results")
    parser.add_argument("--dataset", type=str, required=True,
                        choices=["gear", "kolektorsdd"])
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--image_size", type=int, default=512, help="(gear)")
    parser.add_argument("--image_height", type=int, default=1024, help="(kolektorsdd)")
    parser.add_argument("--image_width", type=int, default=512, help="(kolektorsdd)")
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "val", "test"])
    parser.add_argument("--model", type=str, default="seg_unet",
                        choices=["unet", "seg_unet", "unetpp", "attn_unet"])
    parser.add_argument("--bilinear", action="store_true")
    parser.add_argument("--deep_supervision", action="store_true",
                        help="UNet++ only: rebuild the deep-supervision heads "
                             "(must match how the checkpoint was trained)")
    parser.add_argument("--heads", type=int, default=4,
                        help="UNet++ deep-supervision inference mode: 4 = "
                             "averaged accurate mode; k<4 = the pruned fast "
                             "mode (single head X[0][k]; deeper columns do "
                             "not run)")
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save_dir", "--output_dir", dest="output_dir", type=str,
                        default=None, help="Default: derived from the checkpoint path")
    parser.add_argument("--num_samples", "--max_samples", dest="num_samples",
                        type=int, default=10,
                        help="Number of samples to visualize (the first N)")
    parser.add_argument("--save_individual", action="store_true",
                        help="Save individual prediction panels (only these when "
                             "given without --save_grid)")
    parser.add_argument("--save_grid", action="store_true",
                        help="Save a grid visualization (only this when given "
                             "without --save_individual)")
    parser.add_argument("--always_save", action="store_true",
                        help="Render both outputs regardless of the selectors "
                             "(also the default when neither selector is given)")
    parser.add_argument("--show_confidence", action="store_true",
                        help="Add the softmax max-prob confidence map to each panel")
    parser.add_argument("--figsize", type=float, nargs=2, default=[15, 5])
    parser.add_argument("--grid_size", type=int, nargs=2, default=[2, 5],
                        help="Grid rows x cols")
    parser.add_argument("--alpha", type=float, default=0.5, help="Overlay opacity")
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Data-parallel devices (not ported yet: 1 only)")
    parser.add_argument("--base_features", type=int, default=64)
    return parser.parse_args(argv)


def build_dataset(args):
    """(dataset, num_classes, class names, (H, W)) of ``--dataset``'s split."""
    if args.dataset == "gear":
        from tpu_unet_torch.data.gear import GearDataset
        size = (args.image_size, args.image_size)
        ds = GearDataset(args.data_root, args.split, size)
        return ds, ds.num_classes, ["background"] + ds.class_names, size
    from tpu_unet_torch.data.kolektorsdd import CLASS_NAMES, KolektorSDDDataset
    size = (args.image_height, args.image_width)
    ds = KolektorSDDDataset(args.data_root, args.split, size)
    return ds, ds.num_classes, list(CLASS_NAMES), size


def load_model(args, num_classes: int, device: torch.device) -> torch.nn.Module:
    """The model of ``args`` with ``--checkpoint``'s weights on ``device``,
    in eval mode. ``--heads k < 4`` builds UNet++'s pruned mode; the full
    parameter tree is loaded whatever ``heads``."""
    model = build_model(args.model, n_channels=3, n_classes=num_classes,
                        bilinear=args.bilinear, dropout=args.dropout,
                        policy=get_policy(args.precision), base_features=args.base_features,
                        deep_supervision=args.deep_supervision, heads=args.heads)
    state = load_params(create_train_state(model, "adam", 1e-3, 0.0, device=device),
                        args.checkpoint)
    if args.heads != 4:
        print(f"Pruned fast mode: visualizing head X[0][{args.heads}]")
    return state.model.eval()


def infer(model: torch.nn.Module, images_u8: torch.Tensor):
    """(preds (N, H, W) uint8, confidence (N, H, W) float32, normalized image
    (N, H, W, 3) float32) of a uint8 NHWC batch on the model's device:
    ``eval_transform``, the model, then the first-max argmax and the largest
    softmax probability of the logits."""
    with torch.no_grad():
        img = eval_transform(images_u8)
        logits = model(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        preds, conf = sliced_pred_confidence(logits)
    return preds, conf, img


def collect_samples(args, device: torch.device, ds=None) -> List[Dict]:
    """The first ``--num_samples`` samples of the split in the loader's
    order: ``image`` (normalized), ``mask``, ``pred``, ``conf`` and ``stem``,
    on the host. ``ds`` defaults to :func:`build_dataset`'s. One inference
    per batch of ``--batch_size``; no matplotlib."""
    if ds is None:
        ds, num_classes, _, _ = build_dataset(args)
    else:
        num_classes = ds.num_classes
    loader = DataLoader(ds, args.batch_size, pad_last=True, num_workers=args.num_workers,
                        transform=lambda b: to_device(b, device))
    model = load_model(args, num_classes, device)
    samples: List[Dict] = []
    for batch in loader:
        if len(samples) >= args.num_samples:
            break
        preds, conf, images = (t.cpu().numpy() for t in infer(model, batch["image"]))
        masks = batch["mask"].cpu().numpy()
        valid = (batch["valid"].cpu().numpy().astype(bool) if "valid" in batch
                 else np.ones(len(images), bool))
        for i in range(len(images)):
            if not valid[i] or len(samples) >= args.num_samples:
                continue
            samples.append({"image": images[i], "mask": masks[i], "pred": preds[i],
                            "conf": conf[i],
                            "stem": os.path.basename(batch["image_path"][i]).split(".")[0]})
    print(f"Collected {len(samples)} samples for visualization")
    return samples


def output_dir_of(args) -> str:
    return args.output_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(args.checkpoint))),
        "visualizations")


def render(args, samples: List[Dict], num_classes: int, class_names) -> str:
    """The stats lines and the figures of ``samples`` under the output
    directory (returned)."""
    plt = _plt()
    output_dir = output_dir_of(args)
    os.makedirs(output_dir, exist_ok=True)
    explicit = args.save_individual or args.save_grid
    do_individual = args.save_individual or args.always_save or not explicit
    do_grid = args.save_grid or args.always_save or not explicit

    gt_counts = np.zeros(num_classes, np.int64)
    pred_counts = np.zeros(num_classes, np.int64)
    rendered = 0
    for idx, s in enumerate(samples):
        gt_counts += np.bincount(s["mask"].ravel(), minlength=num_classes)
        pred_counts += np.bincount(s["pred"].ravel(), minlength=num_classes)
        acc = float((s["pred"] == s["mask"]).mean())
        print(f"Sample {idx + 1}: Accuracy={acc:.3f}, "
              f"Confidence={s['conf'].mean():.3f}±{s['conf'].std():.3f}")
        if not do_individual:
            continue
        ncols = 5 if args.show_confidence else 4
        fig, axes = plt.subplots(1, ncols, figsize=tuple(args.figsize))
        axes[0].imshow(denormalize_image(s["image"]))
        axes[0].set_title("Original")
        axes[1].imshow(s["mask"], cmap="tab10", vmin=0, vmax=num_classes - 1)
        axes[1].set_title("Ground Truth")
        axes[2].imshow(s["pred"], cmap="tab10", vmin=0, vmax=num_classes - 1)
        axes[2].set_title("Prediction")
        axes[3].imshow(overlay_segmentation(s["image"], s["pred"], alpha=args.alpha))
        axes[3].set_title(f"Overlay (conf {s['conf'].mean():.3f})")
        if args.show_confidence:
            im = axes[4].imshow(s["conf"], cmap="viridis", vmin=0, vmax=1)
            axes[4].set_title(f"Confidence (mean {s['conf'].mean():.3f})")
            fig.colorbar(im, ax=axes[4], fraction=0.046)
        for ax in axes:
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(output_dir, f"prediction_{idx:03d}_{s['stem']}.png"),
                    dpi=120, bbox_inches="tight")
        plt.close(fig)
        rendered += 1

    if samples and do_grid:
        gr, gc = args.grid_size
        n = min(len(samples), gr * gc)
        fig, axes = plt.subplots(gr, 2 * gc, figsize=(4 * gc, 2.5 * gr))
        axes = np.atleast_2d(axes)
        for k in range(gr * gc):
            r, c = divmod(k, gc)
            ax_gt, ax_pr = axes[r][2 * c], axes[r][2 * c + 1]
            if k < n:
                s = samples[k]
                ax_gt.imshow(overlay_segmentation(s["image"], s["mask"], alpha=args.alpha))
                ax_gt.set_title(f"Sample {k + 1}: GT", fontsize=9)
                ax_pr.imshow(overlay_segmentation(s["image"], s["pred"], alpha=args.alpha))
                ax_pr.set_title(f"Pred (conf {s['conf'].mean():.2f})", fontsize=9)
            ax_gt.axis("off")
            ax_pr.axis("off")
        fig.tight_layout()
        grid_path = os.path.join(output_dir, "predictions_grid.png")
        fig.savefig(grid_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"Grid visualization saved to {grid_path}")

    fig, ax = plt.subplots(figsize=(10, 6))
    x = np.arange(num_classes)
    width = 0.35
    ax.bar(x - width / 2, gt_counts / max(gt_counts.sum(), 1) * 100, width,
           label="Ground Truth")
    ax.bar(x + width / 2, pred_counts / max(pred_counts.sum(), 1) * 100, width,
           label="Prediction")
    ax.set_xticks(x, class_names, rotation=20)
    ax.set_ylabel("Pixel share (%)")
    ax.set_title(f"{args.dataset} class distribution "
                 f"({args.split}, first {len(samples)} samples)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, "class_distribution.png"), dpi=150,
                bbox_inches="tight")
    plt.close(fig)
    print(f"Rendered {rendered} panels + class distribution to {output_dir}")
    return output_dir


def main(argv=None):
    args = parse_args(argv)
    if (args.n_devices or 1) > 1:
        raise NotImplementedError("--n_devices: multi-device runs are not ported yet; "
                                  "the port runs on one device")
    check_model_flags(args.model, args.deep_supervision, args.heads)
    device = cli_device(args.device)
    ds, num_classes, class_names, _ = build_dataset(args)
    samples = collect_samples(args, device, ds)
    return render(args, samples, num_classes, class_names)


if __name__ == "__main__":
    main()
