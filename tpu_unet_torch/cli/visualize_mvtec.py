#!/usr/bin/env python3
"""Visualize MVTec anomaly-detection results on the GPU (counterpart of
``tpu_unet/cli/visualize_mvtec.py``: the same flags and figures).

Renders one row per test sample (original | ground truth in red | predicted
anomaly map | reconstruction | reconstruction error), eight rows per PNG
(``<category>_panel_NNN.png``), or with ``--interactive`` a matplotlib
browser with Previous/Next/Info buttons and the left/right/``i`` keys. The
checkpoint is ``--checkpoint``, else the newest experiment of the category
under ``--outputs_dir`` (:func:`discover_checkpoint`).

``main`` runs two halves. :func:`collect_records` loads the model and runs
the eval step on the device (``eval_transform`` is kernel K1 on CUDA, once
per batch) and needs no matplotlib; :func:`render` draws the records with
matplotlib (imported when it renders). Runs on ``cuda`` unless
``--device cpu``.

Example:
  python -m tpu_unet_torch.cli.visualize_mvtec --data_root datasets/mvtec \\
      --category bottle --outputs_dir outputs --output_dir visualizations
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_unet_torch.cli._seg_common import cli_device
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.data.mvtec import MVTecDataset
from tpu_unet_torch.models import build_model
from tpu_unet_torch.train.checkpoint import find_best_checkpoint, load_params
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import make_anomaly_eval_step
from tpu_unet_torch.utils.viz import _plt, denormalize_image


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Visualize MVTec anomaly results")
    parser.add_argument("--data_root", type=str, default="../datasets/mvtec_anomaly_detection")
    parser.add_argument("--category", type=str, default="bottle")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--model", type=str, default="anomaly_unet",
                        choices=["unet", "anomaly_unet"])
    parser.add_argument("--bilinear", action="store_true")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Checkpoint path (default: auto-discover under --outputs_dir)")
    parser.add_argument("--outputs_dir", type=str, default="../outputs",
                        help="Directory walked for checkpoint auto-discovery")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--output_dir", type=str, default="../visualizations")
    parser.add_argument("--max_samples", type=int, default=16)
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Data-parallel devices (not ported yet: 1 only)")
    parser.add_argument("--base_features", type=int, default=64)
    parser.add_argument("--interactive", action="store_true",
                        help="open the Previous/Next/Info matplotlib browser "
                             "instead of writing batch PNGs")
    return parser.parse_args(argv)


def discover_checkpoint(outputs_dir: str, category: str,
                        model: Optional[str] = None) -> Optional[str]:
    """The checkpoint (``train/checkpoint.py::find_best_checkpoint``) of the
    newest experiment directory of ``category`` under ``outputs_dir``, by
    mtime: experiment names are '{category}_{model}_{timestamp}', so a sort
    by name would rank the model name before the time. With ``model``, its
    experiments come first, so the weights fit the model built."""
    candidates = []  # (matches_model, mtime, checkpoint)
    if os.path.isdir(outputs_dir):
        for name in os.listdir(outputs_dir):
            if name.startswith(category):
                exp_dir = os.path.join(outputs_dir, name)
                ckpt = find_best_checkpoint(exp_dir)
                if ckpt:
                    matches = bool(model) and name.startswith(f"{category}_{model}_")
                    candidates.append((matches, os.path.getmtime(exp_dir), ckpt))
    if not candidates:
        return None
    return max(candidates)[2]


def render_panel(ax_row, image, mask_true, anomaly_map, reconstruction, error_map):
    img = denormalize_image(np.asarray(image))
    ax_row[0].imshow(img)
    ax_row[0].set_title("Original")
    overlay = img.copy()
    overlay[np.asarray(mask_true) > 0.5] = [1.0, 0.0, 0.0]
    ax_row[1].imshow(overlay)
    ax_row[1].set_title("GT overlay (red)")
    ax_row[2].imshow(np.asarray(anomaly_map), cmap="hot", vmin=0, vmax=1)
    ax_row[2].set_title("Predicted map")
    ax_row[3].imshow(np.clip(np.asarray(reconstruction), 0, 1))
    ax_row[3].set_title("Reconstruction")
    ax_row[4].imshow(np.asarray(error_map), cmap="viridis")
    ax_row[4].set_title("Recon error")
    for ax in ax_row:
        ax.axis("off")


class AnomalyBrowser:
    """Interactive browser over collected records: Previous/Next/Info
    buttons and the arrow keys (navigation wraps), the panel of
    :func:`render_panel`, and Info printing the sample's metadata."""

    def __init__(self, records, plt):
        if not records:
            raise ValueError("no samples to browse")
        self.records = records
        self.idx = 0
        self.plt = plt
        self.fig, axes = plt.subplots(1, 5, figsize=(20, 4.4))
        self.axes = list(np.atleast_1d(axes).ravel())
        from matplotlib.widgets import Button

        self.fig.subplots_adjust(bottom=0.2)
        self._buttons = []
        for label, x, cb in (("Previous", 0.30, lambda e: self.prev()),
                             ("Next", 0.45, lambda e: self.next()),
                             ("Info", 0.60, lambda e: self.info())):
            ax = self.fig.add_axes([x, 0.04, 0.1, 0.07])
            b = Button(ax, label)
            b.on_clicked(cb)
            self._buttons.append(b)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self.show_current()

    def _on_key(self, event):
        if event.key in ("right", "n"):
            self.next()
        elif event.key in ("left", "p"):
            self.prev()
        elif event.key == "i":
            self.info()

    def show_current(self):
        r = self.records[self.idx]
        for ax in self.axes:
            ax.clear()
        render_panel(self.axes, r["image"], r["mask"], r["anomaly_map"],
                     r["reconstruction"], r["error_map"])
        self.fig.suptitle(
            f"Sample {self.idx + 1}/{len(self.records)}  "
            f"type={r['anomaly_type']}  score={r['score']:.5f}", fontsize=13)
        self.fig.canvas.draw_idle()

    def next(self):
        self.idx = (self.idx + 1) % len(self.records)
        self.show_current()

    def prev(self):
        self.idx = (self.idx - 1) % len(self.records)
        self.show_current()

    def info(self):
        r = self.records[self.idx]
        print(f"\nSample {self.idx + 1}/{len(self.records)}")
        print(f"  path:         {r['image_path']}")
        print(f"  anomaly type: {r['anomaly_type']}")
        print(f"  label:        {'anomalous' if r['label'] else 'normal'}")
        print(f"  image score:  {r['score']:.6f}")
        print(f"  GT defect px: {int((r['mask'] > 0.5).sum())}")

    def show(self):
        self.plt.show()


def load_state(args, device: torch.device):
    """The model of ``args`` with ``args.checkpoint``'s weights on ``device``."""
    model = build_model(args.model, n_channels=3, n_classes=1, bilinear=args.bilinear,
                        policy=get_policy(args.precision), base_features=args.base_features)
    state = create_train_state(model, "adam", 1e-3, 0.0, device=device)
    return load_params(state, args.checkpoint)


def collect_records(args, device: torch.device, ds=None) -> List[Dict]:
    """The first ``--max_samples`` test samples' records, in the loader's
    order: the eval step's ``image``, ``anomaly_map``, ``reconstruction``,
    ``error_map`` and ``score`` with the sample's mask, label, type and path,
    on the host. ``ds`` defaults to the category's test split. The eval step
    runs once per batch of ``--batch_size``; no matplotlib."""
    if ds is None:
        ds = MVTecDataset(args.data_root, args.category, "test", args.image_size,
                          is_train=False)
    loader = DataLoader(ds, args.batch_size, pad_last=True, num_workers=args.num_workers,
                        transform=lambda b: to_device(b, device))
    state = load_state(args, device)
    eval_step = make_anomaly_eval_step(dual_decoder=(args.model == "anomaly_unet"))
    records: List[Dict] = []
    for batch in loader:
        if len(records) >= args.max_samples:
            break
        out = eval_step(state, batch["image"], batch["mask"])
        host = {k: out[k].cpu().numpy() for k in
                ("image", "anomaly_map", "reconstruction", "error_map", "score")}
        masks = batch["mask"][..., 0].cpu().numpy()
        labels = batch["label"].cpu().numpy()
        valid = (batch["valid"].cpu().numpy().astype(bool) if "valid" in batch
                 else np.ones(len(labels), bool))
        for i in range(len(valid)):
            if not valid[i] or len(records) >= args.max_samples:
                continue
            records.append({
                "image": host["image"][i],
                "mask": masks[i],
                "anomaly_map": host["anomaly_map"][i],
                "reconstruction": host["reconstruction"][i],
                "error_map": host["error_map"][i],
                "score": float(host["score"][i]),
                "label": int(labels[i]),
                "anomaly_type": batch["anomaly_type"][i],
                "image_path": batch["image_path"][i],
            })
    return records


def render(args, records: List[Dict]):
    """The batch PNGs of ``records`` under ``--output_dir`` (returns the
    directory), or with ``--interactive`` the browser (returned after its
    window closes)."""
    plt = _plt()
    if args.interactive:
        if not records:
            print("No samples to browse (empty test split?)")
            return None
        browser = AnomalyBrowser(records, plt)
        print("Interactive browser: Previous/Next/Info buttons, "
              "arrow keys + 'i' for info, close the window to exit.")
        browser.show()
        return browser

    os.makedirs(args.output_dir, exist_ok=True)
    per_fig = 8
    for start in range(0, len(records), per_fig):
        chunk = records[start:start + per_fig]
        fig, axes = plt.subplots(len(chunk), 5, figsize=(20, 3.2 * len(chunk)),
                                 squeeze=False)
        for row, r in enumerate(chunk):
            render_panel(axes[row], r["image"], r["mask"], r["anomaly_map"],
                         r["reconstruction"], r["error_map"])
            axes[row][0].set_ylabel(r["anomaly_type"])
        fig.tight_layout()
        path = os.path.join(args.output_dir, f"{args.category}_panel_{start:03d}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"Saved {path}")
    print(f"Rendered {len(records)} sample panels to {args.output_dir}")
    return args.output_dir


def main(argv=None):
    args = parse_args(argv)
    if (args.n_devices or 1) > 1:
        raise NotImplementedError("--n_devices: multi-device runs are not ported yet; "
                                  "the port runs on one device")
    device = cli_device(args.device)
    args.checkpoint = args.checkpoint or discover_checkpoint(args.outputs_dir,
                                                             args.category, args.model)
    if args.checkpoint is None:
        print(f"No checkpoint found under {args.outputs_dir} for '{args.category}'")
        return None
    print(f"Using checkpoint: {args.checkpoint}")
    return render(args, collect_records(args, device))


if __name__ == "__main__":
    main()
