#!/usr/bin/env python3
"""MVTec sweep on the GPU: train and test every category, aggregate a summary
(counterpart of ``tpu_unet/cli/sweep_mvtec.py``).

For each category found under ``--data_root`` (or each of ``--categories``)
this runs the train CLI, then the test CLI on the run's ``best_model.pth``,
and writes ``sweep_summary.json`` with per-category image, pixel and
per-anomaly-type metrics and the mean image AUROC and AUPRC. Runs on
``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpu_unet_torch.data.mvtec import get_available_categories
from tpu_unet_torch.utils.io import save_json


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="MVTec all-category sweep")
    parser.add_argument("--data_root", type=str, default="../datasets/mvtec_anomaly_detection")
    parser.add_argument("--categories", type=str, nargs="*", default=None,
                        help="Subset of categories (default: all found)")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--model", type=str, default="anomaly_unet",
                        choices=["unet", "anomaly_unet"])
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--optimizer", type=str, default="adam")
    parser.add_argument("--scheduler", type=str, default="cosine")
    parser.add_argument("--use_ssim", action="store_true")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save_dir", type=str, default="../outputs")
    parser.add_argument("--output_dir", type=str, default="../sweep_results")
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--base_features", type=int, default=64)
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Data-parallel ranks of each train and test run "
                             "(passed through)")
    parser.add_argument("--device", type=str, default="cuda", choices=["auto", "cuda", "cpu"])
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--debug_samples", type=int, default=20)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from tpu_unet_torch.cli.test_mvtec import main as test_main
    from tpu_unet_torch.cli.train_mvtec import main as train_main

    categories = args.categories or get_available_categories(args.data_root)
    if not categories:
        print(f"No categories found under {args.data_root}")
        return None
    print(f"Sweeping {len(categories)} categories: {categories}")

    os.makedirs(args.output_dir, exist_ok=True)
    summary = {"args": vars(args), "categories": {}}

    for category in categories:
        print(f"\n{'=' * 60}\n=== {category} ===\n{'=' * 60}")
        common = ["--data_root", args.data_root, "--category", category,
                  "--image_size", str(args.image_size), "--model", args.model,
                  "--batch_size", str(args.batch_size),
                  "--num_workers", str(args.num_workers),
                  "--precision", args.precision,
                  "--base_features", str(args.base_features), "--device", args.device]
        if args.n_devices:
            common += ["--n_devices", str(args.n_devices)]
        if args.debug:
            common += ["--debug", "--debug_samples", str(args.debug_samples)]
        train_argv = common + [
            "--epochs", str(args.epochs),
            "--learning_rate", str(args.learning_rate),
            "--optimizer", args.optimizer, "--scheduler", args.scheduler,
            "--seed", str(args.seed), "--save_dir", args.save_dir,
        ]
        if args.use_ssim:
            train_argv.append("--use_ssim")
        exp_dir = train_main(train_argv)
        if exp_dir is None:
            summary["categories"][category] = {"error": "training failed"}
            continue
        best = os.path.join(exp_dir, "checkpoints", "best_model.pth")
        evaluation = test_main(common + [
            "--checkpoint", best,
            "--output_dir", os.path.join(args.output_dir, "per_category"),
        ])
        summary["categories"][category] = {
            "experiment_dir": exp_dir,
            "image_metrics": evaluation["image_metrics"],
            "pixel_metrics": evaluation["pixel_metrics"],
            "type_metrics": evaluation["type_metrics"],
        }

    aurocs = [c["image_metrics"]["auroc"] for c in summary["categories"].values()
              if "image_metrics" in c]
    auprcs = [c["image_metrics"]["auprc"] for c in summary["categories"].values()
              if "image_metrics" in c]
    summary["mean_image_auroc"] = float(np.mean(aurocs)) if aurocs else None
    summary["mean_image_auprc"] = float(np.mean(auprcs)) if auprcs else None

    save_json(summary, os.path.join(args.output_dir, "sweep_summary.json"))
    print(f"\nSweep complete. Mean image AUROC: {summary['mean_image_auroc']}")
    print(f"Summary: {os.path.join(args.output_dir, 'sweep_summary.json')}")
    return summary


if __name__ == "__main__":
    main()
