#!/usr/bin/env python3
"""Evaluate a Gear segmentation checkpoint on the GPU (counterpart of
``tpu_unet/cli/test_gear.py``: the same flags and files).

Writes ``evaluation_results.json`` (overall and per-class metrics, the
confusion matrix and the loss) and ``confusion_matrix.png`` under
``--output_dir``, and with ``--save_predictions`` up to 4 prediction panels
for each of the first 5 batches. ``--fold_bn`` folds BatchNorm into the
convs; ``--quantize int8`` calibrates int8 scales on the first
``--calib_samples`` train images and runs every 3x3 conv through kernel K2.

Runs on ``cuda`` (``--device auto`` means ``cuda``) unless ``--device cpu``.

Example:
  python -m tpu_unet_torch.cli.test_gear --data_root datasets/Gear \\
      --checkpoint outputs/<exp>/checkpoints/best_model.pth --quantize int8
"""

from __future__ import annotations

import argparse

from tpu_unet_torch.cli._seg_common import run_seg_evaluation
from tpu_unet_torch.cli.train_gear import make_workload


def add_eval_args(parser, class_weights, output_dir):
    """The flags both seg evaluators share; the defaults of
    ``--class_weights`` and ``--output_dir`` are the dataset's."""
    parser.add_argument("--model", type=str, default="seg_unet",
                        choices=["unet", "seg_unet", "unetpp", "attn_unet"],
                        help="Model architecture")
    parser.add_argument("--bilinear", action="store_true",
                        help="Bilinear decoders")
    parser.add_argument("--deep_supervision", action="store_true",
                        help="UNet++ only: one head per top-row node")
    parser.add_argument("--heads", type=int, default=4,
                        help="UNet++ deep-supervision inference head: 4 averages "
                             "the four heads, k < 4 evaluates head X[0][k] alone")
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="A .pth checkpoint (reference layout or a bare state_dict)")
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "val", "test"])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda", choices=["auto", "cuda", "cpu"])
    parser.add_argument("--class_weights", type=str, default=class_weights)
    parser.add_argument("--save_dir", "--output_dir", dest="output_dir",
                        type=str, default=output_dir)
    parser.add_argument("--save_confusion_matrix", action="store_true",
                        help="Reference-CLI compatibility; the confusion-matrix "
                             "PNG is always saved here")
    parser.add_argument("--save_predictions", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--debug_samples", type=int, default=50)
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Data-parallel ranks, one per GPU (default: all "
                             "visible GPUs; 1 on the CPU)")
    parser.add_argument("--n_space", type=int, default=1,
                        help="Shard image height over this many ranks per data rank "
                             "(halo exchanges at every 3x3 conv; the height must be "
                             "a multiple of 16 x n_space)")
    parser.add_argument("--base_features", type=int, default=64)
    parser.add_argument("--fold_bn", action="store_true",
                        help="Fold BatchNorm into conv weights for inference")
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "int8"],
                        help="int8 post-training quantization for inference "
                             "(activation scales calibrated on the train split)")
    parser.add_argument("--calib_samples", type=int, default=32,
                        help="Calibration images for --quantize int8")
    parser.add_argument("--calib_percentile", type=float, default=None,
                        help="Outlier-robust percentile calibration (e.g. 99.9)")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate UNet on Gear dataset")
    parser.add_argument("--data_root", type=str, default="datasets/Gear")
    parser.add_argument("--image_size", type=int, default=512)
    add_eval_args(parser, class_weights=None, output_dir="test_results/gear")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return run_seg_evaluation(args, make_workload(), split=args.split)


if __name__ == "__main__":
    main()
