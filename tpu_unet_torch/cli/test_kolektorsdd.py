#!/usr/bin/env python3
"""Evaluate a KolektorSDD segmentation checkpoint on the GPU (counterpart of
``tpu_unet/cli/test_kolektorsdd.py``: the same flags and files, those of
``cli/test_gear.py`` at 1024 x 512 with class weights ``1.0,50.0,50.0``).

Runs on ``cuda`` (``--device auto`` means ``cuda``) unless ``--device cpu``.

Example:
  python -m tpu_unet_torch.cli.test_kolektorsdd --data_root datasets/KolektorSDD \\
      --checkpoint outputs/<exp>/checkpoints/best_model.pth --fold_bn
"""

from __future__ import annotations

import argparse

from tpu_unet_torch.cli._seg_common import run_seg_evaluation
from tpu_unet_torch.cli.test_gear import add_eval_args
from tpu_unet_torch.cli.train_kolektorsdd import make_workload


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate UNet on KolektorSDD dataset")
    parser.add_argument("--data_root", type=str, default="datasets/KolektorSDD")
    parser.add_argument("--image_height", type=int, default=1024)
    parser.add_argument("--image_width", type=int, default=512)
    parser.add_argument("--train_split", type=float, default=0.7)
    parser.add_argument("--val_split", type=float, default=0.15)
    add_eval_args(parser, class_weights="1.0,50.0,50.0",
                  output_dir="test_results/kolektorsdd")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return run_seg_evaluation(args, make_workload(), split=args.split)


if __name__ == "__main__":
    main()
