#!/usr/bin/env python3
"""Train SegmentationUNet on KolektorSDD surface defects on the GPU
(counterpart of ``tpu_unet/cli/train_kolektorsdd.py``: the same flags,
defaults and files).

1024 x 512 inputs, class weights ``1.0,50.0,50.0`` by default, the split
fractions as flags, a gentler paired augment (5 degrees, jitter 0.1 / 0.1 /
0.1 / 0.05); the other flags are ``train_gear.add_common_args``'.
Experiment directories are ``<save_dir>/kolektorsdd_{model}_{%Y%m%d_%H%M%S}``.

Runs on ``cuda`` (``--device auto`` means ``cuda``) unless ``--device cpu``.

Example:
  python -m tpu_unet_torch.cli.train_kolektorsdd --data_root datasets/KolektorSDD
"""

from __future__ import annotations

import argparse

from tpu_unet_torch.cli._seg_common import Workload, run_seg_training
from tpu_unet_torch.cli.train_gear import add_common_args
from tpu_unet_torch.train.steps import AugmentConfig


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train UNet for KolektorSDD defect detection")
    parser.add_argument("--data_root", type=str, default="datasets/KolektorSDD")
    parser.add_argument("--image_height", type=int, default=1024)
    parser.add_argument("--image_width", type=int, default=512)
    parser.add_argument("--train_split", type=float, default=0.7)
    parser.add_argument("--val_split", type=float, default=0.15)
    parser.add_argument("--class_weights", type=str, default="1.0,50.0,50.0",
                        help="Class weights for [background, defect_type_1, defect_type_2]")
    add_common_args(parser)
    return parser.parse_args(argv)


def _datasets(args):
    from tpu_unet_torch.data.kolektorsdd import CLASS_NAMES, get_datasets
    train, val, test, num_classes = get_datasets(
        args.data_root, _size_hw(args), args.train_split, args.val_split)
    return train, val, test, num_classes, list(CLASS_NAMES)


def _size_hw(args):
    return (args.image_height, args.image_width)


def make_workload() -> Workload:
    # Module-level functions: a workload is pickled to data-parallel ranks.
    return Workload(
        name="kolektorsdd",
        make_datasets=_datasets,
        image_size_hw=_size_hw,
        # The reference's KolektorSDD augment, applied to image and mask together.
        augment=AugmentConfig(degrees=5.0, brightness=0.1, contrast=0.1,
                              saturation=0.1, hue=0.05),
    )


def main(argv=None):
    return run_seg_training(parse_args(argv), make_workload())


if __name__ == "__main__":
    main()
