#!/usr/bin/env python3
"""Train SegmentationUNet on the Gear multi-class defect dataset on the GPU
(counterpart of ``tpu_unet/cli/train_gear.py``: the same flags, defaults and
files).

seg_unet, 512², 50 epochs, batch 8, Adam 1e-3 with weight decay 1e-4, CE +
Dice, ``--class_weights`` as comma-separated values, dropout 0.1, no LR
schedule; the paired augment rotates up to 10 degrees and jitters 0.2 / 0.2 /
0.2 / 0.1. Experiment directories are ``<save_dir>/gear_seg_{model}_{%Y%m%d_%H%M%S}``
(``cli/_seg_common.py`` lists their files).

Runs on ``cuda`` (``--device auto`` means ``cuda``) unless ``--device cpu``.

Example:
  python -m tpu_unet_torch.cli.train_gear --data_root datasets/Gear --epochs 50
"""

from __future__ import annotations

import argparse

from tpu_unet_torch.cli._seg_common import Workload, run_seg_training
from tpu_unet_torch.train.steps import AugmentConfig


def add_common_args(parser):
    """The flags both seg trainers share."""
    parser.add_argument("--model", type=str, default="seg_unet",
                        choices=["unet", "seg_unet", "unetpp", "attn_unet"],
                        help="Model architecture")
    parser.add_argument("--bilinear", action="store_true",
                        help="Bilinear upsampling instead of transposed convolution")
    parser.add_argument("--deep_supervision", action="store_true",
                        help="UNet++ only: one head per top-row node")
    parser.add_argument("--dropout", type=float, default=0.1,
                        help="Dropout rate for segmentation UNet")
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "adamw", "sgd"])
    parser.add_argument("--ce_weight", type=float, default=1.0)
    parser.add_argument("--dice_weight", type=float, default=1.0)
    parser.add_argument("--focal_weight", type=float, default=0.0)
    parser.add_argument("--num_workers", type=int, default=4,
                        help="Number of data loading threads")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["auto", "cuda", "cpu"],
                        help="Device to use ('auto' means cuda)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save_dir", type=str, default="outputs")
    parser.add_argument("--save_freq", type=int, default=10)
    parser.add_argument("--resume", type=str, default=None,
                        help="Path to a .pth checkpoint to resume from")
    parser.add_argument("--val_freq", type=int, default=5)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--debug_samples", type=int, default=20)
    # Extras of the JAX package
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Data-parallel ranks, one per GPU (default: all "
                             "visible GPUs; 1 on the CPU)")
    parser.add_argument("--n_space", type=int, default=1,
                        help="Shard image height over this many ranks per data rank "
                             "(halo exchanges at every 3x3 conv; the height must be "
                             "a multiple of 16 x n_space)")
    parser.add_argument("--base_features", type=int, default=64)
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd.set_detect_anomaly (fail fast on NaN)")
    parser.add_argument("--rotation_mode", type=str, default="per_batch_shear",
                        choices=["per_sample", "per_sample_shear", "per_batch_shear"],
                        help="Rotation augmentation: one angle per batch through "
                             "shear matmuls (default, fast), per-sample banded "
                             "shears, or per-sample gathers (reference numerics)")
    parser.add_argument("--color_jitter_random_order", action="store_true",
                        help="Randomize the ColorJitter op order per step "
                             "(torchvision semantics)")
    parser.add_argument("--progress_every", type=int, default=10,
                        help="Intra-epoch progress line every N steps (0 disables)")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Gradient accumulation microbatches per step: "
                             "--batch_size is the EFFECTIVE batch, run as "
                             "grad_accum sequential microbatches")
    parser.add_argument("--fsdp", action="store_true",
                        help="Shard params and optimizer state over the data ranks "
                             "(FSDP2)")
    parser.add_argument("--n_model", type=int, default=1,
                        help="Tensor (model) parallelism: shard conv channels over "
                             "this many ranks per data rank (Megatron column/row "
                             "pattern on each DoubleConv; one all-reduce per "
                             "block). Total ranks = n_devices * n_space * n_model")
    parser.add_argument("--multihost", action="store_true",
                        help="Join a torchrun or SLURM launch from its environment")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="Manual multi-host launch: host:port of rank 0")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Manual multi-host launch: total process count")
    parser.add_argument("--process_id", type=int, default=None,
                        help="Manual multi-host launch: this process's index")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train UNet for Gear multi-class segmentation")
    parser.add_argument("--data_root", type=str, default="datasets/Gear")
    parser.add_argument("--image_size", type=int, default=512,
                        help="Input image size (both height and width)")
    parser.add_argument("--class_weights", type=str, default=None,
                        help='Class weights as comma-separated values (e.g., "1.0,2.0,1.5")')
    add_common_args(parser)
    return parser.parse_args(argv)


def _datasets(args):
    from tpu_unet_torch.data.gear import get_datasets
    train, val, test, num_classes = get_datasets(args.data_root, _size_hw(args))
    return train, val, test, num_classes, ["background"] + train.class_names


def _size_hw(args):
    return (args.image_size, args.image_size)


def make_workload() -> Workload:
    # Module-level functions: a workload is pickled to data-parallel ranks.
    return Workload(
        name="gear_seg",
        make_datasets=_datasets,
        image_size_hw=_size_hw,
        # The reference's Gear augment, applied to image and mask together.
        augment=AugmentConfig(degrees=10.0, brightness=0.2, contrast=0.2,
                              saturation=0.2, hue=0.1),
    )


def main(argv=None):
    return run_seg_training(parse_args(argv), make_workload())


if __name__ == "__main__":
    main()
