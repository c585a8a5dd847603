"""Shared --quantize/--qparams/--calib_dir resolution for the serving CLI
(counterpart of ``tpu_unet/cli/_quant_common.py``).

An existing --qparams .npz (written by either package) is loaded and skips
calibration; otherwise int8 requires --calib_dir, and the freshly calibrated
scales are written to --qparams (when given) after the engine is built.
"""

from __future__ import annotations

import os

import numpy as np


def resolve_quantization(args, size_hw):
    """Map the CLI quantization flags to engine-constructor inputs:
    ``(quantize, calib_images, qparams_tree)``, where at most one of the last
    two is not None."""
    quantize = None if args.quantize == "none" else args.quantize
    if quantize != "int8":
        return quantize, None, None
    if args.qparams and os.path.exists(args.qparams):
        from tpu_unet_torch.ops.quantize import load_qparams
        qparams_tree = load_qparams(args.qparams)
        print(f"Loaded quantized params from {args.qparams} (no calibration)")
        return quantize, None, qparams_tree
    if not args.calib_dir:
        raise SystemExit("--quantize int8 requires --calib_dir (in-domain "
                         "images, e.g. the category's train/good) or an "
                         "existing --qparams .npz")
    from tpu_unet_torch.data.transforms import load_image_rgb
    from tpu_unet_torch.utils.io import list_calibration_images
    calib_paths = list_calibration_images(args.calib_dir)[:args.calib_samples]
    if not calib_paths:
        raise SystemExit(f"no calibration images under {args.calib_dir}")
    calib_images = np.stack([load_image_rgb(p, size_hw) for p in calib_paths])
    print(f"Calibrated int8 scales on {len(calib_paths)} images")
    return quantize, calib_images, None


def maybe_save_qparams(args, engine, qparams_tree) -> None:
    """Persist freshly calibrated scales when --qparams named a new file."""
    if args.quantize == "int8" and args.qparams and qparams_tree is None:
        from tpu_unet_torch.ops.quantize import save_qparams
        save_qparams(engine.qparams, args.qparams)
        print(f"Quantized params saved to {args.qparams}")
