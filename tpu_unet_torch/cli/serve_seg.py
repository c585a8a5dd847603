#!/usr/bin/env python3
"""Batch segmentation-serving CLI on the GPU (counterpart of
``tpu_unet/cli/serve_seg.py``) for the Gear and KolektorSDD models.

Loads a trained segmentation model from a ``.pth`` (or an exported artifact,
``--artifact``) and predicts class masks for a directory of images: BN
folded, optional int8 post-training quantization, optional tiling at the
images' native resolution (``--tile_height``/``--tile_width``). Writes one
grayscale PNG of class indices per input and ``predictions.json`` (per-image
mean confidence and class pixel shares).

Examples:
  python -m tpu_unet_torch.cli.serve_seg --checkpoint best_model.pth --input_dir imgs/
  python -m tpu_unet_torch.cli.serve_seg --checkpoint best_model.pth --input_dir imgs/ \
      --image_height 1024 --image_width 1024 --tile_height 512 --tile_width 512 \
      --quantize int8 --calib_dir train_imgs/ --export_artifact art/
  python -m tpu_unet_torch.cli.serve_seg --artifact art/ --input_dir imgs/
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from tpu_unet_torch.cli._artifact_common import (add_artifact_args, add_bucket_arg,
                                                  load_artifact_engine, maybe_export_artifact,
                                                  parse_bucket_sizes, validate_artifact_args)
from tpu_unet_torch.cli._quant_common import maybe_save_qparams, resolve_quantization
from tpu_unet_torch.serve import SegmentationPredictor
from tpu_unet_torch.utils.io import list_images, save_json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve segmentation masks for a directory of images")
    p.add_argument("--checkpoint", type=str, default=None)
    add_artifact_args(p)
    add_bucket_arg(p)
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--num_classes", type=int, default=4,
                   help="4 for Gear, 3 for KolektorSDD")
    p.add_argument("--image_height", type=int, default=512)
    p.add_argument("--image_width", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--on_decode_error", type=str, default="raise",
                   choices=["raise", "skip"],
                   help="Corrupt input file: raise a named DecodeError (default) "
                        "or log, skip, and emit NaN for that file")
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    p.add_argument("--quantize", type=str, default="none", choices=["none", "int8"])
    p.add_argument("--calib_dir", type=str, default=None,
                   help="In-domain images for int8 calibration")
    p.add_argument("--calib_samples", type=int, default=32)
    p.add_argument("--calib_percentile", type=float, default=None,
                   help="Outlier-robust percentile calibration (e.g. 99.9) "
                        "instead of abs-max")
    p.add_argument("--qparams", type=str, default=None,
                   help="Quantized-params .npz: loaded if it exists (skips "
                        "calibration), else written after calibrating")
    p.add_argument("--model", type=str, default="seg_unet",
                   choices=["seg_unet", "unetpp", "attn_unet"],
                   help="Architecture the checkpoint was trained with "
                        "(each serves in bf16/f32 or int8)")
    p.add_argument("--deep_supervision", action="store_true",
                   help="unetpp only: the checkpoint was trained with "
                        "--deep_supervision (serving averages the head logits)")
    p.add_argument("--heads", type=int, default=4,
                   help="unetpp deep-supervision inference mode: 4 = averaged "
                        "accurate mode (default); k<4 = the pruned fast mode, "
                        "the single head X[0][k], whose deeper columns do not run")
    p.add_argument("--base_features", type=int, default=64)
    p.add_argument("--bilinear", action="store_true")
    p.add_argument("--n_devices", type=int, default=None,
                   help="Split each batch over this many replicas, one per GPU "
                        "(on the CPU all share it)")
    p.add_argument("--n_space", type=int, default=1,
                   help="Shard image height over this many devices per replica "
                        "(one thread each; the height must be a multiple of "
                        "16 x n_space; not with tiling or --export_artifact)")
    p.add_argument("--tile_height", type=int, default=None,
                   help="Serve NATIVE-resolution images by tiling: run the "
                        "model at tile_height x tile_width (its training "
                        "shape) over a static overlapping grid covering the "
                        "full --image_height/--image_width input, blending "
                        "tile logits back at full resolution (ops/tiling.py)."
                        " Both --tile_height and --tile_width are required")
    p.add_argument("--tile_width", type=int, default=None)
    p.add_argument("--tile_overlap", type=int, default=64,
                   help="Overlap (px) between adjacent tiles; blended with a "
                        "center-weighted window")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--output_dir", type=str, default="served_masks")
    return p.parse_args(argv), p


def main(argv=None):
    args, parser = parse_args(argv)
    validate_artifact_args(
        args, parser,
        sharded=(args.n_devices or 0) > 1 or args.n_space > 1,
        sharded_flags="--n_devices/--n_space",
        baked_flags=("num_classes", "image_height", "image_width",
                     "batch_size", "precision", "quantize", "calib_dir",
                     "calib_samples", "calib_percentile", "qparams",
                     "base_features", "bilinear", "bucket_sizes",
                     "model", "deep_supervision", "heads",
                     "tile_height", "tile_width", "tile_overlap"))
    if (args.tile_height is None) != (args.tile_width is None):
        parser.error("--tile_height and --tile_width must be given together")

    paths = list_images(args.input_dir)
    if not paths:
        print(f"No images found under {args.input_dir}")
        return None
    print(f"Predicting masks for {len(paths)} images from {args.input_dir}")

    if args.artifact:
        return _predict_and_save(args, load_artifact_engine(args), paths)

    size_hw = (args.image_height, args.image_width)
    tile_hw = None if args.tile_height is None else (args.tile_height, args.tile_width)
    # int8 calibrates at the shape the quantized forward runs at: the tile's.
    quantize, calib_images, qparams_tree = resolve_quantization(args, tile_hw or size_hw)
    predictor = SegmentationPredictor.from_checkpoint(
        args.checkpoint, num_classes=args.num_classes, image_size_hw=size_hw,
        batch_size=args.batch_size, precision=args.precision,
        model_name=args.model, deep_supervision=args.deep_supervision,
        heads=args.heads, quantize=quantize, calib_images=calib_images,
        base_features=args.base_features, bilinear=args.bilinear,
        n_devices=args.n_devices, n_space=args.n_space, qparams=qparams_tree,
        calib_percentile=args.calib_percentile,
        bucket_sizes=parse_bucket_sizes(args, args.batch_size),
        tile_hw=tile_hw, tile_overlap=args.tile_overlap, device=args.device)
    maybe_save_qparams(args, predictor, qparams_tree)
    maybe_export_artifact(predictor, args)
    return _predict_and_save(args, predictor, paths)


def _predict_and_save(args, predictor, paths):
    from PIL import Image
    num_classes = predictor.num_classes or args.num_classes
    t0 = time.perf_counter()
    masks, confs, failed_idx = predictor.predict_paths(
        paths, num_workers=args.num_workers,
        on_decode_error=args.on_decode_error, return_failed=True)
    dt = time.perf_counter() - t0
    print(f"Predicted {len(paths)} masks in {dt:.2f}s ({len(paths) / dt:.1f} img/s)")

    os.makedirs(args.output_dir, exist_ok=True)
    records = {}
    failed = []
    failed_set = {int(i) for i in failed_idx}  # the engine's list, not inferred from NaN
    for i, (path, mask, conf) in enumerate(zip(paths, masks, confs)):
        rel = os.path.relpath(path, args.input_dir)
        if i in failed_set:
            # No mask PNG and JSON nulls, not a made-up all-background mask.
            failed.append(rel)
            records[rel] = {"mask": None, "mean_confidence": None,
                            "class_pixel_share": None, "decode_error": True}
            continue
        stem = os.path.splitext(rel)[0].replace(os.sep, "_")
        out_path = os.path.join(args.output_dir, f"{stem}_mask.png")
        Image.fromarray(mask, mode="L").save(out_path)
        shares = np.bincount(mask.ravel(), minlength=num_classes)
        records[rel] = {
            "mask": os.path.basename(out_path),
            # A NaN from the model is null too: a bare NaN is not valid JSON.
            "mean_confidence": None if np.isnan(conf) else float(conf),
            "class_pixel_share": (shares / shares.sum()).round(6).tolist(),
        }
    if failed:
        print(f"WARNING: {len(failed)} image(s) could not be decoded "
              f"(no mask written): {failed}")
    payload = {
        "checkpoint": args.checkpoint or args.artifact,
        "quantize": predictor.quantize or "none",
        "image_size_hw": list(predictor.image_size_hw),
        "num_classes": num_classes,
        "throughput_img_per_sec": round(len(paths) / dt, 2),
        "predictions": records,
    }
    if failed:
        payload["decode_failures"] = failed
    save_json(payload, os.path.join(args.output_dir, "predictions.json"))
    print(f"Masks + predictions.json written to {args.output_dir}")
    return payload


if __name__ == "__main__":
    main()
