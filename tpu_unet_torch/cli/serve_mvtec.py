#!/usr/bin/env python3
"""Batch anomaly-scoring CLI on the GPU (counterpart of
``tpu_unet/cli/serve_mvtec.py``).

Loads a trained AnomalyUNet from a reference-layout ``.pth`` (or an
exported artifact, ``--artifact``) and scores a directory of images:
BN-folded score-only forward, optional int8 post-training quantization,
pipelined host decode. Writes ``scores.json`` in the JAX CLI's schema:
per-image anomaly scores, optional thresholded verdicts, and the measured
throughput. ``--export_artifact`` writes the engine built from the
checkpoint as a serving artifact (``serve_artifact.py``).

Examples:
  python tools/export_torch_checkpoint.py --checkpoint outputs/exp/checkpoints/best_model \
      --output best_model.pth
  python -m tpu_unet_torch.cli.serve_mvtec --checkpoint best_model.pth \
      --input_dir datasets/mvtec/bottle/test/broken_large --threshold 0.012
  python -m tpu_unet_torch.cli.serve_mvtec --checkpoint best_model.pth --input_dir imgs/ \
      --quantize int8 --calib_dir datasets/mvtec/bottle/train/good --export_artifact art/
  python -m tpu_unet_torch.cli.serve_mvtec --artifact art/ --input_dir imgs/
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
from tpu_unet_torch.serve import AnomalyScorer
from tpu_unet_torch.utils.io import list_images, save_json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve anomaly scores for a directory of images")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Reference-layout .pth (tools/export_torch_checkpoint.py)")
    add_artifact_args(p)
    add_bucket_arg(p)
    p.add_argument("--input_dir", type=str, required=True,
                   help="Directory of images to score (searched recursively)")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=128,
                   help="Serving batch (inputs are padded to it)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--on_decode_error", type=str, default="raise",
                   choices=["raise", "skip"],
                   help="Corrupt input file: raise a named DecodeError (default) "
                        "or log, skip, and emit NaN for that file")
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    p.add_argument("--quantize", type=str, default="none", choices=["none", "int8"])
    p.add_argument("--calib_dir", type=str, default=None,
                   help="Directory of in-domain images for int8 calibration "
                        "(e.g. the category's train/good); required with --quantize int8")
    p.add_argument("--calib_samples", type=int, default=64)
    p.add_argument("--calib_percentile", type=float, default=None,
                   help="Outlier-robust percentile calibration (e.g. 99.9) "
                        "instead of abs-max")
    p.add_argument("--qparams", type=str, default=None,
                   help="Quantized-params .npz: loaded if it exists (skips "
                        "calibration), else written after calibrating")
    p.add_argument("--threshold", type=float, default=None,
                   help="Optional score threshold; adds boolean verdicts to the output")
    p.add_argument("--heatmap", action="store_true",
                   help="Also build the anomaly-heatmap program (score + per-pixel map)")
    p.add_argument("--heatmap_dir", type=str, default=None,
                   help="Save each image's anomaly heatmap as a grayscale PNG "
                        "under this directory (implies --heatmap)")
    p.add_argument("--base_features", type=int, default=64)
    p.add_argument("--bilinear", action="store_true")
    p.add_argument("--n_devices", type=int, default=None,
                   help="Split each serving batch over this many replicas, one "
                        "per GPU (on the CPU all share it)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--output", type=str, default="scores.json")
    return p.parse_args(argv), p


def main(argv=None):
    args, parser = parse_args(argv)
    validate_artifact_args(
        args, parser, sharded=(args.n_devices or 0) > 1, sharded_flags="--n_devices",
        baked_flags=("image_size", "batch_size", "precision", "quantize",
                     "calib_dir", "calib_samples", "calib_percentile",
                     "qparams", "base_features", "bilinear", "heatmap",
                     "bucket_sizes"))
    buckets = parse_bucket_sizes(args, args.batch_size)
    paths = list_images(args.input_dir)
    if not paths:
        print(f"No images found under {args.input_dir}")
        return None
    print(f"Scoring {len(paths)} images from {args.input_dir}")

    if args.artifact:
        return _score_and_save(args, load_artifact_engine(args), paths)

    quantize, calib_images, qparams_tree = resolve_quantization(
        args, (args.image_size, args.image_size))
    scorer = AnomalyScorer.from_checkpoint(
        args.checkpoint, image_size=args.image_size, batch_size=args.batch_size,
        precision=args.precision, quantize=quantize, calib_images=calib_images,
        base_features=args.base_features, bilinear=args.bilinear,
        n_devices=args.n_devices, qparams=qparams_tree,
        calib_percentile=args.calib_percentile,
        with_heatmap=args.heatmap or args.heatmap_dir is not None,
        bucket_sizes=buckets, device=args.device)
    maybe_save_qparams(args, scorer, qparams_tree)
    maybe_export_artifact(scorer, args)
    return _score_and_save(args, scorer, paths)


def _score_and_save(args, scorer, paths):
    heatmaps = None
    t0 = time.perf_counter()
    if args.heatmap_dir is not None:
        if not scorer.has_heatmap:
            raise SystemExit("--heatmap_dir needs a heatmap-capable engine; this "
                             "artifact was exported without --heatmap")
        scores, heatmaps, failed_idx = scorer.heatmap_paths(
            paths, num_workers=args.num_workers,
            on_decode_error=args.on_decode_error, return_failed=True)
    else:
        scores, failed_idx = scorer.score_paths(
            paths, num_workers=args.num_workers,
            on_decode_error=args.on_decode_error, return_failed=True)
    dt = time.perf_counter() - t0
    throughput = len(paths) / dt
    print(f"Scored {len(paths)} images in {dt:.2f}s ({throughput:.1f} img/s)")

    # Decode-skipped files (the engine's list, not inferred from NaN) are JSON
    # null and never get a verdict: an unreadable image is "unknown".
    failed = {int(i) for i in failed_idx}
    payload = {
        "checkpoint": args.checkpoint or args.artifact,
        "quantize": scorer.quantize or "none",
        "image_size": scorer.image_size,
        "throughput_img_per_sec": round(throughput, 2),
        "scores": {os.path.relpath(p, args.input_dir):
                   (None if np.isnan(s) else float(s))
                   for p, s in zip(paths, scores)},
    }
    if failed:
        payload["decode_failures"] = [os.path.relpath(paths[i], args.input_dir)
                                      for i in sorted(failed)]
        print(f"WARNING: {len(failed)} image(s) could not be decoded "
              f"(scores null, no verdicts): {payload['decode_failures']}")
    if heatmaps is not None:
        from PIL import Image
        os.makedirs(args.heatmap_dir, exist_ok=True)
        used = set()
        for i, p in enumerate(paths):
            if i in failed:
                continue
            rel = os.path.relpath(p, args.input_dir)
            name = rel.replace(os.sep, "__") + "_heatmap.png"
            if name in used:
                name = f"{rel.replace(os.sep, '__')}_{i}_heatmap.png"
            used.add(name)
            Image.fromarray(heatmaps[i], mode="L").save(
                os.path.join(args.heatmap_dir, name))
        payload["heatmap_dir"] = args.heatmap_dir
        print(f"Heatmaps written to {args.heatmap_dir}")
    if args.threshold is not None:
        payload["threshold"] = args.threshold
        payload["verdicts"] = {os.path.relpath(p, args.input_dir):
                               (None if np.isnan(s) else bool(s > args.threshold))
                               for p, s in zip(paths, scores)}
        valid = scores[~np.isnan(scores)]
        n_anom = int((valid > args.threshold).sum())
        print(f"{n_anom}/{len(valid)} decodable images above threshold {args.threshold}")

    save_json(payload, args.output)
    print(f"Scores written to {args.output}")
    return payload


if __name__ == "__main__":
    main()
