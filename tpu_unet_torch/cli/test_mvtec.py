#!/usr/bin/env python3
"""Test UNet/AnomalyUNet on MVTec on the GPU (counterpart of
``tpu_unet/cli/test_mvtec.py``: the same flags and artifacts).

Loads a ``.pth`` checkpoint (the reference's layout or a bare state_dict)
and writes ``test_metrics.json`` (image, per-anomaly-type and pixel metrics
at each ``--pixel_thresholds``), ``confusion_matrix.png``,
``detailed_results.json`` and, with ``--save_visualizations``,
``visualizations.png`` under ``<output_dir>/<category>_test_results``.
``--fold_bn`` folds BatchNorm into the convs; ``--quantize int8`` calibrates
int8 scales on the first ``--calib_samples`` train images and runs every 3x3
conv through kernel K2. ``main`` runs :func:`make_test_loader`,
:func:`load_model`, :func:`test_model`, :func:`evaluate_results` and
:func:`save_results`, then plots.

Runs on ``cuda`` (``--device auto`` means ``cuda``) unless ``--device cpu``.
``--n_devices N`` evaluates data-parallel on N local ranks (one per GPU; on
the CPU N gloo ranks): each rank runs its rows of every ``--batch_size``
batch (K1, and K2 under int8, on every rank), :func:`test_model` gathers
the rows in the global order and rank 0 writes.

Example:
  python -m tpu_unet_torch.cli.test_mvtec --data_root datasets/mvtec --category bottle \\
      --checkpoint outputs/<exp>/checkpoints/best_model.pth --quantize int8
"""

from __future__ import annotations

import argparse
import builtins
import os
from collections import defaultdict

import numpy as np
import torch

from tpu_unet_torch.cli._seg_common import QuantizedEvalStep
from tpu_unet_torch.cli.train_mvtec import _Subset, cli_device
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.data.mvtec import MVTecDataset, get_available_categories
from tpu_unet_torch.metrics import calculate_metrics, get_optimal_threshold
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.collectives import gather_batches, gather_objects
from tpu_unet_torch.parallel.mesh import (broadcast_tensors, check_batch, cli_world, group_of,
                                          is_main_process, launch, make_mesh, world_size)
from tpu_unet_torch.train.checkpoint import load_params
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import make_anomaly_eval_step
from tpu_unet_torch.utils.io import save_json
from tpu_unet_torch.utils.meters import print_metrics
from tpu_unet_torch.utils.viz import plot_confusion_matrix, visualize_results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test UNet for MVTec anomaly detection")
    parser.add_argument("--data_root", type=str, default="../datasets/mvtec_anomaly_detection")
    parser.add_argument("--category", type=str, default="bottle")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--model", type=str, default="anomaly_unet",
                        choices=["unet", "anomaly_unet"])
    parser.add_argument("--bilinear", action="store_true",
                        help="Bilinear decoders")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="A .pth checkpoint (reference layout or a bare state_dict)")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda", choices=["auto", "cuda", "cpu"])
    parser.add_argument("--threshold", type=float, default=None,
                        help="Threshold for anomaly detection (if None, will be optimized)")
    parser.add_argument("--pixel_thresholds", type=float, nargs="+", default=[0.3, 0.5, 0.7])
    parser.add_argument("--output_dir", type=str, default="../test_results")
    parser.add_argument("--save_visualizations", action="store_true")
    parser.add_argument("--max_vis_samples", type=int, default=20)
    # Extras of the JAX package
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Data-parallel ranks, one per GPU (default: all "
                             "visible GPUs; 1 on the CPU)")
    parser.add_argument("--base_features", type=int, default=64)
    parser.add_argument("--fold_bn", action="store_true",
                        help="Fold BatchNorm into conv weights for inference")
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "int8"],
                        help="int8 post-training quantization for inference "
                             "(activation scales calibrated on the train split)")
    parser.add_argument("--calib_samples", type=int, default=64,
                        help="Calibration images for --quantize int8")
    parser.add_argument("--calib_percentile", type=float, default=None,
                        help="Outlier-robust percentile calibration (e.g. 99.9)")
    parser.add_argument("--mask_resize", type=str, default="nearest",
                        choices=["nearest", "bilinear"],
                        help="GT-mask resize: 'nearest' (binarize, then nearest) "
                             "or 'bilinear' (the reference's raster)")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--debug_samples", type=int, default=20)
    return parser.parse_args(argv)


def test_model(eval_step, state, loader) -> dict:
    """Run inference over the test set and collect the results on the host.

    ``loader`` yields batches already on the state's device (its transform
    is ``to_device``, as in :func:`make_test_loader`); the outputs stay there
    until the loader is drained, then come to the host in one go. Padded rows
    are dropped. Under data parallelism every rank's rows are gathered, in
    the global batch order, so each rank returns the whole test set's.
    """
    device = state.device
    acc = defaultdict(list)
    anomaly_types, image_paths = [], []
    for batch in loader:
        out = eval_step(state, batch["image"], batch["mask"])
        n = batch["image"].shape[0]
        valid = batch.get("valid")
        acc["valid"].append(valid.to(torch.bool) if valid is not None
                            else torch.ones(n, dtype=torch.bool, device=device))
        acc["images"].append(out["image"])
        acc["reconstructions"].append(out["reconstruction"])
        acc["anomaly_maps"].append(out["anomaly_map"])
        acc["masks_true"].append(batch["mask"][..., 0])
        acc["labels"].append(batch["label"])
        acc["anomaly_scores"].append(out["score"])
        anomaly_types.append(batch["anomaly_type"])
        image_paths.append(batch["image_path"])
    nb = len(image_paths)
    valid = gather_batches(torch.cat(acc.pop("valid")).cpu().numpy(), nb)
    results = {k: gather_batches(torch.cat(v).cpu().numpy(), nb)[valid]
               for k, v in acc.items()}
    results["anomaly_types"] = [t for t, ok in zip(gather_objects(sum(anomaly_types, []), nb),
                                                   valid) if ok]
    results["image_paths"] = [p for p, ok in zip(gather_objects(sum(image_paths, []), nb),
                                                 valid) if ok]
    return results


def evaluate_results(results: dict, pixel_thresholds, threshold=None) -> dict:
    labels = results["labels"]
    scores = results["anomaly_scores"]
    if threshold is None:
        threshold, _ = get_optimal_threshold(labels, scores)
        print(f"Optimal threshold: {threshold:.4f}")
    predictions = (scores > threshold).astype(int)
    results["predictions"] = predictions
    results["threshold"] = float(threshold)

    image_metrics = calculate_metrics(labels, predictions, scores)

    type_metrics = {}
    for atype in sorted(set(results["anomaly_types"])):
        idx = np.asarray([i for i, t in enumerate(results["anomaly_types"]) if t == atype])
        t_labels, t_preds, t_scores = labels[idx], predictions[idx], scores[idx]
        if len(np.unique(t_labels)) > 1:
            type_metrics[atype] = calculate_metrics(t_labels, t_preds, t_scores)
        else:
            type_metrics[atype] = {
                "accuracy": 1.0 if t_preds[0] == t_labels[0] else 0.0,
                "count": len(idx),
            }

    pixel_metrics = {}
    anomaly_idx = labels == 1
    if anomaly_idx.sum() > 0:
        masks_true = results["masks_true"][anomaly_idx]
        maps_pred = results["anomaly_maps"][anomaly_idx]
        pixel_metrics = _pixel_metrics(masks_true, maps_pred, pixel_thresholds)

    return {"image_metrics": image_metrics, "type_metrics": type_metrics,
            "pixel_metrics": pixel_metrics}


def _pixel_metrics(masks_true, maps_pred, thresholds) -> dict:
    """``calculate_pixel_metrics`` at each threshold, the same dicts: the
    pixel AUROC and AUPRC do not depend on the threshold, so their sorts of
    every pixel's score run once instead of once per threshold."""
    true = (np.asarray(masks_true) > 0.5).astype(np.uint8).ravel()
    scores = np.asarray(maps_pred).ravel()
    curve = calculate_metrics(true, true, scores)
    out = {}
    for thr in thresholds:
        m = calculate_metrics(true, (scores > thr).astype(np.uint8))
        out[f"threshold_{thr}"] = {**m, "auroc": curve["auroc"], "auprc": curve["auprc"]}
    return out


def save_results(results, evaluation, output_dir, args):
    """``test_metrics.json`` and ``detailed_results.json`` (``main`` adds the
    confusion-matrix plot)."""
    os.makedirs(output_dir, exist_ok=True)
    payload = dict(evaluation)
    payload["threshold"] = float(results["threshold"])
    payload["args"] = vars(args)
    save_json(payload, os.path.join(output_dir, "test_metrics.json"))
    print(f"Metrics saved to: {os.path.join(output_dir, 'test_metrics.json')}")

    detailed = {
        "labels": results["labels"].tolist(),
        "predictions": results["predictions"].tolist(),
        "anomaly_scores": results["anomaly_scores"].tolist(),
        "anomaly_types": results["anomaly_types"],
        "image_paths": results["image_paths"],
        "threshold": float(results["threshold"]),
    }
    save_json(detailed, os.path.join(output_dir, "detailed_results.json"))
    print(f"Detailed results saved to: {os.path.join(output_dir, 'detailed_results.json')}")


def quantized_eval_step(state, calib_images: np.ndarray, percentile=None, group=None):
    """int8 eval step over ``state``'s weights (folded or not), calibrated on
    ``calib_images`` in chunks of 16; the signature of the float eval step.
    ``group``: the data-parallel group its loss scalars reduce over; every
    rank calibrates and takes rank 0's qparams."""
    from tpu_unet_torch.ops.quantize import (chunk_calibration,
                                             make_quantized_anomaly_eval_step,
                                             quantize_from_train_state)
    qparams = broadcast_tensors(quantize_from_train_state(
        "anomaly_unet", state.model.state_dict(), chunk_calibration(calib_images, 16),
        percentile=percentile, device=state.device), group)
    return QuantizedEvalStep(make_quantized_anomaly_eval_step(group=group), qparams)


def make_test_loader(args, test_ds, device: torch.device) -> DataLoader:
    """The test split's loader: padded last batch, batches (this rank's rows
    of each) sent to ``device``."""
    return DataLoader(test_ds, args.batch_size, pad_last=True,
                      num_workers=args.num_workers,
                      transform=lambda b: to_device(b, device))


def load_model(args, device: torch.device, calib_ds=None):
    """``(state, eval_step)`` for ``--checkpoint`` on ``device``: BN folded
    with ``--fold_bn``; with ``--quantize int8`` the step is the int8 one,
    calibrated on the first ``--calib_samples`` images of ``calib_ds``
    (every rank calibrates alike). The step reduces its loss scalars over
    the process group, if any."""
    say = print if is_main_process() else (lambda *a, **k: None)
    model = build_model(args.model, n_channels=3, n_classes=1, bilinear=args.bilinear,
                        policy=get_policy(args.precision), base_features=args.base_features)
    state = create_train_state(model, "adam", 1e-3, 0.0, device=device)
    say(f"Loading checkpoint: {args.checkpoint}")
    state = load_params(state, args.checkpoint)
    if args.fold_bn:
        from tpu_unet_torch.ops.fold_bn import fold_batchnorm
        fold_batchnorm(state.model)
        say("BatchNorm folded into conv weights for inference")
    group = group_of(make_mesh(world_size(), device_type=device.type))

    if args.quantize == "int8":
        if args.model != "anomaly_unet":
            raise SystemExit("--quantize int8 supports anomaly_unet only (both decoder "
                             "modes; bilinear upsamples run as float islands)")
        n_calib = min(len(calib_ds), args.calib_samples)
        calib_imgs = np.stack([calib_ds.load(i)["image"] for i in range(n_calib)])
        eval_step = quantized_eval_step(state, calib_imgs, args.calib_percentile, group)
        say(f"int8 quantized inference (calibrated on {n_calib} train images)")
    else:
        eval_step = make_anomaly_eval_step(dual_decoder=(args.model == "anomaly_unet"),
                                           group=group)
    return state, eval_step


def main(argv=None):
    args = parse_args(argv)
    device = cli_device(args.device)
    world = cli_world(args, device.type)
    check_batch(args.batch_size, world)
    main_rank = is_main_process()
    say = print if main_rank else (lambda *a, **k: None)
    say(f"Device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
        + (f", {world} data-parallel ranks" if world > 1 else ""))
    say(f"Testing category: {args.category}")

    available = get_available_categories(args.data_root)
    if args.category not in available:
        say(f"Category '{args.category}' not found!")
        say(f"Available categories: {available}")
        return None

    output_dir = os.path.join(args.output_dir, f"{args.category}_test_results")
    if main_rank:
        os.makedirs(output_dir, exist_ok=True)
    evaluation = launch(_test_rank, (args, output_dir), n_devices=args.n_devices,
                        device_type=device.type)
    return evaluation if main_rank else None


def _test_rank(args, output_dir: str) -> dict:
    """``main``'s work on one rank (or the one process): every rank tests
    its rows; rank 0 prints, writes and plots. Returns the evaluation."""
    device = cli_device(args.device)
    print = builtins.print if is_main_process() else (lambda *a, **k: None)  # noqa: A001
    test_ds = MVTecDataset(args.data_root, args.category, "test",
                           args.image_size, is_train=False,
                           mask_resize=args.mask_resize)
    if args.debug:
        test_ds = _Subset(test_ds, args.debug_samples, 0)
    print(f"Test samples: {len(test_ds)}")
    calib_ds = (MVTecDataset(args.data_root, args.category, "train", args.image_size,
                             is_train=True) if args.quantize == "int8" else None)

    loader = make_test_loader(args, test_ds, device)
    state, eval_step = load_model(args, device, calib_ds)
    print("Testing model...")
    results = test_model(eval_step, state, loader)
    print("Evaluating results...")
    evaluation = evaluate_results(results, args.pixel_thresholds, args.threshold)
    if not is_main_process():
        return evaluation

    print("\n" + "=" * 50)
    print("TEST RESULTS")
    print("=" * 50)
    print_metrics(evaluation["image_metrics"], "Image-level")
    if evaluation["pixel_metrics"]:
        print("\nPixel-level Metrics:")
        for thr, metrics in evaluation["pixel_metrics"].items():
            print(f"\n{thr}:")
            print_metrics(metrics, "  ")
    if evaluation["type_metrics"]:
        print("\nPer-anomaly-type Metrics:")
        for atype, metrics in evaluation["type_metrics"].items():
            print(f"\n{atype}:")
            print_metrics(metrics, "  ")

    save_results(results, evaluation, output_dir, args)
    plot_confusion_matrix(results["labels"], results["predictions"],
                          save_path=os.path.join(output_dir, "confusion_matrix.png"))

    if args.save_visualizations:
        print("Saving visualizations...")
        n = min(args.max_vis_samples, len(results["images"]))
        rng = np.random.default_rng(0)
        idx = rng.choice(len(results["images"]), n, replace=False)
        visualize_results(
            results["images"][idx], results["masks_true"][idx],
            results["anomaly_maps"][idx],
            results["reconstructions"][idx] if args.model == "anomaly_unet" else None,
            os.path.join(output_dir, "visualizations.png"), n)

    print("\nTesting completed!")
    print(f"Results saved to: {output_dir}")
    return evaluation


if __name__ == "__main__":
    main()
