#!/usr/bin/env python3
"""Train UNet/AnomalyUNet for MVTec anomaly detection on the GPU (counterpart
of ``tpu_unet/cli/train_mvtec.py``: the same flags, defaults, flow and
artifacts).

An experiment directory ``<save_dir>/{category}_{model}_{%Y%m%d_%H%M%S}``
receives ``args.json``, ``results/history.jsonl`` (one line per epoch),
``results/training_curves.png``, ``results/training_results.json`` and, under
``checkpoints/``, ``best_model.pth`` (best validation loss) and
``checkpoint_epoch_{N}.pth`` (every ``--save_freq`` epochs and the last), in
the reference's ``.pth`` layout. SIGTERM saves ``checkpoint_interrupt.pth``
and exits with code 75; ``--resume <file>`` continues from a checkpoint.
:func:`train` is the trainer without the flag parsing, the dataset index and
the plot: it takes the datasets and returns the results.

Runs on ``cuda`` (``--device auto`` means ``cuda``) unless ``--device cpu``.
``--n_devices N`` trains data-parallel on N local ranks (one per GPU; on the
CPU N gloo ranks), ``--n_model K`` shards the channels over K ranks per data
rank (tensor parallelism; N K ranks in all), ``--fsdp`` shards the
parameters and Adam moments over the data ranks, and
``--multihost`` (torchrun or SLURM) or ``--coordinator_address``/
``--num_processes``/``--process_id`` join a group launched by hand; under
torchrun the group is joined without a flag. ``--batch_size`` is the global
batch. Rank 0 prints and writes.

Examples:
  python -m tpu_unet_torch.cli.train_mvtec --data_root datasets/mvtec --category bottle
  python -m tpu_unet_torch.cli.train_mvtec --data_root datasets/mvtec --category bottle \\
      --resume outputs/bottle_anomaly_unet_20260101_000000/checkpoints/checkpoint_epoch_10.pth
"""

from __future__ import annotations

import argparse
import builtins
import contextlib
import json
import os
import time
from typing import Callable, ContextManager, Optional

import numpy as np
import torch

from tpu_unet_torch.cli._seg_common import _Subset, cli_device  # test_mvtec imports them from here
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.data.mvtec import MVTecDataset, get_available_categories
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.fsdp import shard_state
from tpu_unet_torch.parallel.mesh import (check_batch, cli_world, group_of, is_main_process,
                                          launch, make_mesh, synced_timestamp, world_size)
from tpu_unet_torch.train.checkpoint import CheckpointWriter, load_checkpoint
from tpu_unet_torch.train.interrupt import (INTERRUPT_EXIT_CODE, GracefulInterrupt,
                                            interrupt_checkpoint_path)
from tpu_unet_torch.train.loop import train_anomaly_epoch, validate_anomaly_epoch
from tpu_unet_torch.train.optim import LRScheduler, set_learning_rate
from tpu_unet_torch.train.state import create_train_state, num_params
from tpu_unet_torch.train.steps import (AnomalyLossConfig, AugmentConfig,
                                        make_anomaly_eval_step, make_anomaly_train_step)
from tpu_unet_torch.utils.io import append_jsonl, create_output_dirs, save_json
from tpu_unet_torch.utils.meters import print_metrics
from tpu_unet_torch.utils.viz import plot_training_curves


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train UNet for MVTec anomaly detection")

    # Dataset arguments
    parser.add_argument("--data_root", type=str, default="../datasets/mvtec_anomaly_detection",
                        help="Path to MVTec dataset root directory")
    parser.add_argument("--category", type=str, default="bottle",
                        help="Object category to train on")
    parser.add_argument("--image_size", type=int, default=256, help="Input image size")

    # Model arguments
    parser.add_argument("--model", type=str, default="anomaly_unet",
                        choices=["unet", "anomaly_unet"], help="Model architecture")
    parser.add_argument("--bilinear", action="store_true",
                        help="Use bilinear upsampling instead of transposed convolution")

    # Training arguments
    parser.add_argument("--epochs", type=int, default=100, help="Number of training epochs")
    parser.add_argument("--batch_size", type=int, default=16, help="Batch size for training")
    parser.add_argument("--learning_rate", type=float, default=1e-3, help="Learning rate")
    parser.add_argument("--weight_decay", type=float, default=1e-4, help="Weight decay")
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=["adam", "adamw", "sgd"], help="Optimizer type")
    parser.add_argument("--scheduler", type=str, default="cosine",
                        choices=["cosine", "step", "plateau", "none"],
                        help="Learning rate scheduler")

    # Loss arguments
    parser.add_argument("--recon_weight", type=float, default=1.0,
                        help="Weight for reconstruction loss")
    parser.add_argument("--seg_weight", type=float, default=1.0,
                        help="Weight for segmentation loss")
    parser.add_argument("--use_ssim", action="store_true",
                        help="Use SSIM loss for reconstruction")

    # Training settings
    parser.add_argument("--num_workers", type=int, default=4,
                        help="Number of data loading threads")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["auto", "cuda", "cpu"],
                        help="Device to use ('auto' means cuda)")
    parser.add_argument("--seed", type=int, default=42, help="Random seed")

    # Checkpointing
    parser.add_argument("--save_dir", type=str, default="../outputs",
                        help="Directory to save outputs")
    parser.add_argument("--save_freq", type=int, default=10,
                        help="Save checkpoint every N epochs")
    parser.add_argument("--resume", type=str, default=None,
                        help="Path to a .pth checkpoint to resume from")

    # Validation
    parser.add_argument("--val_freq", type=int, default=5, help="Validate every N epochs")

    # Debug arguments
    parser.add_argument("--debug", action="store_true",
                        help="Enable debug mode with limited data")
    parser.add_argument("--debug_samples", type=int, default=20,
                        help="Number of samples to use in debug mode")

    # Extras of the JAX package
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"],
                        help="Compute precision policy (params stay f32)")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Data-parallel ranks, one per GPU (default: all "
                             "visible GPUs; 1 on the CPU)")
    parser.add_argument("--base_features", type=int, default=64,
                        help="Width of the first UNet stage (reference: 64)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler trace of epoch 1 into this dir")
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd.set_detect_anomaly (fail fast on NaN)")
    parser.add_argument("--progress_every", type=int, default=10,
                        help="Intra-epoch progress line every N steps (0 disables)")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Gradient accumulation microbatches per step: "
                             "--batch_size is the EFFECTIVE batch, run as "
                             "grad_accum sequential microbatches of "
                             "batch_size/grad_accum")
    parser.add_argument("--fsdp", action="store_true",
                        help="Shard params and optimizer state over the data ranks "
                             "(FSDP2)")
    parser.add_argument("--n_model", type=int, default=1,
                        help="Tensor (model) parallelism: shard conv channels over "
                             "this many ranks per data rank (Megatron column/row "
                             "pattern on each DoubleConv; one all-reduce per "
                             "block). Total ranks = n_devices * n_model")
    parser.add_argument("--multihost", action="store_true",
                        help="Join a torchrun or SLURM launch from its environment")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="Manual multi-host launch: host:port of rank 0")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="Manual multi-host launch: total process count")
    parser.add_argument("--process_id", type=int, default=None,
                        help="Manual multi-host launch: this process's index")
    parser.add_argument("--rotation_mode", type=str, default="per_batch_shear",
                        choices=["per_sample", "per_sample_shear", "per_batch_shear"],
                        help="Rotation augmentation: one angle per batch through "
                             "shear matmuls (default, fast), per-sample banded "
                             "shears, or per-sample gathers (reference numerics)")
    parser.add_argument("--color_jitter_random_order", action="store_true",
                        help="Randomize the ColorJitter op order per step "
                             "(torchvision semantics)")

    return parser.parse_args(argv)


def check_flags(args) -> int:
    """The run's world size (:func:`~tpu_unet_torch.parallel.mesh.cli_world`,
    joining a launched group: ``--n_devices`` times ``--n_model`` ranks);
    SystemExit for a batch that does not split over the data ranks and
    ``--grad_accum``."""
    device_type = cli_device(args.device).type
    world = cli_world(args, device_type)
    check_batch(args.batch_size, world // args.n_model, args.grad_accum)
    return world


def main(argv=None):
    args = parse_args(argv)
    world = check_flags(args)
    device = cli_device(args.device)
    say = print if is_main_process() else (lambda *a, **k: None)
    say(f"Device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
        + (f", {world} ranks ({world // args.n_model} data x {args.n_model} model)"
           if world > 1 else ""))
    say(f"Training category: {args.category}")

    available = get_available_categories(args.data_root)
    if args.category not in available:
        say(f"Category '{args.category}' not found!")
        say(f"Available categories: {available}")
        return None

    experiment_name = f"{args.category}_{args.model}_{synced_timestamp()}"
    experiment_dir = os.path.join(args.save_dir, experiment_name)
    results = launch(_train_rank, (args, experiment_dir), n_devices=args.n_devices,
                     device_type=device.type, n_model=args.n_model)
    if not is_main_process():
        return None
    if results["train_losses"] or results["val_losses"]:
        plot_training_curves(results["train_losses"], results["val_losses"],
                             os.path.join(experiment_dir, "results", "training_curves.png"))
    if results["interrupted"]:
        print(f"\nTraining interrupted (SIGTERM); partial results saved to: "
              f"{experiment_dir}")
        raise SystemExit(INTERRUPT_EXIT_CODE)  # EX_TEMPFAIL: requeue me
    print("\nTraining completed!")
    best = results["best_val_loss"]
    print(f"Best validation loss: {best:.4f}" if best is not None else "No validation ran")
    print(f"Results saved to: {experiment_dir}")
    return experiment_dir


def _train_rank(args, experiment_dir: str) -> dict:
    """One rank's (or the one process's) part of ``main``: the datasets and
    :func:`train` on this rank's device."""
    device = cli_device(args.device)
    say = print if is_main_process() else (lambda *a, **k: None)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    say("Creating data loaders...")
    train_ds = MVTecDataset(args.data_root, args.category, "train",
                            args.image_size, is_train=True)
    val_ds = MVTecDataset(args.data_root, args.category, "test",
                          args.image_size, is_train=False)
    if args.debug:
        say(f"DEBUG MODE: Limiting dataset to {args.debug_samples} samples")
        train_ds = _Subset(train_ds, args.debug_samples, args.seed)
        val_ds = _Subset(val_ds, args.debug_samples, args.seed + 1)
    return train(args, train_ds, val_ds, device, experiment_dir)


def train(args, train_ds, val_ds, device: torch.device, experiment_dir: str,
          span: Optional[Callable[[str, int], ContextManager]] = None) -> dict:
    """The trainer's body, from the experiment directory to the results:
    everything ``main`` does after reading the flags and indexing the data,
    except the loss-curve plot.

    Creates ``experiment_dir`` with its subdirectories and ``args.json``,
    trains on ``train_ds`` and validates on ``val_ds`` (anything with
    ``__len__`` and ``load(idx)``), writes the checkpoints,
    ``results/history.jsonl`` and ``results/training_results.json``, and
    returns that file's dict (with ``checkpoint_writes``: each write's path,
    bytes and seconds). ``span(name, epoch)``, if given, returns a context
    manager entered around each epoch's ``"train"`` and ``"validate"``
    passes, e.g. to time them or to read counters.

    Under a process group (``--n_devices``, ``--n_model``, torchrun) every
    rank calls it with its device: the loaders give each data rank its rows
    (every model rank of it the same), the state is placed on the mesh
    (``--n_model`` slices its channels, ``--fsdp`` shards it over the data
    ranks) after any resume, and only rank 0 prints and writes; every rank
    returns the results.
    """
    span = span or (lambda name, epoch: contextlib.nullcontext())
    main_rank = is_main_process()
    print = builtins.print if main_rank else (lambda *a, **k: None)  # noqa: A001
    output_dirs = create_output_dirs(experiment_dir)
    print(f"Experiment directory: {experiment_dir}")
    if main_rank:
        with open(os.path.join(experiment_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
    print(f"Train samples: {len(train_ds)}")
    print(f"Validation samples: {len(val_ds)}")

    n_model = getattr(args, "n_model", 1)
    mesh = make_mesh(world_size() // n_model, n_model=n_model,
                     device_type=device.type)  # None in one process
    # Train masks are binary (train/good has zero masks), so they ship as
    # uint8: exact and 4x smaller; the steps cast after the nearest-sampled
    # augment. Validation keeps float32 (--mask_resize bilinear values).
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                              drop_last=len(train_ds) >= args.batch_size,
                              num_workers=args.num_workers, grad_accum=args.grad_accum,
                              transform=lambda b: to_device(b, device, mask_dtype=np.uint8))
    val_loader = DataLoader(val_ds, args.batch_size, pad_last=True,
                            num_workers=args.num_workers,
                            transform=lambda b: to_device(b, device))

    # Model / optimizer / schedules
    print("Creating model...")
    torch.manual_seed(args.seed)  # the same initial weights on the CPU and the card
    model = build_model(args.model, n_channels=3, n_classes=1, bilinear=args.bilinear,
                        policy=get_policy(args.precision), base_features=args.base_features)
    state = create_train_state(model, args.optimizer, args.learning_rate,
                               args.weight_decay, device=device)
    total_params = num_params(state)
    print(f"Total parameters: {total_params:,}")

    start_epoch = 0
    if args.resume:
        state, last_epoch, _ = load_checkpoint(state, args.resume)
        start_epoch = last_epoch + 1
        # The loader's shuffle-epoch counter: a resumed run sees the same
        # per-epoch sample order as an uninterrupted one.
        train_loader.epoch = start_epoch
    state = shard_state(mesh, state, fsdp=args.fsdp, tp=n_model > 1)
    group = group_of(mesh)

    loss_cfg = AnomalyLossConfig(
        recon_weight=args.recon_weight,
        seg_weight=args.seg_weight,
        recon_loss_type="ssim" if args.use_ssim else "mse",
    )
    dual = args.model == "anomaly_unet"
    train_step = make_anomaly_train_step(
        loss_cfg,
        AugmentConfig(rotation_mode=args.rotation_mode,
                      color_jitter_random_order=args.color_jitter_random_order),
        dual_decoder=dual, grad_accum=args.grad_accum, group=group)
    eval_step = make_anomaly_eval_step(loss_cfg, dual_decoder=dual, group=group)
    scheduler = LRScheduler(args.scheduler, args.learning_rate, args.epochs)

    # Training loop
    print("Starting training...")
    train_losses, val_losses = [], []
    best_val_loss = float("inf")
    history_path = os.path.join(output_dirs["results"], "history.jsonl")
    interrupted = False

    # Profile the second epoch (past warm-up), or the only one.
    profile_epoch = (start_epoch + 1 if args.epochs > start_epoch + 1
                     else start_epoch)
    ckpt_writer = CheckpointWriter()  # async: file writes overlap training
    intr = GracefulInterrupt().install()  # SIGTERM -> checkpoint, not death
    try:
        for epoch in range(start_epoch, args.epochs):
            epoch_start = time.time()
            lr = scheduler.lr_for_epoch(epoch)
            set_learning_rate(state.optimizer, lr)

            prof = None
            if args.profile_dir and epoch == profile_epoch:
                prof = _start_profiler(device)
            with span("train", epoch):
                train_metrics = train_anomaly_epoch(
                    state, train_step, train_loader, args.seed, epoch,
                    progress_fn=print, progress_every=args.progress_every,
                    should_stop=intr.step_poll())
            if prof is not None:
                _stop_profiler(prof, args.profile_dir, device)
            if intr.poll_global():
                # SIGTERM: this epoch may be partial, so the checkpoint names
                # epoch - 1 as the last completed one and --resume replays
                # the interrupted epoch from its start.
                ipath = interrupt_checkpoint_path(output_dirs["checkpoints"])
                ckpt_writer.save(state, epoch - 1,
                                 train_metrics.get("total_loss", 0.0), ipath)
                ckpt_writer.wait()
                interrupted = True
                print(f"SIGTERM received: training interrupted during epoch "
                      f"{epoch}; resume with --resume {ipath}")
                break
            train_losses.append(train_metrics["total_loss"])
            history = {"epoch": epoch, "lr": lr,
                       "epoch_seconds": round(time.time() - epoch_start, 3),
                       **{k: train_metrics[k] for k in
                          ("total_loss", "recon_loss", "seg_loss")}}

            if epoch % args.val_freq == 0 or epoch == args.epochs - 1:
                with span("validate", epoch):
                    val_metrics = validate_anomaly_epoch(state, eval_step, val_loader)
                val_losses.append(val_metrics["total_loss"])
                history["val_loss"] = val_metrics["total_loss"]
                history.update({f"val_{k}": v for k, v in
                                val_metrics["image_metrics"].items()})
                if args.scheduler == "plateau":
                    scheduler.step_plateau(val_metrics["total_loss"])

                print(f"\nEpoch {epoch}/{args.epochs - 1}")
                print(f"Train Loss: {train_metrics['total_loss']:.4f} "
                      f"(Recon: {train_metrics['recon_loss']:.4f}, "
                      f"Seg: {train_metrics['seg_loss']:.4f})")
                print(f"Val Loss: {val_metrics['total_loss']:.4f} "
                      f"(Recon: {val_metrics['recon_loss']:.4f}, "
                      f"Seg: {val_metrics['seg_loss']:.4f})")
                print_metrics(val_metrics["image_metrics"], "Image-level")
                if val_metrics["pixel_metrics"]:
                    print_metrics(val_metrics["pixel_metrics"], "Pixel-level")

                if val_metrics["total_loss"] < best_val_loss:
                    best_val_loss = val_metrics["total_loss"]
                    ckpt_writer.save(state, epoch, val_metrics["total_loss"],
                                     os.path.join(output_dirs["checkpoints"],
                                                  "best_model.pth"))

            if epoch % args.save_freq == 0 or epoch == args.epochs - 1:
                ckpt_writer.save(state, epoch, train_metrics["total_loss"],
                                 os.path.join(output_dirs["checkpoints"],
                                              f"checkpoint_epoch_{epoch}.pth"))

            if main_rank:
                append_jsonl(history, history_path)  # live, crash-surviving record
            print(f"Epoch time: {time.time() - epoch_start:.2f}s")

    finally:
        ckpt_writer.close()  # flush the write in flight, even on error
        intr.uninstall()
    results = {
        "train_losses": train_losses,
        "val_losses": val_losses,
        "best_val_loss": best_val_loss if best_val_loss != float("inf") else None,
        "total_epochs": args.epochs,
        "total_params": total_params,
        "interrupted": interrupted,
        "args": vars(args),
        "checkpoint_writes": ckpt_writer.writes,
    }
    if main_rank:
        save_json(results, os.path.join(output_dirs["results"], "training_results.json"))
    return results


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Profiler trace saved to {path}")


if __name__ == "__main__":
    main()
