"""The shared driver of the two segmentation workloads, Gear and KolektorSDD
(counterpart of ``tpu_unet/cli/_seg_common.py``), and helpers shared by the
CLIs.

One driver serves both datasets through a :class:`Workload`. It keeps the
JAX package's behaviour and files: the best checkpoint chosen by validation
mIoU, ``args.json``, ``results/history.jsonl``,
``results/training_results.json`` and ``evaluation_results.json`` with the
same keys, periodic checkpoints, and exit code 75 after SIGTERM.
Checkpoints are the reference's ``.pth`` files (``train/checkpoint.py``).

Each entry point is split as ``cli/train_mvtec.py`` is:
:func:`run_seg_training` and :func:`run_seg_evaluation` check the flags, pick
the device, index the datasets and draw the plots (matplotlib); the work
runs in functions that take the datasets and a device: :func:`train_seg`
for training; :func:`eval_mesh`, :func:`make_eval_loader`, :func:`load_seg_model`,
``train/loop.py::validate_seg_epoch`` and :func:`save_seg_results` for
evaluation. Entry points run on ``cuda`` unless ``--device cpu``.

Data parallelism (``--n_devices``, ``--fsdp``, the multi-host flags, or a
torchrun launch): :func:`run_seg_training` and :func:`run_seg_evaluation`
run their work on every rank (``parallel/mesh.py::launch``); the loaders
give each rank its rows of the global ``--batch_size``, the steps reduce
over the group, and rank 0 logs and writes. ``--n_space`` splits each
image's rows over that many ranks per data rank (``parallel/spatial.py``):
every space rank of a data index loads the same images, the steps split
the rows, and the eval steps gather the predictions' rows back, so the
panels, the metrics and ``evaluation_results.json`` see whole images.
``--n_model`` slices the channels over that many ranks per (data, space)
rank (tensor parallelism); the trainers take it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, ContextManager, Optional, Tuple

import numpy as np
import torch

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models.unet import ATTN_NAMES, UNETPP_NAMES, check_model_flags
from tpu_unet_torch.parallel.fsdp import shard_state
from tpu_unet_torch.parallel.mesh import (broadcast_tensors, check_batch, cli_world,
                                          data_coords, group_of, is_main_process, launch,
                                          make_mesh, synced_timestamp, world_size)
from tpu_unet_torch.parallel.spatial import check_rows, mesh_exchanger
from tpu_unet_torch.train.checkpoint import CheckpointWriter, load_checkpoint, load_params
from tpu_unet_torch.train.interrupt import (INTERRUPT_EXIT_CODE, GracefulInterrupt,
                                            interrupt_checkpoint_path)
from tpu_unet_torch.train.loop import train_seg_epoch, validate_seg_epoch
from tpu_unet_torch.train.state import create_train_state, num_params
from tpu_unet_torch.train.steps import (AugmentConfig, SegLossConfig, make_seg_eval_step,
                                        make_seg_train_step)
from tpu_unet_torch.utils import spans
from tpu_unet_torch.utils.io import append_jsonl, create_output_dirs, save_json
from tpu_unet_torch.utils.logging import setup_logging


@dataclasses.dataclass
class Workload:
    """A seg dataset's driver hooks; module-level functions, so that a
    workload pickles to data-parallel ranks."""
    name: str                      # experiment prefix: 'gear_seg' or 'kolektorsdd'
    make_datasets: Callable        # (args) -> (train, val, test, num_classes, class_names)
    image_size_hw: Callable        # (args) -> (H, W)
    augment: AugmentConfig


def parse_class_weights(s: Optional[str], num_classes: int) -> Optional[Tuple[float, ...]]:
    if not s:
        return None
    weights = tuple(float(x) for x in s.split(","))
    if len(weights) != num_classes:
        raise ValueError(f"Got {len(weights)} class weights for {num_classes} classes")
    return weights


class _Subset:
    """Random fixed-size subset: the reference's ``--debug`` sampling, shared
    by every CLI's ``--debug`` path (the MVTec trainer re-exports it)."""

    def __init__(self, dataset, n, seed):
        rng = np.random.default_rng(seed)
        self.indices = rng.choice(len(dataset), size=min(n, len(dataset)), replace=False)
        self.dataset = dataset

    def __len__(self):
        return len(self.indices)

    def load(self, i):
        return self.dataset.load(int(self.indices[i]))


def cli_device(name: str) -> torch.device:
    """``--device``: 'auto' means cuda; raises when cuda has no GPU."""
    return resolve_device("cuda" if name == "auto" else name)


def check_train_flags(args, height: Optional[int] = None) -> int:
    """The run's world size (joining a launched group: ``--n_devices``
    times ``--n_space`` times ``--n_model`` ranks); ValueError for a
    transunet or segformer with ``--n_space`` or ``--n_model`` above 1
    (``models/unet.py::check_model_flags``) and for an image
    ``height`` that ``--n_space`` does not divide, as the JAX package's
    (``parallel/spatial.py::check_rows``), SystemExit for a
    ``--batch_size`` that does not split over the data ranks and
    ``--grad_accum``."""
    check_model_flags(args.model, args.deep_supervision, n_space=args.n_space,
                      n_model=args.n_model)
    if height is not None:
        check_rows(height, args.n_space)
    world = cli_world(args, cli_device(args.device).type)
    check_batch(args.batch_size, world // (args.n_space * args.n_model), args.grad_accum)
    return world


def check_eval_flags(args, height: Optional[int] = None) -> int:
    """As :func:`check_train_flags` for the evaluators (``--n_devices``,
    ``--n_space``)."""
    check_model_flags(args.model, args.deep_supervision, args.heads)
    if height is not None:
        check_rows(height, args.n_space)
    world = cli_world(args, cli_device(args.device).type)
    check_batch(args.batch_size, world // args.n_space)
    return world


def _logger(output_dirs, experiment_dir: str) -> logging.Logger:
    """The experiment's logger on rank 0; a disabled one on other ranks."""
    if is_main_process():
        return setup_logging(output_dirs["logs"], os.path.basename(experiment_dir))
    quiet = logging.getLogger("tpu_unet_torch.quiet_rank")
    quiet.disabled = True
    return quiet


def _device_line(device: torch.device, world: int = 1, n_model: int = 1,
                 n_space: int = 1) -> str:
    space = f" x {n_space} space" if n_space > 1 else ""
    return (f"Device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                   if device.type == "cuda" else "")
            + (f", {world} ranks ({world // (n_model * n_space)} data{space} x "
               f"{n_model} model)" if world > 1 else ""))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def run_seg_training(args, workload: Workload):
    """The trainer: flag checks, device, datasets, then :func:`train_seg`
    on every rank. Returns the experiment directory (None on ranks other
    than 0); exits with code 75 after SIGTERM."""
    world = check_train_flags(args, workload.image_size_hw(args)[0])
    device = cli_device(args.device)
    if is_main_process():
        print(_device_line(device, world, args.n_model, args.n_space))
    experiment_name = f"{workload.name}_{args.model}_{synced_timestamp()}"
    experiment_dir = os.path.join(args.save_dir, experiment_name)
    results = launch(_train_rank, (args, workload, experiment_dir),
                     n_devices=args.n_devices, device_type=device.type, n_model=args.n_model,
                     n_space=args.n_space)
    if not is_main_process():
        return None
    if results["interrupted"]:
        raise SystemExit(INTERRUPT_EXIT_CODE)  # EX_TEMPFAIL: requeue me
    return experiment_dir


def _train_rank(args, workload: Workload, experiment_dir: str) -> dict:
    device = cli_device(args.device)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    train_ds, val_ds, _, num_classes, _ = workload.make_datasets(args)
    if args.debug:
        if is_main_process():
            print(f"DEBUG MODE: Limiting dataset to {args.debug_samples} samples")
        train_ds = _Subset(train_ds, args.debug_samples, args.seed)
        val_ds = _Subset(val_ds, args.debug_samples, args.seed + 1)
    return train_seg(args, workload, train_ds, val_ds, num_classes, device, experiment_dir)


def train_seg(args, workload: Workload, train_ds, val_ds, num_classes: int,
              device: torch.device, experiment_dir: str,
              span: Optional[Callable[[str, int], ContextManager]] = None) -> dict:
    """The trainer's body, from the experiment directory to the results.

    Creates ``experiment_dir`` (its subdirectories, the log file and
    ``args.json``), trains on ``train_ds`` and validates on ``val_ds``
    (anything with ``__len__`` and ``load(idx)`` giving uint8 images and
    masks), writes ``best_model.pth`` (best validation mIoU) and
    ``checkpoint_epoch_{N}.pth``, ``results/history.jsonl`` and
    ``results/training_results.json``, and returns that file's dict plus
    ``checkpoint_writes`` (each write's path, bytes and seconds).
    ``span(name, epoch)``, if given, returns a context manager entered
    around each epoch's ``"train"`` and ``"validate"`` passes; by default
    each pass is a ``cli.train`` or ``cli.validate`` span
    (``utils/spans.py``).

    Under a process group every rank calls it with its device; the loaders
    give each data rank its rows, the state is placed on the mesh after any
    resume (``--n_model`` slices its channels, ``--fsdp`` shards it over the
    data ranks) and rank 0 logs and writes.
    """
    span = span or (lambda name, epoch: spans.span(f"cli.{name}"))
    main_rank = is_main_process()
    output_dirs = create_output_dirs(experiment_dir)
    logger = _logger(output_dirs, experiment_dir)
    logger.info(f"Experiment directory: {experiment_dir}")
    if main_rank:
        with open(os.path.join(experiment_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=2)
    logger.info(f"Train samples: {len(train_ds)}, Val samples: {len(val_ds)}, "
                f"classes: {num_classes}")

    n_model, n_space = getattr(args, "n_model", 1), getattr(args, "n_space", 1)
    mesh = make_mesh(world_size() // (n_model * n_space), n_space=n_space, n_model=n_model,
                     device_type=device.type)  # None in one process
    # Masks ship as uint8 (class ids <= 3): 4x less to copy than int32.
    to_dev = lambda b: to_device(b, device)  # noqa: E731
    count, index = data_coords(mesh)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                              drop_last=len(train_ds) >= args.batch_size,
                              num_workers=args.num_workers, grad_accum=args.grad_accum,
                              transform=to_dev, process_count=count, process_index=index)
    val_loader = DataLoader(val_ds, args.batch_size, pad_last=True,
                            num_workers=args.num_workers, transform=to_dev,
                            process_count=count, process_index=index)

    torch.manual_seed(args.seed)  # the same initial weights on the CPU and the card
    model = build_model(args.model, n_channels=3, n_classes=num_classes,
                        bilinear=args.bilinear, dropout=args.dropout,
                        policy=get_policy(args.precision), base_features=args.base_features,
                        deep_supervision=args.deep_supervision,
                        image_size_hw=workload.image_size_hw(args))
    state = create_train_state(model, args.optimizer, args.learning_rate,
                               args.weight_decay, device=device)
    total_params = num_params(state)
    logger.info(f"Total parameters: {total_params:,}")

    start_epoch = 0
    if args.resume:
        state, last_epoch, _ = load_checkpoint(state, args.resume)
        start_epoch = last_epoch + 1
        # The loader's shuffle-epoch counter: a resumed run sees the same
        # per-epoch sample order as an uninterrupted one.
        train_loader.epoch = start_epoch
    state = shard_state(mesh, state, fsdp=args.fsdp, tp=n_model > 1)
    group, space = group_of(mesh), mesh_exchanger(mesh)

    class_weights = parse_class_weights(args.class_weights, num_classes)
    loss_cfg = SegLossConfig(ce_weight=args.ce_weight, dice_weight=args.dice_weight,
                             focal_weight=args.focal_weight, class_weights=class_weights)
    augment = dataclasses.replace(workload.augment, rotation_mode=args.rotation_mode,
                                  color_jitter_random_order=args.color_jitter_random_order)
    train_step = make_seg_train_step(num_classes, loss_cfg, augment,
                                     grad_accum=args.grad_accum, group=group, space=space)
    eval_step = make_seg_eval_step(num_classes, loss_cfg, group=group, space=space)

    logger.info("Starting training...")
    train_losses, val_losses = [], []
    best_val_miou = 0.0
    history_path = os.path.join(output_dirs["results"], "history.jsonl")
    ckpt_dir = output_dirs["checkpoints"]
    interrupted_at = None  # the epoch SIGTERM cut short

    ckpt_writer = CheckpointWriter()  # async: file writes overlap training
    intr = GracefulInterrupt().install()  # SIGTERM -> checkpoint, not death
    try:
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            with span("train", epoch):
                train_metrics, train_cm = train_seg_epoch(
                    state, train_step, train_loader, args.seed, epoch, num_classes,
                    progress_fn=logger.info, progress_every=args.progress_every,
                    should_stop=intr.step_poll())
            if intr.poll_global():
                # SIGTERM: this epoch may be partial, so the checkpoint names
                # epoch - 1 as the last completed one and --resume replays
                # the interrupted epoch from its start.
                ipath = interrupt_checkpoint_path(ckpt_dir)
                ckpt_writer.save(state, epoch - 1, train_metrics.get("total_loss", 0.0), ipath)
                ckpt_writer.wait()
                interrupted_at = epoch
                logger.info(f"SIGTERM received: training interrupted during "
                            f"epoch {epoch}; resume with --resume {ipath}")
                break
            train_losses.append(train_metrics.get("total_loss", 0.0))
            train_miou = float(np.nanmean(train_cm.compute_iou()))
            history = {"epoch": epoch, "train_miou": train_miou, **train_metrics}

            val_results = None
            if epoch % args.val_freq == 0 or epoch == args.epochs - 1:
                with span("validate", epoch):
                    val_metrics, val_cm = validate_seg_epoch(
                        state, eval_step, val_loader, num_classes,
                        ignore_index=loss_cfg.ignore_index)
                val_losses.append(val_metrics.get("total_loss", 0.0))
                val_all = val_cm.compute_all_metrics()
                val_results = (val_metrics, val_all)
                history.update({
                    "val_loss": val_metrics.get("total_loss", 0.0),
                    "val_miou": float(val_all["mean_iou"]),
                    "val_dice": float(val_all["mean_dice"]),
                    "val_pixel_accuracy": float(val_all["pixel_accuracy"]),
                })
                if val_all["mean_iou"] > best_val_miou:
                    best_val_miou = val_all["mean_iou"]
                    ckpt_writer.save(state, epoch, val_metrics.get("total_loss", 0.0),
                                     os.path.join(ckpt_dir, "best_model.pth"))
                    logger.info(f"New best model saved with mIoU: {best_val_miou:.4f}")

            msg = (f"Epoch {epoch}/{args.epochs - 1}: "
                   f"train loss {train_metrics.get('total_loss', 0):.4f} "
                   f"mIoU {train_miou:.4f}")
            if val_results:
                msg += (f" | val loss {val_results[0].get('total_loss', 0):.4f} "
                        f"mIoU {val_results[1]['mean_iou']:.4f} "
                        f"dice {val_results[1]['mean_dice']:.4f}")
            dt = time.time() - t0
            logger.info(msg + f" ({dt:.1f}s)")
            history["epoch_seconds"] = round(dt, 3)
            if main_rank:
                append_jsonl(history, history_path)  # live, crash-surviving record

            if epoch % args.save_freq == 0 or epoch == args.epochs - 1:
                ckpt_writer.save(state, epoch, train_metrics.get("total_loss", 0.0),
                                 os.path.join(ckpt_dir, f"checkpoint_epoch_{epoch}.pth"))
    finally:
        ckpt_writer.close()  # flush the write in flight, even on error
        intr.uninstall()
    results = {
        "train_losses": train_losses,
        "val_losses": val_losses,
        "best_val_miou": best_val_miou,
        "total_epochs": args.epochs,
        "total_params": total_params,
        "num_classes": num_classes,
        "interrupted": interrupted_at is not None,
        "args": vars(args),
    }
    if main_rank:
        save_json(results, os.path.join(output_dirs["results"], "training_results.json"))
    if interrupted_at is not None:
        logger.info(f"Training interrupted (SIGTERM) during epoch "
                    f"{interrupted_at}; partial results saved to: {experiment_dir}")
    else:
        logger.info("Training completed!")
        logger.info(f"Best validation mIoU: {best_val_miou:.4f}")
        logger.info(f"Results saved to: {experiment_dir}")
    return {**results, "checkpoint_writes": ckpt_writer.writes}


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def run_seg_evaluation(args, workload: Workload, split: str = "test"):
    """The evaluator: flag checks, device, datasets, the evaluation
    (:func:`make_eval_loader`, :func:`load_seg_model`, ``validate_seg_epoch``,
    :func:`save_seg_results`), then the confusion-matrix PNG and, with
    ``--save_predictions``, the prediction panels. Returns the summary (None
    on ranks other than 0). Under ``--n_devices`` every rank evaluates its
    rows and rank 0 writes."""
    world = check_eval_flags(args, workload.image_size_hw(args)[0])
    device = cli_device(args.device)
    if is_main_process():
        print(_device_line(device, world, n_space=args.n_space))
    summary = launch(_eval_rank, (args, workload, split), n_devices=args.n_devices,
                     device_type=device.type, n_space=args.n_space)
    return summary if is_main_process() else None


def _eval_rank(args, workload: Workload, split: str):
    device = cli_device(args.device)
    main_rank = is_main_process()
    train_ds, val_ds, test_ds, num_classes, class_names = workload.make_datasets(args)
    ds = {"train": train_ds, "val": val_ds, "test": test_ds}[split]
    if args.debug:
        ds = _Subset(ds, args.debug_samples, 0)
    if main_rank:
        print(f"Eval samples ({split}): {len(ds)}")

    mesh = eval_mesh(args, device)
    state, eval_step, loss_cfg = load_seg_model(args, num_classes, device, train_ds, mesh)
    loader = make_eval_loader(args, ds, device, mesh)
    losses, cm = validate_seg_epoch(state, eval_step, loader, num_classes,
                                    ignore_index=loss_cfg.ignore_index)
    summary = None
    if main_rank:
        summary = save_seg_results(args, losses, cm, class_names)
        cm.plot_confusion_matrix(class_names,
                                 os.path.join(args.output_dir, "confusion_matrix.png"))
    if args.save_predictions:
        _save_prediction_panels(state, eval_step, loader, class_names, args.output_dir)
    return summary


def eval_mesh(args, device: torch.device):
    """The evaluator's mesh: the group's ranks over ('data', 'space') with
    ``--n_space`` (None in one process)."""
    n_space = getattr(args, "n_space", 1)
    return make_mesh(world_size() // n_space, n_space=n_space, device_type=device.type)


def make_eval_loader(args, ds, device: torch.device, mesh=None) -> DataLoader:
    """The evaluated split's loader: padded last batch, batches on ``device``
    (this data rank of ``mesh``'s rows of each; :func:`eval_mesh`)."""
    count, index = data_coords(mesh)
    return DataLoader(ds, args.batch_size, pad_last=True, num_workers=args.num_workers,
                      transform=lambda b: to_device(b, device), process_count=count,
                      process_index=index)


def int8_arch(model: str) -> str:
    """The int8 plan of a seg CLI's ``--model``; SystemExit for one without."""
    if model in UNETPP_NAMES:
        return "unetpp"
    if model in ATTN_NAMES:
        return "attn_unet"
    if model in ("seg_unet", "segmentation_unet"):
        return "seg_unet"
    raise SystemExit("--quantize int8 supports seg_unet, attn_unet and unetpp (both "
                     "decoder modes; bilinear upsamples run as float islands)")


def load_seg_model(args, num_classes: int, device: torch.device, calib_ds=None,
                   mesh=None):
    """``(state, eval_step, loss_cfg)`` for ``--checkpoint`` on ``device``
    (the step reduces its losses and matrix over ``mesh``'s batch group,
    and under ``--n_space`` runs on the rank's rows of each image;
    :func:`eval_mesh`, None in one process):
    BN folded with ``--fold_bn``; ``--heads k < 4`` evaluates UNet++'s
    deep-supervision head X[0][k] alone (the full parameter tree is built
    and loaded). With ``--quantize int8`` the step is the int8 one (K2 for
    every 3x3 conv), calibrated over the full model (every UNet++ node,
    whatever ``--heads``) on the first ``--calib_samples`` images of
    ``calib_ds`` in chunks of 8."""
    heads = args.heads
    model = build_model(args.model, n_channels=3, n_classes=num_classes,
                        bilinear=args.bilinear, dropout=args.dropout,
                        policy=get_policy(args.precision), base_features=args.base_features,
                        deep_supervision=args.deep_supervision, heads=heads)
    state = create_train_state(model, "adam", 1e-3, 0.0, device=device)
    say = print if is_main_process() else (lambda *a, **k: None)
    say(f"Loading checkpoint: {args.checkpoint}")
    state = load_params(state, args.checkpoint)
    if args.fold_bn:
        from tpu_unet_torch.ops.fold_bn import fold_batchnorm
        fold_batchnorm(state.model)
        say("BatchNorm folded into conv weights for inference")
    if heads != 4:
        say(f"Pruned fast mode: evaluating head X[0][{heads}] only")

    group, space = group_of(mesh), mesh_exchanger(mesh)
    loss_cfg = SegLossConfig(class_weights=parse_class_weights(args.class_weights,
                                                               num_classes))
    if args.quantize != "int8":
        return (state, make_seg_eval_step(num_classes, loss_cfg, group=group, space=space),
                loss_cfg)
    arch = int8_arch(args.model)
    from tpu_unet_torch.ops.quantize import (chunk_calibration, make_quantized_seg_eval_step,
                                             quantize_from_train_state)
    n_calib = min(len(calib_ds), args.calib_samples)
    calib_imgs = np.stack([calib_ds.load(i)["image"] for i in range(n_calib)])
    qparams = broadcast_tensors(  # rank 0's calibration on every rank
        quantize_from_train_state(arch, state.model.state_dict(),
                                  chunk_calibration(calib_imgs, 8),
                                  percentile=args.calib_percentile, device=device,
                                  deep_supervision=args.deep_supervision), group)
    say(f"int8 quantized inference (calibrated on {n_calib} train images)")
    qstep = make_quantized_seg_eval_step(num_classes, loss_cfg, arch=arch,
                                         deep_supervision=args.deep_supervision, heads=heads,
                                         group=group, space=space)
    return state, QuantizedEvalStep(qstep, qparams), loss_cfg


class QuantizedEvalStep:
    """An int8 eval step (seg, or MVTec's in ``test_mvtec``) over its
    ``qparams``, with the float step's signature (the state is not read)."""

    def __init__(self, qstep, qparams):
        self.qstep, self.qparams = qstep, qparams

    def __call__(self, _state, images, labels, valid=None):
        return self.qstep(self.qparams, images, labels, valid)


def save_seg_results(args, losses: dict, cm, class_names) -> dict:
    """Print the metrics of ``cm`` (a SegmentationMetrics) and write
    ``<output_dir>/evaluation_results.json``, the JAX package's keys;
    returns its dict."""
    metrics = cm.compute_all_metrics()
    cm.print_metrics(class_names)
    summary = {
        "evaluation_args": vars(args),
        "overall_metrics": {
            "pixel_accuracy": float(metrics["pixel_accuracy"]),
            "mean_accuracy": float(metrics["mean_accuracy"]),
            "mean_iou": float(metrics["mean_iou"]),
            "mean_dice": float(metrics["mean_dice"]),
            "mean_precision": float(metrics["mean_precision"]),
            "mean_recall": float(metrics["mean_recall"]),
            "mean_f1": float(metrics["mean_f1"]),
        },
        "per_class_metrics": {
            "iou": metrics["iou_per_class"].tolist(),
            "dice": metrics["dice_per_class"].tolist(),
            "precision": metrics["precision_per_class"].tolist(),
            "recall": metrics["recall_per_class"].tolist(),
            "f1": metrics["f1_per_class"].tolist(),
        },
        "confusion_matrix": metrics["confusion_matrix"].tolist(),
        "loss": losses,
    }
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "evaluation_results.json")
    save_json(summary, path)
    print(f"Results summary saved to: {path}")
    return summary


def _save_prediction_panels(state, eval_step, loader, class_names, output_dir,
                            max_batches: int = 5, per_batch: int = 4):
    """Up to 4 panels (image, ground truth, prediction) for each of the first
    5 batches (matplotlib). Every rank runs the batches (the step reduces
    over the group); rank 0 draws its rows."""
    from tpu_unet_torch.ops.augment import eval_transform
    from tpu_unet_torch.utils.viz import _plt, denormalize_image

    plt = _plt()
    for batch_idx, batch in enumerate(loader):
        if batch_idx >= max_batches:
            break
        _, preds, _ = eval_step(state, batch["image"], batch["mask"])
        if not is_main_process():
            continue
        preds = preds.cpu().numpy()
        images = eval_transform(batch["image"]).cpu().numpy()
        masks = batch["mask"].cpu().numpy()
        valid = batch["valid"].cpu().numpy() if "valid" in batch else None
        for i in range(min(per_batch, images.shape[0])):
            if valid is not None and not valid[i]:
                continue
            fig, axes = plt.subplots(1, 3, figsize=(15, 5))
            axes[0].imshow(denormalize_image(images[i]))
            axes[0].set_title("Original Image")
            axes[0].axis("off")
            axes[1].imshow(masks[i], cmap="tab10", vmin=0, vmax=len(class_names) - 1)
            axes[1].set_title("Ground Truth")
            axes[1].axis("off")
            axes[2].imshow(preds[i], cmap="tab10", vmin=0, vmax=len(class_names) - 1)
            axes[2].set_title("Prediction")
            axes[2].axis("off")
            fig.tight_layout()
            stem = os.path.basename(batch["image_path"][i]).split(".")[0]
            fig.savefig(os.path.join(output_dir,
                                     f"prediction_batch{batch_idx}_img{i}_{stem}.png"),
                        dpi=150, bbox_inches="tight")
            plt.close(fig)
