"""Benchmark of the port on one GPU (counterpart of the repo's ``bench.py``).

    python -m tpu_unet_torch.bench            # on the card
    python -m tpu_unet_torch.bench --device cpu --base_features 4 --image_size 32 ...

Prints ONE JSON line on stdout, with the keys of the JAX benchmark's line
plus ``device``; progress and the kernels' launch counts go to stderr. It
times, on one device:

- the flagship training step: AnomalyUNet (base 64), bf16, 256², batch 16,
  Adam (lr 1e-3, L2 1e-4), the default augment, on device-resident
  synthetic data: warm-up steps, then the best (``value``) and the median of
  timed windows of back-to-back steps;
- the BN-folded eval step at batch 16 (its loss fetched every batch) and at
  128 (only the scores fetched, at the end): K1 once per batch;
- ``serve.AnomalyScorer`` at batch 128, score-only, in bf16 and in int8
  calibrated on 32 seeded images (K1 once and K2 18 times per batch);
- the ``per_sample`` and ``per_sample_shear`` rotation modes;
- the BASELINE configs: UNet with focal loss, AnomalyUNet with SSIM,
  KolektorSDD 1024 x 512 b8 (class weights 1:50:50) and Gear 512² b8 (config
  2 is the flagship, config 5 the flagship per category);
- whole epochs through the real loader: a synthetic tree of 320² PNGs
  (under ``--cache_dir``) -> ``MVTecDataset`` with a pack (under
  ``--cache_dir`` too) -> ``DataLoader`` threads -> pinned uint8 uploads ->
  the train step, driven by ``train/loop.py::train_anomaly_epoch``: one
  warm epoch, then the best and the median of timed epochs.

Timing follows the JAX benchmark: each step draws its augment (and the seg
model's dropout) from a seeded ``torch.Generator`` inside the window; the
losses stay on the device and one fetch at the window's end ends it.

FLOPs: ``fwd_flops`` is the model's forward over the batch from the layer
shapes (``utils/flops.py``); ``mfu`` is 3 x that x steps/s over the bf16
peak. ``step_flops`` is PyTorch's ``FlopCounterMode`` count of one whole
train step (convolutions and matrix products, forward and backward, the
augment's shear products too), counted on a warm-up step outside every
window; ``hfu`` is that x steps/s over the peak. ``step_hbm_bytes`` and
``hbm_bw_fraction`` are null: PyTorch has no count of the bytes a step
moves. ``TPU_UNET_PEAK_FLOPS`` overrides the bf16 peak of the line's shares,
as in the JAX benchmark. ``torch.backends`` settings are left as the port's
trainers leave them.

The flags exist to run small (the tests run it on the CPU); their defaults
are the JAX benchmark's sizes. The batches are its constants. ``--device cuda`` (the default) raises when
there is no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
from tpu_unet_torch.ops.kernels.preprocess import normalize_u8
from tpu_unet_torch.train.state import TrainState, create_train_state
from tpu_unet_torch.train.steps import (AnomalyLossConfig, AugmentConfig, SegLossConfig,
                                        make_anomaly_eval_step, make_anomaly_train_step,
                                        make_seg_train_step)
from tpu_unet_torch.utils import flops
from tpu_unet_torch.utils.flops import forward_flops, seg_forward_flops

METRIC = "mvtec_bottle_anomaly_unet_train_images_per_sec_per_chip"
BATCH = 16
IMAGE_SIZE = 256
WARMUP = 3
STEPS = 20          # the flagship's window; a config's is half of it
TRIALS = 3
SERVE_BATCH = 128
CALIB_IMAGES = 32
SEG_BATCH = 8
SEG_SIZES = "1024x512,512x512"  # KolektorSDD, Gear
E2E_IMAGES = 512
E2E_SRC_SIZE = 320
CONFIGS = ("1_unet_focal_256_b16", "3_anomaly_unet_ssim_256_b16",
           "4_kolektorsdd_1024x512_b8", "gear_512_b8")
SWEEP_NOTE = "config 2's step per category (sweep CLI)"
# Every entry of the line's ``baseline_configs`` (the JAX benchmark's six).
BASELINE_CONFIGS = (CONFIGS[0], "2_anomaly_unet_256_b16", CONFIGS[1], CONFIGS[2],
                    "5_sweep_per_category", CONFIGS[3])
# The line's keys: the JAX benchmark's, then the card it was measured on.
LINE_KEYS = (
    "metric", "value", "unit", "median_images_per_sec_per_chip", "vs_baseline",
    "train_e2e_images_per_sec_per_chip", "train_e2e_vs_device_only", "train_e2e",
    "infer_images_per_sec_per_chip", "infer_serving_b128_images_per_sec_per_chip",
    "serve_score_only_b128_images_per_sec_per_chip", "serve_int8_b128_images_per_sec_per_chip",
    "train_per_sample_rotation_images_per_sec_per_chip",
    "train_per_sample_shear_rotation_images_per_sec_per_chip",
    "batch", "image_size", "mfu", "hfu", "hbm_bw_fraction", "step_flops", "fwd_flops",
    "step_hbm_bytes", "peak_flops_bf16", "baseline_configs", "device")
# The bf16 peak of ``mfu`` and ``hfu``, under the JAX benchmark's variable.
PEAK_FLOPS_BF16 = float(os.environ.get("TPU_UNET_PEAK_FLOPS", flops.PEAK_FLOPS_BF16))


def _say(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def make_synth_mvtec_tree(root: str, n_train: int = E2E_IMAGES,
                          src_size: int = E2E_SRC_SIZE) -> str:
    """A synthetic MVTec category ``bottle`` under ``root`` for the e2e
    epochs: ``n_train`` smooth low-frequency PNGs of ``src_size``², so file
    size and decode cost resemble photographs. The JAX benchmark's tree,
    array for array (seed 42). A marker file holding the parameters skips
    the writing on a rerun; other parameters rewrite the tree."""
    from PIL import Image

    cat = os.path.join(root, "bottle")
    marker = os.path.join(root, ".complete")
    params = f"n_train={n_train} src={src_size}\n"
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == params:
                return root
        shutil.rmtree(root)
    os.makedirs(os.path.join(cat, "train", "good"), exist_ok=True)
    os.makedirs(os.path.join(cat, "test", "good"), exist_ok=True)
    rng = np.random.default_rng(42)
    rep = src_size // 20
    for i in range(n_train):
        low = rng.integers(0, 256, (20, 20, 3)).astype(np.float32)
        img = np.kron(low, np.ones((rep, rep, 1), np.float32))[:src_size, :src_size]
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(cat, "train", "good", f"{i:04d}.png"))
    with open(marker, "w") as f:
        f.write(params)
    return root


def device_info(device: torch.device) -> Dict[str, Optional[str]]:
    """The device a line was measured on: the card's name and, where
    ``nvidia-smi`` exists, its name and power limit as that prints them."""
    if device.type != "cuda":
        return {"name": "cpu", "nvidia_smi": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = None
    exe = shutil.which("nvidia-smi")
    if exe:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader",
                              f"--id={index}"], capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            smi = out.stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(index), "nvidia_smi": smi}


class _Launches:
    """K1's and K2's launch counts per leg: the counters read before and
    after each leg, summed over a leg's runs (they count kernel launches
    only, so on the CPU, where the plain versions run, every count is 0)."""

    def __init__(self):
        self.legs: Dict[str, Dict[str, int]] = {}

    @contextlib.contextmanager
    def leg(self, name: str, batches: Optional[int] = None):
        k1, k2 = normalize_u8.launches, conv3x3_int8.launches
        yield
        rec = self.legs.setdefault(name, {"normalize_u8": 0, "conv3x3_int8": 0})
        rec["normalize_u8"] += normalize_u8.launches - k1
        rec["conv3x3_int8"] += conv3x3_int8.launches - k2
        if batches is not None:
            rec["batches"] = batches


def _losses(out) -> Dict[str, torch.Tensor]:
    """The loss dict of a train step's output (the seg steps return
    ``(losses, confusion matrix)``)."""
    return out[0] if isinstance(out, tuple) else out


def _fetch(losses: List[torch.Tensor]) -> np.ndarray:
    """Every loss in one device-to-host copy; raises on a non-finite one."""
    vals = torch.stack([v.detach().to(torch.float32) for v in losses]).cpu().numpy()
    if not np.isfinite(vals).all():
        raise RuntimeError(f"non-finite training loss: {vals}")
    return vals


def _warm(state, step, images, labels, warmup: int, device) -> float:
    """``warmup`` steps; returns PyTorch's count (``FlopCounterMode``) of
    the first one's FLOPs: its convolutions and matrix products, forward and
    backward, but no elementwise work, reduction, normalisation or optimizer
    update. The last loss is fetched, so the queue is drained."""
    g = torch.Generator(device=device).manual_seed(0)
    with FlopCounterMode(display=False) as counter:
        out = step(state, images, labels, g)
    acc = [_losses(out)["total_loss"]]
    for _ in range(warmup - 1):
        acc.append(_losses(step(state, images, labels, g))["total_loss"])
    _fetch(acc)
    return float(counter.get_total_flops())


def _window(state, step, images, labels, steps: int, seed: int, device) -> float:
    """Seconds of ``steps`` train steps enqueued back to back, their draws
    made in the window; the fetch of every loss at the end ends it."""
    g = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    acc = [_losses(step(state, images, labels, g))["total_loss"] for _ in range(steps)]
    _fetch(acc)
    return time.perf_counter() - t0


def _timed_train(state, step, images, labels, args, device, steps: int, trials: int,
                 seed: int) -> Tuple[List[float], float]:
    """(each window's seconds, the step's counted FLOPs) after the warm-up."""
    flops = _warm(state, step, images, labels, args.warmup, device)
    return [_window(state, step, images, labels, steps, seed, device)
            for _ in range(trials)], flops


def _config_result(n: int, steps: int, dts: Sequence[float], step_flops: float,
                   fwd_flops: float) -> Dict:
    """A config's throughput (best window), median and per-window img/s,
    with its FLOP shares of the bf16 peak (as the JAX benchmark's)."""
    trial_ips = [round(n * steps / dt, 2) for dt in dts]
    sps = steps / min(dts)
    return {"images_per_sec_per_chip": round(n * steps / min(dts), 2),
            "median_images_per_sec_per_chip": round(float(np.median(trial_ips)), 2),
            "trial_images_per_sec": trial_ips,
            "hfu": step_flops * sps / PEAK_FLOPS_BF16,
            "mfu": 3.0 * fwd_flops * sps / PEAK_FLOPS_BF16}


def _release(device) -> None:
    """Hand the freed blocks back, so the next config does not run beside
    the last one's cached memory."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _bench_train_e2e(args, device, state: TrainState) -> Dict:
    """Training epochs of ``state`` (a fresh flagship) through the real
    input pipeline: the synthetic PNG tree -> ``MVTecDataset`` (decode and
    resize, the pack) -> ``DataLoader`` threads (8 workers, prefetch 4) ->
    pinned uint8 image and mask uploads -> the flagship's train step, driven
    by ``train_anomaly_epoch``. One warm epoch (it builds the pack), then
    ``--trials`` timed epochs, each ended by the epoch's loss fetch."""
    from tpu_unet_torch.data.loader import DataLoader, to_device
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.train.loop import train_anomaly_epoch

    root = make_synth_mvtec_tree(os.path.join(args.cache_dir, "e2e_mvtec"),
                                 args.e2e_images, E2E_SRC_SIZE)
    ds = MVTecDataset(root, "bottle", "train", args.image_size, is_train=True,
                      disk_cache_dir=os.path.join(args.cache_dir, "pack"))
    loader = DataLoader(ds, BATCH, shuffle=True, seed=0, drop_last=True,
                        num_workers=8, prefetch=4,
                        transform=lambda b: to_device(b, device, mask_dtype=np.uint8))
    step = make_anomaly_train_step(aug_cfg=AugmentConfig())
    train_anomaly_epoch(state, step, loader, 0, 0)
    n_epoch = (len(ds) // BATCH) * BATCH
    trial_ips = []
    for e in range(1, args.trials + 1):
        t0 = time.perf_counter()
        out = train_anomaly_epoch(state, step, loader, 0, e)
        dt = time.perf_counter() - t0
        if not np.isfinite(out["total_loss"]):
            raise RuntimeError(f"e2e epoch {e}: non-finite loss {out}")
        trial_ips.append(round(n_epoch / dt, 2))
    return {
        "images_per_sec_per_chip": max(trial_ips),
        "median_images_per_sec_per_chip": round(float(np.median(trial_ips)), 2),
        "trial_images_per_sec": trial_ips,
        "images_per_epoch": n_epoch,
        "pipeline": f"on-disk {E2E_SRC_SIZE}^2 PNG -> pack of {args.image_size}^2 u8 -> "
                    f"loader threads (prefetch=4) -> pinned u8 image+mask upload -> "
                    f"train step",
    }


def _parse_hw(text: str) -> Tuple[int, int]:
    h, w = text.lower().split("x")
    return int(h), int(w)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) "
                   "or cpu")
    p.add_argument("--base_features", type=int, default=64)
    p.add_argument("--image_size", type=int, default=IMAGE_SIZE,
                   help="the MVTec models' square size")
    p.add_argument("--seg_sizes", default=SEG_SIZES,
                   help="KolektorSDD's and Gear's HxW, comma separated")
    p.add_argument("--steps", type=int, default=STEPS,
                   help="steps per flagship, eval, serving and rotation-mode window; "
                        "a config's window is half (at least 1)")
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--trials", type=int, default=TRIALS,
                   help="timed windows (and e2e epochs) per best-of")
    p.add_argument("--e2e_images", type=int, default=E2E_IMAGES)
    p.add_argument("--cache_dir",
                   default=os.path.join(os.path.expanduser("~"), ".cache",
                                        "tpu_unet_torch_bench"),
                   help="holds the e2e PNG tree and its pack")
    p.add_argument("--configs", default=",".join(CONFIGS),
                   help="the BASELINE configs to time besides the flagship, comma "
                        f"separated, of: {', '.join(CONFIGS)}")
    args = p.parse_args(argv)
    args.seg_hw = [_parse_hw(s) for s in args.seg_sizes.split(",")]
    if len(args.seg_hw) != 2:
        p.error("--seg_sizes takes two sizes: KolektorSDD's and Gear's")
    args.configs = [c for c in args.configs.split(",") if c]
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        p.error(f"unknown --configs {unknown}; choose from {list(CONFIGS)}")
    if min(args.steps, args.warmup, args.trials) < 1:
        p.error("--steps, --warmup and --trials must be at least 1")
    if args.e2e_images < BATCH:
        p.error(f"--e2e_images {args.e2e_images} is under one batch of {BATCH}")
    return args


def run(args) -> Tuple[Dict, Dict]:
    """The benchmark; returns (the line, the launch counts per leg)."""
    from tpu_unet_torch.ops.fold_bn import fold_batchnorm
    from tpu_unet_torch.serve import AnomalyScorer

    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    policy = get_policy("bf16")
    base, size, batch = args.base_features, args.image_size, BATCH
    steps, config_steps = args.steps, max(1, args.steps // 2)
    launches = _Launches()
    rng = np.random.default_rng(0)

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    def new_state(name: str, seed: int, **kw) -> TrainState:
        torch.manual_seed(seed)
        return create_train_state(build_model(name, base_features=base, policy=policy, **kw),
                                  "adam", 1e-3, 1e-4, device=device)

    # --- the flagship ---------------------------------------------------------
    _say(f"flagship: AnomalyUNet base {base}, bf16, {size}², b{batch}, on {device}")
    state = new_state("anomaly_unet", 0)
    step = make_anomaly_train_step(aug_cfg=AugmentConfig())
    images = on_device(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8))
    masks = torch.zeros((batch, size, size, 1), dtype=torch.float32, device=device)
    fwd_flops = float(forward_flops(base, size) * batch)
    with launches.leg("train"):
        trial_dts, step_flops = _timed_train(state, step, images, masks, args, device,
                                             steps, args.trials, 100)
    per_chip = batch * steps / min(trial_dts)
    median_per_chip = batch * steps / float(np.median(trial_dts))
    steps_per_sec = per_chip / batch
    mfu = 3.0 * fwd_flops * steps_per_sec / PEAK_FLOPS_BF16
    hfu = step_flops * steps_per_sec / PEAK_FLOPS_BF16

    # --- the BN-folded eval step: b16 fetching each loss, b128 the scores ----
    _say(f"eval step, BN folded: b{batch}, then b{SERVE_BATCH}")
    istate = TrainState(fold_batchnorm(copy.deepcopy(state.model)), None)
    eval_step = make_anomaly_eval_step()
    with launches.leg("eval_b16", batches=steps + 1):
        float(eval_step(istate, images, masks)["losses"]["total_loss"])
        t0 = time.perf_counter()
        for _ in range(steps):
            float(eval_step(istate, images, masks)["losses"]["total_loss"])
        infer_per_chip = batch * steps / (time.perf_counter() - t0)
    imgs_s = on_device(rng.integers(0, 256, (SERVE_BATCH, size, size, 3), dtype=np.uint8))
    msks_s = torch.zeros((SERVE_BATCH, size, size, 1), dtype=torch.float32, device=device)
    with launches.leg("eval_b128", batches=steps + 1):
        float(eval_step(istate, imgs_s, msks_s)["losses"]["total_loss"])
        t0 = time.perf_counter()
        scores = [eval_step(istate, imgs_s, msks_s)["score"] for _ in range(steps)]
        s = torch.cat(scores).cpu().numpy()
        serve_per_chip = SERVE_BATCH * steps / (time.perf_counter() - t0)
    if not np.isfinite(s).all():
        raise RuntimeError("non-finite eval scores at b128")
    del istate, imgs_s, msks_s, scores
    _release(device)

    # --- serve.py: the score-only program in bf16 and int8 ---------------------
    _say(f"AnomalyScorer b{SERVE_BATCH}: bf16, then int8")
    state_dict = state.model.state_dict()
    scorer = AnomalyScorer.from_state_dict(state_dict, image_size=size, batch_size=SERVE_BATCH,
                                           base_features=base, device=device)
    with launches.leg("serve_bf16_b128", batches=steps + 1):
        serve_bf16 = scorer.throughput(steps)
    del scorer
    calib = rng.integers(0, 256, (CALIB_IMAGES, size, size, 3), dtype=np.uint8)
    with launches.leg("serve_int8_calibration", batches=-(-CALIB_IMAGES // 16)):
        scorer = AnomalyScorer.from_state_dict(state_dict, image_size=size,
                                               batch_size=SERVE_BATCH, base_features=base,
                                               quantize="int8", calib_images=calib,
                                               device=device)
    with launches.leg("serve_int8_b128", batches=steps + 1):
        serve_int8 = scorer.throughput(steps)
    del scorer, state_dict
    _release(device)

    baseline_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "BASELINE_MEASURED.json")
    vs_baseline = None
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            ref_ips = json.load(f).get("train_images_per_sec_cpu")
        if ref_ips:
            vs_baseline = per_chip / ref_ips

    # --- the rotation modes, on a second state ------------------------------------
    rotation = {}
    state2 = new_state("anomaly_unet", 1)
    for mode in ("per_sample", "per_sample_shear"):
        _say(f"rotation_mode={mode}")
        step_m = make_anomaly_train_step(aug_cfg=AugmentConfig(rotation_mode=mode))
        with launches.leg("train"):
            dts, _ = _timed_train(state2, step_m, images, masks, args, device, steps, 1,
                                  300 if mode == "per_sample" else 400)
        rotation[mode] = batch * steps / dts[0]
    del state2
    _release(device)

    # --- the BASELINE configs -------------------------------------------------------
    configs: Dict[str, object] = {}

    def bench_config(name, state_c, step_c, imgs, lbls, fwd):
        _say(f"config {name}")
        with launches.leg("train"):
            dts, flops = _timed_train(state_c, step_c, imgs, lbls, args, device,
                                      config_steps, args.trials, 500)
        configs[name] = _config_result(imgs.shape[0], config_steps, dts, flops, fwd)

    if CONFIGS[0] in args.configs:
        unet = new_state("unet", 2, n_classes=1)
        bench_config(CONFIGS[0], unet,
                     make_anomaly_train_step(aug_cfg=AugmentConfig(), dual_decoder=False),
                     images, masks, float(seg_forward_flops(base, size, size, 1) * batch))
        del unet
        _release(device)
    configs["2_anomaly_unet_256_b16"] = {
        "images_per_sec_per_chip": round(per_chip, 2), "mfu": mfu, "hfu": hfu,
        "hbm_bw_fraction": None}
    if CONFIGS[1] in args.configs:
        # the flagship's model and state, as the JAX benchmark reuses them
        bench_config(CONFIGS[1], state,
                     make_anomaly_train_step(AnomalyLossConfig(recon_loss_type="ssim"),
                                             AugmentConfig()),
                     images, masks, fwd_flops)
    del state, images, masks
    _release(device)
    configs["5_sweep_per_category"] = SWEEP_NOTE
    for name, n_classes, seed, hw, loss_cfg, aug_cfg in (
            (CONFIGS[2], 3, 3, args.seg_hw[0], SegLossConfig(class_weights=(1.0, 50.0, 50.0)),
             AugmentConfig(degrees=5.0)),
            (CONFIGS[3], 4, 4, args.seg_hw[1], SegLossConfig(),
             AugmentConfig(degrees=10.0, brightness=0.2, contrast=0.2, saturation=0.2,
                           hue=0.1))):
        if name not in args.configs:
            continue
        seg = new_state("seg_unet", seed, n_classes=n_classes)
        imgs = on_device(rng.integers(0, 256, (SEG_BATCH, *hw, 3), dtype=np.uint8))
        lbls = on_device(rng.integers(0, n_classes, (SEG_BATCH, *hw)).astype(np.int32))
        bench_config(name, seg, make_seg_train_step(n_classes, loss_cfg, aug_cfg), imgs, lbls,
                     float(seg_forward_flops(base, *hw, n_classes) * SEG_BATCH))
        del seg, imgs, lbls
        _release(device)

    # --- whole epochs through the loader ------------------------------------------
    _say(f"e2e: {args.e2e_images} PNGs under {args.cache_dir}")
    with launches.leg("train"):
        e2e = _bench_train_e2e(args, device, new_state("anomaly_unet", 7))
    _release(device)

    line = {
        "metric": METRIC,
        "value": round(per_chip, 2),
        "unit": "images/sec/chip",
        "median_images_per_sec_per_chip": round(median_per_chip, 2),
        "vs_baseline": round(vs_baseline, 2) if vs_baseline is not None else None,
        "train_e2e_images_per_sec_per_chip": e2e["images_per_sec_per_chip"],
        "train_e2e_vs_device_only": round(e2e["images_per_sec_per_chip"] / per_chip, 3),
        "train_e2e": e2e,
        "infer_images_per_sec_per_chip": round(infer_per_chip, 2),
        "infer_serving_b128_images_per_sec_per_chip": round(serve_per_chip, 2),
        "serve_score_only_b128_images_per_sec_per_chip": round(serve_bf16, 2),
        "serve_int8_b128_images_per_sec_per_chip": round(serve_int8, 2),
        "train_per_sample_rotation_images_per_sec_per_chip": round(rotation["per_sample"], 2),
        "train_per_sample_shear_rotation_images_per_sec_per_chip":
            round(rotation["per_sample_shear"], 2),
        "batch": batch,
        "image_size": size,
        "mfu": mfu,
        "hfu": hfu,
        "hbm_bw_fraction": None,   # no count of a step's bytes in PyTorch
        "step_flops": step_flops,
        "fwd_flops": fwd_flops,
        "step_hbm_bytes": None,
        "peak_flops_bf16": PEAK_FLOPS_BF16,
        "baseline_configs": configs,
        "device": device_info(device),
    }
    return line, launches.legs


def main(argv=None) -> Tuple[Dict, Dict]:
    """Run the benchmark, print its line on stdout and the launch counts on
    stderr; returns both. Whatever the modules print while it runs goes to
    stderr, so stdout holds the one line."""
    args = parse_args(argv)
    out = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        line, legs = run(args)
    print(json.dumps({"kernel_launches": legs}), file=sys.stderr, flush=True)
    print(json.dumps(line), file=out, flush=True)
    return line, legs


if __name__ == "__main__":
    main()
