#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tpu_unet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from tpu_unet_torch/csrc (one nvcc each, in
   parallel) and prints the build time, ptxas's register and spill report and
   a count of the tensor-core and TMA instructions in the built code; then
   the host loader core (csrc/loader_core.cpp, g++).
2. K1 (normalize_u8) at the serving batch (128, 256, 256, 3): kernel against
   its plain PyTorch version on the card and on the CPU, bit for bit, in
   float32 and bfloat16; both timed, beside their bounds.
3. K2 (conv3x3_int8) at the 18 conv shapes of the int8 score path at batch 8,
   plus one relu=False case: kernel against its plain version (float64
   accumulation, exact) on the card, bit for bit, with the weights as they
   come (the wrapper packs them). Again at the main path's batch 128 with the
   weights packed ahead as the int8 forward keeps them: bit for bit, the
   kernel and the plain version timed, the kernel's share of its bound, and
   as a yardstick a bfloat16 channels_last F.conv2d of the same shape
   (cuDNN: the same work at half the int8 tensor-core rate, not the same
   function; the port never calls it). Seven shapes off the main path that
   exercise the tiling's edges are held bit for bit too. At b8, the 18
   SegmentationUNet convs at 1024 x 512 and 512², UNet++'s 30, and the 18
   at one of two 'space' ranks' halo'd rows (514 x 512 at the top level).
4. The main path at full width: AnomalyUNet(base_features=64) at 256², weights
   from a seed and BN statistics warmed on synthetic images, served by
   AnomalyScorer in bf16 and int8 (calibrated on 2 batches of 16) at batch
   128. The launch counters are zeroed just before and read just after:
   K1 must run once per batch on both legs, K2 18 times per batch on the
   int8 leg. The first int8 batch's scores must equal, bit for bit, those of
   the same forward with K1's and K2's plain versions on the card; int8 and
   bf16 scores must track the f32 scorer's. Prints img/s for each leg and p50
   latency at batch 1, and profiles a window of back-to-back b128 score calls
   per leg: device time by kernel category and the device's idle share.
5. The same int8 forward at batch 2 on the CPU (plain versions) against the
   card's.
6. The training step at full width, the flagship: AnomalyUNet(base 64),
   bf16 policy, 256², batch 16, Adam (lr 1e-3, L2 1e-4), the default augment
   (one shear rotation per batch), on seeded textures and masks with a few
   round defects. 3 warm-up steps, then 20 timed by CUDA events: ms per
   step, img/s, peak memory allocated and the model-FLOP share of the bf16
   dense peak (3x the forward's FLOPs from the layer shapes). The loss on a
   fixed batch (the same draws before the first step and after the last)
   must fall; the train path must launch neither K1 nor K2. A profiled
   window of 5 steps gives device time by category and the idle share.
   Then the augment alone (train_transform, profiled) in each rotation
   mode, the 'per_sample' and 'per_sample_shear' steps (2 warm-up,
   10 timed steps each) and the eval step on the trained state: K1 once per
   batch, outputs finite and of the right shapes.
7. One f32 SGD train step (base 8, 64 px, batch 4) on the CPU and on the
   card from the same weights and draws: losses within 1e-5 relative,
   parameters and BN statistics within the tolerances below.
8. The MVTec main path at full width, through the CLIs' own functions
   (train_mvtec.train, which is train_mvtec.main without the flag checks,
   the dataset index and the loss plot; test_mvtec.make_test_loader,
   load_model, test_model, evaluate_results and save_results, which is
   test_mvtec.main without its plots: matplotlib is not installed on the
   card's machine), with flags parsed by the CLIs' parsers. A synthetic
   category of MVTec bottle's counts and size (209 train, 20 good and 63
   defective test PNGs of 900² with their masks) is written under TMPDIR
   and read by MVTecDataset; 3 epochs of AnomalyUNet base 64, bf16, 256²,
   b16, Adam with the loader in the loop, validation every epoch, async
   checkpoints (best and every 2nd epoch), epoch 1 profiled by
   --profile_dir: per epoch train img/s (epoch 0 decodes cold), validation
   seconds, the idle share of the profiled epoch, checkpoint MB and write
   seconds. Then the test path on best_model.pth in bf16, f32 --fold_bn and
   --quantize int8 --calib_samples 64: AUROC, AUPRC, threshold, pixel F1,
   and the bf16 and int8 scores against f32. --resume
   checkpoint_epoch_0.pth --epochs 2 must continue the epoch and Adam step
   counts. Launch counts per leg: K1 once per validation and test batch
   (and calibration chunk), K2 26 times per int8 test batch, neither in the
   train steps. Last, base 8 at 64 px in f32: a .pth written on the card
   loads on the CPU (strict, Adam state equal) and back, and the test path
   gives the same scores (1e-5), threshold and image metrics on both.
9. The segmentation path at full width, through the seg CLIs' own functions
   (_seg_common.train_seg; make_eval_loader, load_seg_model,
   validate_seg_epoch and save_seg_results, which is run_seg_evaluation
   without its plots) with flags from the CLIs' parsers, on synthetic trees
   written under TMPDIR and read by the port's datasets. KolektorSDD at the
   dataset's counts and size (399 grayscale JPEG parts of 1260 x 500 in 50
   kos folders, 52 with a thin defect streak of class 1 or 2): 2 epochs of
   train_kolektorsdd's defaults (SegmentationUNet base 64, bf16, 1024 x 512,
   b8, Adam, class weights 1/50/50, CE + Dice, 5 degree shear, 4 loader
   threads), validation and checkpoints each epoch, epoch 1 profiled (idle
   share); the test path on the last checkpoint in bf16, f32 --fold_bn and
   --quantize int8 (32 calibration images): load_model, the device pass and
   the host metrics timed apart, K1 once per batch (and calibration chunk),
   K2 18 times per int8 batch, each confusion matrix counting every test
   pixel once, int8 and bf16 predictions against f32's; a 1-epoch --resume;
   base 8 at 64 x 32 on the CPU against the card (f32) and int8 against the
   plain K1/K2 forward. Gear (4 classes, 64/16/16 JPEGs of 512² with
   overlapping polygons; sizes chosen): 1 epoch of train_gear's defaults,
   then test_gear in bf16 and int8. K1 and K2 are held bit for bit at the
   seg shapes in phases 2 and 3 (K1 at (8,1024,512,3) and (8,512,512,3), K2
   at SegmentationUNet's 18 convs at 1024 x 512 and 512², b8).
10. The model extensions at full width on the same trees: UNet++ with deep
   supervision on Gear (2 epochs, tested in bf16, f32 --fold_bn and int8 at
   --heads 4 and 1), the attention UNet on KolektorSDD (1 epoch, 3 test
   modes), bilinear AnomalyUNet serving, and base 8 on the CPU against the
   card.
11. The serving surface through the port's entry points, with seeded weights
   whose BN is warmed: SegmentationPredictor at serve_seg's defaults
   (SegmentationUNet base 64, 4 classes, 512², b16) in f32 --fold_bn, bf16
   and int8, and at KolektorSDD's 1024 x 512 b8 with 3 classes (img/s, batch-1
   p50/p95 latency, K1 once and K2 18 times per int8 batch, int8 masks and
   confidences bit for bit those of the plain K1/K2 forward, bf16 and int8
   against f32); UNet++ at --heads 1 and the attention UNet in int8 (K2 6 and
   18 per batch, bit for bit); the 512² model over 1024² images in a 3 x 3
   tile grid (bf16 and int8, K1 once and K2 18 per tile batch; one tile the
   size of the image equals the untiled engine exactly); the HTTP daemon
   (make_server on 127.0.0.1:0) over the bf16 seg engine with buckets
   (1, 4, 16) and the int8 AnomalyScorer with its heatmap, 64 PNG requests
   from 16 client threads each (every response equal to its flush's engine
   output; request p50/p95; flush sizes read from /metrics), and a burst
   against max_queue 2 (503s counted by /healthz); artifacts of the bucketed
   bf16 and the int8 seg engines and of the int8 scorer exported and loaded
   (MB, export and load seconds, launches through the loaded programs,
   outputs bit for bit the live engines').
12. The host data path, the viewers and remat. Phases 8-10 decode natively
   (the port's default resampler) without a pack (TPU_UNET_DATA_CACHE
   empty). [native]: the loader core built with g++ into a fresh directory
   (seconds), ms per RGB resize of 16 of phase 8's 900² PNGs to 256² and of
   16 of phase 9's 1260 x 500 parts to 1024 x 512 with the native area
   mode on 1 and on the default threads and with PIL BILINEAR, alone and
   with four callers at once (as the loader's workers call it), native
   within 1 LSB of PIL, the batch entry bit for bit the per-image calls.
   [pack]: packs of phase 8's bottle tree and phase 9's KolektorSDD tree
   under TMPDIR (build seconds, MB), every packed sample bit for bit the
   direct decode, and epoch 0 of train_mvtec.train (phase 8's flags) and of
   train_kolektorsdd's defaults on fresh datasets reading the packs, beside
   the same epoch decoding natively without a pack and, for MVTec, with PIL
   (and phase 8's epoch 0). [viz]: visualize_mvtec's collect half on
   phase 8's best_model.pth (16 samples, b8), bit for bit test_mvtec's eval
   step on the same images; visualize_seg's on phase 9's Gear checkpoint and
   on phase 10's UNet++ at --heads 1 (16 samples, b4), predictions bit for
   bit the bf16 SegmentationPredictor's; K1 once per batch, samples/s;
   rendering only where matplotlib is installed. [remat]: the flagship step
   with remat none / full_res / full and the KolektorSDD step (base 64,
   bf16, 1024 x 512, b8) with none and full_res: ms per step (median of 10),
   img/s, peak GB; on one step from the same state and batch, each mode's
   loss equal to the plain step's, its BN running statistics bit for bit
   (num_batches_tracked + 1), its parameters within the difference of two
   plain runs or 1e-4.
13. Data parallelism on the one card ([dp] lines). The flagship step at
   world size 1 over NCCL (sync BatchNorm, the gradient all-reduce) beside
   the plain step, timed in turns and profiled, its first-step loss equal
   to the plain step's (DP_LOSS_RTOL). Two ranks sharing cuda:0 over gloo
   (tpu_unet_torch.parallel.mesh.launch; NCCL refuses two ranks on one
   GPU): one f32 SGD step on a global batch of 16 against the world-size-1
   step (DP_UPDATE_TOL, DP_STAT_TOL); the flagship step's ms and state
   bytes per rank; a checkpoint written by rank 0; test_mvtec's int8 path
   on phase 8's checkpoint, K1 and K2 counted per rank, the gathered
   scores and AUROC bit for bit one process's under rank 0's qparams. FSDP
   runs in a launch of its own at FSDP_BASE (the full width): one f32 SGD
   and one f32 Adam step (fused) under FSDP against plain DP from the same
   state, batch and draws (DP_UPDATE_TOL, DP_STAT_TOL), and the flagship's
   ms and bytes under FSDP; a failed rank fails the run. The 2-rank
   checkpoint loads strict at world size 1 and resumes; AnomalyScorer int8
   b128 with devices=("cuda:0", "cuda:0") scores bit for bit one engine.
   These are ranks sharing one card: no number is a scaling figure.
14. Tensor parallelism over 'model' on the one card ([tp] lines) and
   artifacts for more than one platform ([artifact] lines). The flagship on
   a (1, 1, 2) ('data', 'space', 'model') mesh of two gloo ranks sharing
   cuda:0: one f32 SGD step against phase 13's world-size-1 step on the same
   batch and draws (DP_UPDATE_TOL, DP_STAT_TOL, losses 1e-5), the bf16 Adam
   step's ms and state bytes per rank beside the JAX placement's, the eval
   step on its state (K1 once per rank). A (2, 1, 2) mesh of four ranks
   with --fsdp at FSDP_BASE against world size 1; the seg step with dropout
   (SegmentationUNet) and the attention UNet at base TP_SEG_BASE on Gear's
   512² batch of 8, each on a (1, 1, 2) mesh against world size 1. One
   epoch of train_mvtec.train with --n_model 2 at full width in two ranks,
   on the --debug subset (TP_CLI_SAMPLES train and test samples) of phase
   8's bottle tree: its best_model.pth loads strict at world size 1 and
   test_mvtec's bf16 leg scores the whole test split (K1 once per batch). Artifacts of
   serve_mvtec's default engine in int8 and bf16 (buckets 2 and 128) with
   cuda and cpu programs: each program bit for bit a live engine on its
   device, the int8 cpu program's scores bit for bit the cuda program's, K1
   1x and K2 18x per b128 int8 batch; MB, export and load seconds.
   ``python3 chip_smoke.py fsdp_widths`` instead runs FSDP at base 64, 32,
   16 and 8 (the flagship's geometry), at base 64 with 2 rows of 64² per
   rank, and at base 64 with CPU tensors, each in a child process.
15. The 'space' axis on the one card ([space] lines; gloo ranks sharing
   cuda:0, so correctness and memory figures, not scaling).
   train_kolektorsdd's step (SegmentationUNet base 64, 1024 x 512, b8,
   class weights 1/50/50, dropout) on a (1, 2, 1) mesh: one f32 SGD step
   against world size 1 (DP_UPDATE_TOL, DP_STAT_TOL, losses 1e-5, logits
   SPACE_LOGIT_TOL, the confusion matrix equal but for ties at that
   rounding), the halo's exchanges and bytes per rank, then SPACE_STEPS
   bf16 Adam steps: ms per step and peak GB per rank beside the
   one-process step's. The int8 seg eval on the same mesh: bit for bit
   one process's, K1 1x and K2 18x per rank (K2 is also held at the
   halo'd shapes in phase 3, ``kolektorsdd_space2``). One
   ``train_kolektorsdd --n_space 2`` epoch of a --debug subset of phase 9's
   tree and its f32 test against one process's (metrics within 1e-5; the
   .pth loads strict at world size 1). SegmentationPredictor(n_space=2) on
   [cuda:0, cuda:0]: int8 bit for bit one device, f32 masks equal but for
   ties and confidences within SPACE_CONF_RTOL, bf16 within
   SPACE_MAX_DISAGREE. The attention UNet on (1, 2, 1) and SegmentationUNet
   on (1, 2, 2) at base TP_SEG_BASE on Gear's 512² batch against world size
   1, their logits held as the step's. ``python3 chip_smoke.py
   halo_probe`` instead runs gloo's ``batch_isend_irecv`` and
   ``all_gather`` of edge rows on CUDA tensors, each dtype in a child
   process.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit
(nvidia-smi), and as the last line ``{"ok": true, "device": {...}}``; the
details go to chiprun_out/chip_smoke.json. Any failed check raises and exits
non-zero. Without a CUDA GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# (H = W, Cin, Cout) of the 18 3x3 convs of the int8 score path (AnomalyUNet,
# base 64, 256 x 256), in order: encoder inc, down1..down4, decoder up1..up4.
SCORE_PATH_CONVS = [
    (256, 3, 64), (256, 64, 64), (128, 64, 128), (128, 128, 128),
    (64, 128, 256), (64, 256, 256), (32, 256, 512), (32, 512, 512),
    (16, 512, 1024), (16, 1024, 1024),
    (32, 1024, 512), (32, 512, 512), (64, 512, 256), (64, 256, 256),
    (128, 256, 128), (128, 128, 128), (256, 128, 64), (256, 64, 64),
]
# (N, H, W, Cin, Cout) off the main path, checked bit for bit; the last three
# have a Cout the wrapper pads to 16.
ODD_CONVS = [(1, 10, 20, 32, 16), (2, 70, 70, 64, 64), (1, 5, 3, 3, 16),
             (1, 9, 130, 3, 80), (1, 3, 3, 32, 128), (2, 17, 33, 96, 144),
             (1, 6, 7, 2, 32), (1, 16, 24, 32, 8), (2, 20, 12, 8, 24), (1, 17, 9, 3, 12)]
# The seg eval batch (the JAX CLIs' --batch_size 8), and the input shapes of
# K1 there: KolektorSDD at 1024 x 512, Gear at 512 x 512; then serve_seg's
# batch (16 at 512²) and its tile batch (2 images of 1024² in 9 tiles each).
SEG_BATCH = 8
SEG_K1_SHAPES = [(SEG_BATCH, 1024, 512, 3), (SEG_BATCH, 512, 512, 3),
                 (16, 512, 512, 3), (18, 512, 512, 3)]
# (H, W, Cin, Cout) of SegmentationUNet's 18 3x3 convs at base 64, in order:
# encoder inc, down1..down4, then the one decoder up1..up4; at KolektorSDD's
# 1024 x 512 and at Gear's 512 x 512.
_SEG_CHANNELS = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
                 (256, 512), (512, 512), (512, 1024), (1024, 1024),
                 (1024, 512), (512, 512), (512, 256), (256, 256), (256, 128), (128, 128),
                 (128, 64), (64, 64)]
_SEG_LEVELS = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 3, 3, 2, 2, 1, 1, 0, 0]
SEG_CONVS = {name: [(h >> lv, w >> lv, cin, cout)
                    for lv, (cin, cout) in zip(_SEG_LEVELS, _SEG_CHANNELS)]
             for name, (h, w) in (("kolektorsdd", (1024, 512)), ("gear", (512, 512)))}
# The same convs as one of two 'space' ranks runs them at 1024 x 512 (phase
# 15): its 512 >> level rows with one halo row above and below.
SEG_CONVS["kolektorsdd_space2"] = [(h // 2 + 2, w, cin, cout)
                                   for h, w, cin, cout in SEG_CONVS["kolektorsdd"]]


def unetpp_convs(base, h, w, max_j=4):
    """(H, W, Cin, Cout) of UNet++'s 3x3 convs (two per node X[i][j], in the
    int8 plan's order: the encoder column, then column by column) for the
    head X[0][max_j]: 30 at max_j 4, 6 at max_j 1."""
    nodes = ([(i, 0) for i in range(max_j + 1)]
             + [(i, j) for j in range(1, max_j + 1) for i in range(max_j - j + 1)])
    convs = []
    for i, j in nodes:
        c = base * 2 ** i
        cin = (3 if i == 0 else c // 2) if j == 0 else (j + 1) * c
        convs += [(h >> i, w >> i, cin, c), (h >> i, w >> i, c, c)]
    return convs


# UNet++ base 64 on Gear (512 x 512) at the seg eval batch: the 30 convs.
UNETPP_CONVS = unetpp_convs(64, 512, 512)
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
# The train step on the CPU against the card (f32, TF32 off): largest
# |difference| over a leaf's largest |value|, parameters and BN statistics;
# about 5x what an H100 run measured (7.8e-6 and 4.8e-7: cuDNN's backward
# sums in another order than the CPU's).
TRAIN_PARAM_TOL = 4e-5
TRAIN_STAT_TOL = 2.5e-6
# Phase 8's test scores (the trained synthetic bottle) in int8 and bf16
# against f32 with folded BN: correlation above, median relative difference
# below. About 5x what H100 runs measured: 1 - corr 6e-7 (int8; bf16 2e-7),
# median rel 7.5e-4 (int8), 5.1e-4 (bf16).
MVTEC_MIN_CORR = 1 - 3e-6
MVTEC_INT8_REL = 4e-3
MVTEC_BF16_REL = 2.5e-3
OUT_DIR = "chiprun_out"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, iters, warmup=1):
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def kernel_records_ms(torch, calls, key, reps):
    """The kernel's own device time in ms for each function of ``calls``,
    from the profiler's kernel records: each runs once to warm up, then
    ``reps`` times in turn in one profiled window, and the kernels whose
    name holds ``key`` are read in launch order (one per call), averaged per
    function. ``cuda_ms`` times the operator's host calls back to back, so
    any host cost above the kernel's time counts there and not here."""
    from torch.profiler import ProfilerActivity, profile
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name),
                     key=lambda e: e.time_range.start)
    check(len(kernels) == len(calls) * reps,
          f"{len(kernels)} {key} kernel records for {len(calls)} x {reps} calls")
    return [sum(e.time_range.elapsed_us() for e in kernels[i * reps:(i + 1) * reps])
            / reps / 1e3 for i in range(len(calls))]


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _dominant_bound(rows):
    """The bound ('bytes' or 'operations') that holds most of the summed bound time."""
    ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return "operations" if 2 * ops >= sum(r["bound_ms"] for r in rows) else "bytes"


def synth_images(torch, n, size, seed, device):
    """Seeded uint8 (n, size, size, 3) textures: a tint, a sine pattern and
    noise whose strength varies by image, so anomaly scores spread."""
    g = torch.Generator(device=device).manual_seed(seed)
    lin = torch.linspace(0, 1, size, device=device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    base = torch.rand(n, 1, 1, 3, generator=g, device=device) * 0.5 + 0.25
    freq = torch.rand(n, 1, 1, 1, generator=g, device=device) * 6 + 1
    pattern = 0.15 * torch.sin(6.2832 * freq * xx[None, :, :, None]) \
        * torch.cos(6.2832 * freq * yy[None, :, :, None])
    amp = torch.rand(n, 1, 1, 1, generator=g, device=device) * 0.2
    noise = torch.randn(n, size, size, 3, generator=g, device=device) * amp
    img = ((base + pattern + noise).clamp(0, 1) * 255).round().to(torch.uint8)
    return img.cpu().numpy()


def _category(kernel_name):
    for key, cat in (("conv3x3_int8", "K2 conv3x3_int8"), ("normalize_u8", "K1 normalize_u8"),
                     ("fprop", "cuDNN conv"), ("dgrad", "cuDNN conv"),
                     ("gemm", "matmul (_int_mm)")):
        if key in kernel_name:
            return cat
    return "PyTorch elementwise / copy / reduce"


def _train_category(kernel_name):
    """Kernel categories of the train step. A transposed conv's forward is a
    dgrad kernel and its input gradient an fprop one."""
    name = kernel_name.lower()
    for keys, cat in ((("fprop",), "cuDNN conv fprop (forward)"),
                      (("dgrad",), "cuDNN conv dgrad (backward)"),
                      (("wgrad",), "cuDNN conv wgrad (backward)"),
                      (("conv",), "cuDNN conv, other"),
                      (("gemm",), "shear matmuls (cuBLAS)"),
                      (("adam", "sgd"), "optimizer"),
                      (("nccl",), "NCCL collectives"),
                      (("batch_norm", "batchnorm"), "BatchNorm"),
                      (("elementwise", "reduce", "copy", "cat", "index", "where", "fill",
                        "max_pool", "pool", "sigmoid", "clamp"), "elementwise / policy glue")):
        if any(k in name for k in keys):
            return cat
    return "other"


def device_breakdown(torch, fn, n_calls=5, top=6, category=_category):
    """Profile a window of ``n_calls`` calls of ``fn`` enqueued back to back
    (torch.profiler): device time per call by kernel and by category, the
    window's wall time per call, and the device's idle share over the window,
    1 - busy / wall, unclamped. The profiler's own host cost lengthens the
    window, so the share is an upper estimate of the unprofiled one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_calls
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / n_calls, e.count // n_calls)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    cats = {}
    for k, ms, _ in rows:
        cats[category(k)] = cats.get(category(k), 0.0) + ms
    busy_ms = sum(r[1] for r in rows)
    return {"n_calls": n_calls, "device_busy_ms": busy_ms, "wall_ms": wall_ms,
            "idle_share": 1 - busy_ms / wall_ms, "by_category_ms": cats,
            "top_kernels_ms": [[k[:90], ms, n] for k, ms, n in rows[:top]]}


def warm_clocks(torch, seconds=1.0):
    """Keep the card busy for a moment so timings start at working clocks."""
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_build(report):
    from tpu_unet_torch.ops.kernels import build
    t0 = time.perf_counter()
    res = build.build()
    wall = time.perf_counter() - t0
    print(f"[build] {len(res)} kernels in {wall:.1f} s (parallel nvcc): "
          + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in res.items()), flush=True)
    sass = {}
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    for name, r in res.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
        if os.path.exists(cuobjdump):  # wgmma is GMMA in SASS, a TMA load UTMALDG
            out = subprocess.run([cuobjdump, "-sass", r["path"]], capture_output=True,
                                 text=True, timeout=120).stdout
            sass[name] = {op: out.count(op) for op in ("GMMA", "UTMALDG", "IMMA", "HMMA")}
            print(f"[build] {name}: SASS instruction counts {sass[name]}")
    report["build"] = {"wall_s": wall, "sass_counts": sass,
                       **{k: {"seconds": v["seconds"], "log": v["log"]} for k, v in res.items()}}
    # The host loader core, before any dataset decodes with it: a build at
    # first use would land inside phase 8's cold epoch.
    from tpu_unet_torch.data import native
    loader = native.build()
    print(f"[build] the host loader core ({native.SOURCE.name}, g++): "
          f"{loader['seconds']:.1f} s", flush=True)
    report["build"]["loader_core"] = {"seconds": loader["seconds"], "log": loader["log"]}


def phase_k1(torch, report):
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8, normalize_u8_plain
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, 256, (128, 256, 256, 3), generator=g, device="cuda",
                      dtype=torch.uint8)
    warm_clocks(torch)  # the build left the card idle; K1's runs are short
    k_ms, out = cuda_ms(torch, lambda: normalize_u8(x), iters=200, warmup=20)
    p_ms, ref = cuda_ms(torch, lambda: normalize_u8_plain(x), iters=5, warmup=2)
    check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
          "K1 f32 differs from its plain version")
    k16_ms, out16 = cuda_ms(torch, lambda: normalize_u8(x, out_dtype=torch.bfloat16),
                            iters=200, warmup=20)
    ref16 = normalize_u8_plain(x, out_dtype=torch.bfloat16)
    check(torch.equal(out16.view(torch.int16), ref16.view(torch.int16)),
          "K1 bf16 differs from its plain version")
    # The kernel computes its table with its own IEEE arithmetic; the CPU's
    # plain version is a witness that shares no code with the card.
    x_cpu = x.cpu()
    check(torch.equal(out.cpu().view(torch.int32), normalize_u8_plain(x_cpu).view(torch.int32)),
          "K1 f32 on the card differs from the plain version on the CPU")
    check(torch.equal(out16.cpu().view(torch.int16),
                      normalize_u8_plain(x_cpu, out_dtype=torch.bfloat16).view(torch.int16)),
          "K1 bf16 on the card differs from the plain version on the CPU")
    del x_cpu
    torch.cuda.synchronize()
    n = x.numel()
    b_ms, b_by = bound_ms(n * (1 + 4), 3 * n, PEAK_F32_FLOPS)
    b16_ms, _ = bound_ms(n * (1 + 2), 3 * n, PEAK_F32_FLOPS)
    err = float((out - ref).abs().max())
    rec_ms, rec16_ms = kernel_records_ms(
        torch, [lambda: normalize_u8(x), lambda: normalize_u8(x, out_dtype=torch.bfloat16)],
        "normalize_u8", reps=20)
    print(f"[K1] (128,256,256,3) u8->f32: operator {k_ms:.4f} ms per call (events around "
          f"back-to-back host calls), kernel record {rec_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / rec_ms:.1f}% of bound (kernel record); "
          f"u8->bf16: operator {k16_ms:.4f} ms, kernel record {rec16_ms:.4f} ms, bound "
          f"{b16_ms:.4f} ms, {100 * b16_ms / rec16_ms:.1f}% of bound; bit-exact f32 and bf16 "
          f"against the plain version on the card and the CPU", flush=True)
    report["k1"] = {"shape": [128, 256, 256, 3], "kernel_ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                    "kernel_ms_bf16": k16_ms, "bound_ms_bf16": b16_ms,
                    "kernel_record_ms": rec_ms, "kernel_record_ms_bf16": rec16_ms, "seg": []}
    del x, out, ref, out16, ref16
    # The seg eval batches (KolektorSDD, Gear): bit for bit in f32 and bf16.
    for i, shape in enumerate(SEG_K1_SHAPES):
        x = torch.randint(0, 256, shape, generator=g, device="cuda", dtype=torch.uint8)
        k_ms, out = cuda_ms(torch, lambda: normalize_u8(x), iters=100, warmup=10)
        p_ms, ref = cuda_ms(torch, lambda: normalize_u8_plain(x), iters=3, warmup=1)
        check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
              f"K1 f32 differs from its plain version at {shape}")
        k16_ms, out16 = cuda_ms(torch, lambda: normalize_u8(x, out_dtype=torch.bfloat16),
                                iters=100, warmup=10)
        check(torch.equal(out16.view(torch.int16),
                          normalize_u8_plain(x, out_dtype=torch.bfloat16).view(torch.int16)),
              f"K1 bf16 differs from its plain version at {shape}")
        n = x.numel()
        sb_ms, sb_by = bound_ms(n * (1 + 4), 3 * n, PEAK_F32_FLOPS)
        rec_ms, rec16_ms = kernel_records_ms(
            torch, [lambda: normalize_u8(x), lambda: normalize_u8(x, out_dtype=torch.bfloat16)],
            "normalize_u8", reps=20)
        report["k1"]["seg"].append({"shape": list(shape), "kernel_ms": k_ms, "plain_ms": p_ms,
                                    "bound_ms": sb_ms, "bound_by": sb_by,
                                    "kernel_ms_bf16": k16_ms, "max_abs_err": 0.0,
                                    "kernel_record_ms": rec_ms,
                                    "kernel_record_ms_bf16": rec16_ms})
        print(f"[K1] seg {shape} u8->f32: operator {k_ms:.4f} ms per call, kernel record "
              f"{rec_ms:.4f} ms, plain {p_ms:.4f} ms, bound {sb_ms:.4f} ms ({sb_by}), "
              f"{100 * sb_ms / rec_ms:.1f}% of bound (kernel record); bf16 operator "
              f"{k16_ms:.4f} ms, kernel record {rec16_ms:.4f} ms; bit-exact f32 and bf16",
              flush=True)
        del x, out, ref, out16


def _k2_case(torch, n, hw, cin, cout, seed, width=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = -127 if cin <= 3 else 0  # the quantized input vs post-ReLU activations
    x = torch.randint(lo, 128, (n, hw, width or hw, cin), generator=g,
                      device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, 3, 3, cin), generator=g, device="cuda",
                      dtype=torch.int8)
    s_out = torch.full((), 0.05, device="cuda")
    sigma = (9 * cin) ** 0.5 * 127 ** 2 / 3  # rough std of the accumulator
    scale = (0.05 * 40 / sigma) * (0.5 + torch.rand(cout, generator=g, device="cuda"))
    bias = torch.randn(cout, generator=g, device="cuda") * 0.5
    return x, w, scale.float(), bias.float(), s_out


def phase_k2(torch, report):
    import torch.nn.functional as F
    from tpu_unet_torch.ops.kernels.int8_conv import (conv3x3_int8, conv3x3_int8_plain,
                                                      pack_weights)
    rows = []
    cases = [(hw, cin, cout, True) for hw, cin, cout in SCORE_PATH_CONVS]
    cases.append((64, 256, 256, False))
    for i, (hw, cin, cout, relu) in enumerate(cases):
        n = 8
        x, w, scale, bias, s_out = _k2_case(torch, n, hw, cin, cout, seed=100 + i)
        out = conv3x3_int8(x, w, scale, bias, s_out, relu)  # natural weights, packed inside
        ref = conv3x3_int8_plain(x, w, scale, bias, s_out, relu)
        diff = int((out.int() - ref.int()).abs().max())
        check(diff == 0, f"K2 differs from its plain version at {(n, hw, cin, cout, relu)}"
                         f" (max |diff| {diff}, {int((out != ref).sum())} values)")
        hist = torch.bincount((out.int() + 128).flatten(), minlength=256)
        levels = int((hist > 0).sum())
        wp = pack_weights(w, cin)
        k_ms, _ = cuda_ms(torch, lambda: conv3x3_int8(x, wp, scale, bias, s_out, relu),
                          iters=10)
        p_ms, _ = cuda_ms(torch, lambda: conv3x3_int8_plain(x, w, scale, bias, s_out,
                                                            relu), iters=1)
        n_pix = n * hw * hw
        b_ms, b_by = bound_ms(n_pix * cin + 9 * cin * cout + n_pix * cout + 8 * cout,
                              2 * n_pix * 9 * cin * cout, PEAK_INT8_OPS)
        row = {"n": n, "hw": hw, "cin": cin, "cout": cout, "relu": relu,
               "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": diff, "int8_levels_hit": levels}
        msg = (f"[K2] b{n} {hw}x{hw} {cin:4d}->{cout:4d} relu={relu!s:5}: kernel "
               f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
               f"{100 * b_ms / k_ms:.1f}% of bound, {levels} int8 levels, bit-exact")
        del x, w, out, ref
        if relu:  # the main path's batch, weights packed ahead as _QuantExec keeps them
            xb, wb, sb, bb, so = _k2_case(torch, 128, hw, cin, cout, seed=200 + i)
            wb = pack_weights(wb, cin)
            # warmup 3: the caching allocator holds two outputs by then
            row["kernel_ms_b128"], out = cuda_ms(
                torch, lambda: conv3x3_int8(xb, wb, sb, bb, so, True), iters=5, warmup=3)
            row["plain_ms_b128"], ref = cuda_ms(
                torch, lambda: conv3x3_int8_plain(xb, wb, sb, bb, so, True), iters=1,
                warmup=0)
            diff_b128 = int((out.int() - ref.int()).abs().max())
            check(diff_b128 == 0, f"K2 differs from its plain version at "
                                  f"{(128, hw, cin, cout, relu)} (max |diff| {diff_b128}, "
                                  f"{int((out != ref).sum())} values)")
            row["max_abs_err_b128"] = diff_b128
            del out, ref, wb
            row["bound_ms_b128"], row["bound_by_b128"] = bound_ms(
                128 * hw * hw * (cin + cout) + 9 * cin * cout + 8 * cout,
                2 * 128 * hw * hw * 9 * cin * cout, PEAK_INT8_OPS)
            row["pct_of_bound_b128"] = 100 * row["bound_ms_b128"] / row["kernel_ms_b128"]
            # Yardstick: the same conv in bf16 through cuDNN, channels_last.
            xf = xb.to(torch.bfloat16).permute(0, 3, 1, 2)
            wf = torch.randn(cout, cin, 3, 3, device="cuda", dtype=torch.bfloat16).to(
                memory_format=torch.channels_last)
            row["bf16_cudnn_ms_b128"], _ = cuda_ms(
                torch, lambda: F.conv2d(xf, wf, padding=1), iters=5)
            del xb, sb, bb, so, xf, wf
            msg += (f"; b128 {row['kernel_ms_b128']:.3f} ms, bound "
                    f"{row['bound_ms_b128']:.3f} ms ({row['bound_by_b128']}), "
                    f"{row['pct_of_bound_b128']:.1f}% of bound, bit-exact; plain "
                    f"{row['plain_ms_b128']:.1f} ms; bf16 cuDNN yardstick "
                    f"{row['bf16_cudnn_ms_b128']:.3f} ms")
        rows.append(row)
        print(msg, flush=True)
    # Shapes off the main path that exercise the tiling's edges: W < 64 and not
    # a multiple of 64, tiny images, W not a multiple of 128 on the
    # first-layer kernel, Cin padded by the wrapper (96, 2), Cout not a
    # multiple of the tile.
    for i, (n, h, w_, cin, cout) in enumerate(ODD_CONVS):
        x, w, scale, bias, s_out = _k2_case(torch, n, h, cin, cout, seed=300 + i, width=w_)
        for relu in (True, False):
            out = conv3x3_int8(x, w, scale, bias, s_out, relu)
            ref = conv3x3_int8_plain(x, w, scale, bias, s_out, relu)
            check(torch.equal(out, ref), f"K2 differs from its plain version at "
                                         f"{(n, h, w_, cin, cout, relu)}")
    print(f"[K2] {len(ODD_CONVS)} off-path shapes {ODD_CONVS}, relu on and off: "
          f"bit-exact", flush=True)
    path = [r for r in rows if r["relu"]]
    calls = []
    for i, r in enumerate(path):
        xb, wb, sb, bb, so = _k2_case(torch, 128, r["hw"], r["cin"], r["cout"], seed=200 + i)
        calls.append(functools.partial(conv3x3_int8, xb, pack_weights(wb, r["cin"]), sb, bb,
                                       so, True))
    for r, ms in zip(path, kernel_records_ms(torch, calls, "conv3x3_int8", reps=3)):
        r["kernel_record_ms_b128"] = ms
    del calls
    total, bound = sum(r["kernel_ms_b128"] for r in path), sum(r["bound_ms_b128"] for r in path)
    rec = sum(r["kernel_record_ms_b128"] for r in path)
    print(f"[K2] b128, the 18 score-path convs: operator {total:.3f} ms (events around "
          f"back-to-back host calls), kernel records {rec:.3f} ms, bound {bound:.3f} ms, "
          f"{100 * bound / rec:.1f}% of bound (kernel records); bf16 cuDNN yardstick "
          f"{sum(r['bf16_cudnn_ms_b128'] for r in path):.3f} ms", flush=True)
    report["k2"] = rows
    report["k2_seg"] = {name: _k2_seg(torch, name, convs) for name, convs in SEG_CONVS.items()}
    report["k2_seg"]["unetpp_gear"] = _k2_seg(torch, "unetpp_gear", UNETPP_CONVS)


def _k2_seg(torch, name, convs):
    """K2 at a seg model's convs at the seg eval batch (b8): bit for bit
    against the plain version with natural weights, then timed with the
    weights packed ahead, beside its bound and a bf16 cuDNN yardstick."""
    import torch.nn.functional as F
    from tpu_unet_torch.ops.kernels.int8_conv import (conv3x3_int8, conv3x3_int8_plain,
                                                      pack_weights)
    rows = []
    for i, (h, w_, cin, cout) in enumerate(convs):
        n = SEG_BATCH
        x, w, scale, bias, s_out = _k2_case(torch, n, h, cin, cout, seed=400 + i, width=w_)
        out = conv3x3_int8(x, w, scale, bias, s_out, True)
        p_ms, ref = cuda_ms(torch, lambda: conv3x3_int8_plain(x, w, scale, bias, s_out, True),
                            iters=1, warmup=0)
        diff = int((out.int() - ref.int()).abs().max())
        check(diff == 0, f"K2 differs from its plain version at {name} {(n, h, w_, cin, cout)} "
                         f"(max |diff| {diff}, {int((out != ref).sum())} values)")
        del out, ref
        wp = pack_weights(w, cin)
        k_ms, _ = cuda_ms(torch, lambda: conv3x3_int8(x, wp, scale, bias, s_out, True),
                          iters=10, warmup=3)
        n_pix = n * h * w_
        b_ms, b_by = bound_ms(n_pix * (cin + cout) + 9 * cin * cout + 8 * cout,
                              2 * n_pix * 9 * cin * cout, PEAK_INT8_OPS)
        xf = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wf = torch.randn(cout, cin, 3, 3, device="cuda", dtype=torch.bfloat16).to(
            memory_format=torch.channels_last)
        c_ms, _ = cuda_ms(torch, lambda: F.conv2d(xf, wf, padding=1), iters=10, warmup=2)
        del x, w, wp, xf, wf
        rows.append({"n": n, "h": h, "w": w_, "cin": cin, "cout": cout, "kernel_ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "bf16_cudnn_ms": c_ms, "max_abs_err": diff})
        print(f"[K2] seg {name} b{n} {h}x{w_} {cin:4d}->{cout:4d}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / k_ms:.1f}% of bound, "
              f"bf16 cuDNN {c_ms:.4f} ms, bit-exact", flush=True)
    calls = []
    for i, r in enumerate(rows):
        x, w, scale, bias, s_out = _k2_case(torch, r["n"], r["h"], r["cin"], r["cout"],
                                            seed=400 + i, width=r["w"])
        calls.append(functools.partial(conv3x3_int8, x, pack_weights(w, r["cin"]), scale, bias,
                                       s_out, True))
    for r, ms in zip(rows, kernel_records_ms(torch, calls, "conv3x3_int8", reps=3)):
        r["kernel_record_ms"] = ms
    del calls
    total = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "bound_ms",
                                                  "bf16_cudnn_ms", "kernel_record_ms")}
    print(f"[K2] seg {name} b{SEG_BATCH}, the {len(rows)} convs: operator "
          f"{total['kernel_ms']:.3f} ms, kernel records {total['kernel_record_ms']:.3f} ms, "
          f"bound {total['bound_ms']:.3f} ms, "
          f"{100 * total['bound_ms'] / total['kernel_record_ms']:.1f}% of bound (kernel "
          f"records); plain {total['plain_ms']:.1f} ms; bf16 cuDNN yardstick "
          f"{total['bf16_cudnn_ms']:.3f} ms", flush=True)
    return {"rows": rows, **total, "bound_by": _dominant_bound(rows)}


def plain_k2_exec(qparams):
    """The int8 executor over ``qparams`` with K2's plain version in place of
    the kernel (the reference the card's int8 forwards are held against)."""
    from tpu_unet_torch.ops import quantize as tq
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8_plain

    class PlainK2Exec(tq._QuantExec):
        conv3x3 = staticmethod(conv3x3_int8_plain)

    return PlainK2Exec(qparams)


def warm_anomaly_state_dict(torch, bilinear=False):
    """A full-width AnomalyUNet (base 64) from seed 0 with BN statistics
    warmed on synthetic 256² images (the cumulative mean of 3 batches of
    8); its state_dict on the CPU."""
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8

    torch.manual_seed(0)
    model = build_model("anomaly_unet", base_features=64, bilinear=bilinear).to(
        "cuda", memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    model.train()
    with torch.no_grad():
        for seed in range(3):
            imgs = torch.from_numpy(synth_images(torch, 8, 256, 10 + seed, "cuda")).cuda()
            model(normalize_u8(imgs).permute(0, 3, 1, 2))
    return {k: v.cpu() for k, v in model.state_dict().items()}


def phase_main_path(torch, np, report):
    from tpu_unet_torch.metrics.anomaly import anomaly_score
    from tpu_unet_torch.ops import quantize as tq
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8, normalize_u8_plain
    from tpu_unet_torch.serve import AnomalyScorer

    t0 = time.perf_counter()
    state_dict = warm_anomaly_state_dict(torch)
    n_params = sum(v.numel() for k, v in state_dict.items()
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    check(n_params == 43_228_228, f"AnomalyUNet has {n_params} params")

    kw = dict(image_size=256, batch_size=128, device="cuda")
    bf16 = AnomalyScorer.from_state_dict(state_dict, precision="bf16", **kw)
    f32 = AnomalyScorer.from_state_dict(state_dict, precision="f32", **kw)
    calib = synth_images(torch, 32, 256, 20, "cuda")  # 2 calibration batches of 16
    int8 = AnomalyScorer.from_state_dict(state_dict, quantize="int8",
                                         calib_images=calib, **kw)
    images = synth_images(torch, 384, 256, 30, "cuda")  # 3 serving batches
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the main path: counters zeroed just before, read just after --------
    normalize_u8.launches = conv3x3_int8.launches = 0
    s_bf16 = bf16.score_array(images)
    k1_bf16, k2_bf16 = normalize_u8.launches, conv3x3_int8.launches
    s_int8 = int8.score_array(images)
    k1_total, k2_total = normalize_u8.launches, conv3x3_int8.launches
    launches = {"normalize_u8": k1_total, "conv3x3_int8": k2_total}
    check(k1_bf16 == 3 and k2_bf16 == 0,
          f"bf16 leg launched K1 {k1_bf16}x, K2 {k2_bf16}x (want 3, 0)")
    check(k1_total - k1_bf16 == 3 and k2_total - k2_bf16 == 54,
          f"int8 leg launched K1 {k1_total - k1_bf16}x, K2 {k2_total - k2_bf16}x "
          f"(want 3, 54)")
    # -------------------------------------------------------------------------

    # The first int8 batch again, through the same forward with K1's and K2's
    # plain versions on the card: the scores must be the same bits.

    batch = torch.from_numpy(images[:128]).cuda()
    with torch.inference_mode():
        img = normalize_u8_plain(batch)
        recon = tq._run(plain_k2_exec(int8.qparams), img,
                        tq.build_plan("anomaly_unet", score_only=True))
        s_plain = anomaly_score(recon, img).cpu().numpy()
    del img, recon
    n_diff = int((s_plain != s_int8[:128]).sum())
    print(f"[main] int8 b128 scores vs the same forward with plain K1/K2 on the card: "
          f"{n_diff} of 128 differ, max |diff| "
          f"{float(np.abs(s_plain - s_int8[:128]).max()):.3g}", flush=True)
    check(n_diff == 0, "int8 scores differ from the forward with plain K1/K2")

    s_f32 = f32.score_array(images)
    del f32
    for name, s in (("bf16", s_bf16), ("int8", s_int8), ("f32", s_f32)):
        check(s.shape == (384,) and np.isfinite(s).all(), f"{name} scores not finite (384,)")
    corr_int8 = float(np.corrcoef(s_int8, s_f32)[0, 1])
    corr_bf16 = float(np.corrcoef(s_bf16, s_f32)[0, 1])
    rel_int8 = float(np.median(np.abs(s_int8 - s_f32) / np.abs(s_f32)))
    rel_bf16 = float(np.median(np.abs(s_bf16 - s_f32) / np.abs(s_f32)))
    print(f"[main] scores: f32 range [{s_f32.min():.4f}, {s_f32.max():.4f}]; "
          f"int8 vs f32 corr {corr_int8:.5f}, median rel diff {rel_int8:.2e}; "
          f"bf16 vs f32 corr {corr_bf16:.5f}, median rel diff {rel_bf16:.2e}", flush=True)
    # Limits about 5x the medians measured on the H100 (int8 3.2e-4, bf16 1.9e-4).
    check(corr_int8 > 0.9999 and rel_int8 < 1.5e-3, "int8 scores do not track f32 scores")
    check(corr_bf16 > 0.9999 and rel_bf16 < 1e-3, "bf16 scores do not track f32 scores")

    tput = {"bf16": bf16.throughput(n_batches=10), "int8": int8.throughput(n_batches=10)}
    bf16_b1 = AnomalyScorer.from_state_dict(state_dict, precision="bf16",
                                            **{**kw, "batch_size": 1})
    int8_b1 = AnomalyScorer.from_state_dict(state_dict, quantize="int8",
                                            qparams=int8.qparams, **{**kw, "batch_size": 1})
    lat = {"bf16": bf16_b1.latency_ms(n_iters=30), "int8": int8_b1.latency_ms(n_iters=30)}
    print(f"[main] AnomalyUNet 256² b128: bf16 {tput['bf16']:.1f} img/s, int8 "
          f"{tput['int8']:.1f} img/s; b1 p50 latency bf16 {lat['bf16']['p50_ms']} ms, "
          f"int8 {lat['int8']['p50_ms']} ms (set-up {setup_s:.1f} s)", flush=True)
    breakdown = {}
    for name, scorer in (("bf16", bf16), ("int8", int8)):
        with torch.inference_mode():
            b = device_breakdown(torch, lambda: scorer._score_fn(batch))
        b["batch_ms_in_throughput_run"] = 1e3 * 128 / tput[name]
        breakdown[name] = b
        print(f"[profile] {name}, {b['n_calls']} b128 score calls back to back, per call: "
              f"device busy {b['device_busy_ms']:.3f} ms of {b['wall_ms']:.3f} ms wall "
              f"(profiled), idle share {b['idle_share']:.4f}; unprofiled throughput run "
              f"{b['batch_ms_in_throughput_run']:.3f} ms per batch; by category: "
              + ", ".join(f"{c} {ms:.3f} ms" for c, ms in
                          sorted(b["by_category_ms"].items(), key=lambda kv: -kv[1])),
              flush=True)
        for k, ms, n in b["top_kernels_ms"]:
            print(f"[profile]   {ms:9.3f} ms  x{n:<4d} {k}")
    report["main_path"] = {
        "launches": launches, "corr_int8_f32": corr_int8, "median_rel_int8_f32": rel_int8,
        "corr_bf16_f32": corr_bf16, "median_rel_bf16_f32": rel_bf16,
        "throughput_img_per_s": tput, "latency_b1_ms": lat, "setup_s": setup_s,
        "device_breakdown_b128": breakdown,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    # --- the same int8 forward at batch 2 on the CPU (plain versions) --------
    fwd = tq.make_quantized_forward("anomaly_unet", score_only=True)
    two = images[:2]
    with torch.no_grad():
        gpu = fwd(int8.qparams, torch.from_numpy(two).cuda()).cpu()
        t1 = time.perf_counter()
        cpu = fwd(tq.tree_to(int8.qparams, "cpu"), torch.from_numpy(two))
    err = float((gpu - cpu).abs().max())
    print(f"[cpu] int8 forward b2 on the CPU ({time.perf_counter() - t1:.1f} s) vs the "
          f"card: max |recon diff| {err:.3g}", flush=True)
    check(err <= 1e-5, f"CPU and card int8 forwards differ by {err}")
    report["cpu_vs_card_int8_recon_max_abs_err"] = err
    return launches


def _unet_flops(base, h, w, n_channels, heads):
    """Model FLOPs of one ladder-UNet forward on one h x w image (2 per
    multiply-add) over its convolutions, transposed convolutions and heads:
    the shared encoder, then one decoder per entry of ``heads`` (its head's
    output channels)."""
    def conv(cin, cout, hh, ww, k=3):
        return 2 * cin * cout * k * k * hh * ww
    chans = [base * 2 ** i for i in range(5)]
    total = conv(n_channels, base, h, w) + conv(base, base, h, w)
    for i in range(1, 5):
        total += (conv(chans[i - 1], chans[i], h >> i, w >> i)
                  + conv(chans[i], chans[i], h >> i, w >> i))
    for head in heads:
        for i in range(4):
            cin, cout, hh, ww = chans[4 - i], chans[3 - i], h >> (3 - i), w >> (3 - i)
            total += (2 * cin * (cin // 2) * hh * ww + conv(cin, cout, hh, ww)
                      + conv(cout, cout, hh, ww))
        total += 2 * base * head * h * w
    return total


def forward_flops(base, size, n_channels=3):
    """Model FLOPs of one AnomalyUNet forward (the reconstruction and
    segmentation decoders) on one size x size image."""
    return _unet_flops(base, size, size, n_channels, (n_channels, 1))


def synth_masks(torch, n, size, seed, device, blobs=3):
    """Seeded uint8 (n, size, size, 1) masks, each with a few round defects."""
    g = torch.Generator(device=device).manual_seed(seed)
    centre = torch.rand(n, blobs, 2, generator=g, device=device) * size
    radius = 4 + torch.rand(n, blobs, generator=g, device=device) * 16
    grid = torch.arange(size, device=device, dtype=torch.float32)
    dy = grid[None, None, :, None] - centre[..., 0, None, None]
    dx = grid[None, None, None, :] - centre[..., 1, None, None]
    inside = (dy ** 2 + dx ** 2) < radius[..., None, None] ** 2
    return inside.any(dim=1)[..., None].to(torch.uint8)


def _timed_steps(torch, np, step, state, images, masks, g, warmup, steps):
    """Run ``warmup`` then ``steps`` train steps, a CUDA event after each (no
    host read inside the window). Returns the window's mean ms per step, the
    median step's ms and every step's losses."""
    losses = [step(state, images, masks, g) for _ in range(warmup)]
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    events[0].record()
    for ev in events[1:]:
        losses.append(step(state, images, masks, g))
        ev.record()
    torch.cuda.synchronize()
    per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    totals = {k: torch.stack([ld[k] for ld in losses]).cpu().numpy() for k in losses[0]}
    return events[0].elapsed_time(events[-1]) / steps, float(np.median(per_step)), totals


def phase_train(torch, np, report):
    """The flagship training step at full width, its profile, the other
    rotation modes and the eval step; returns the launch counts of the
    train and eval paths."""
    from tpu_unet_torch.core.precision import get_policy
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8
    from tpu_unet_torch.train.state import create_train_state, num_params
    from tpu_unet_torch.train.steps import (AugmentConfig, make_anomaly_eval_step,
                                            make_anomaly_train_step)

    b, size, base = 16, 256, 64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(2)
    state = create_train_state(build_model("anomaly_unet", base_features=base,
                                           policy=get_policy("bf16")),
                               "adam", 1e-3, 1e-4, device="cuda")
    check(num_params(state) == 43_228_228, f"AnomalyUNet has {num_params(state)} params")
    images = torch.from_numpy(synth_images(torch, b, size, 40, "cuda")).cuda()
    masks = synth_masks(torch, b, size, 41, "cuda")
    step = make_anomaly_train_step(aug_cfg=AugmentConfig())
    g = torch.Generator(device="cuda").manual_seed(0)

    # The fixed batch of the loss check: the same images, masks and draws,
    # before the first step and after the last.
    probe_draws = step.draws(b, g)

    # --- the train path: counters zeroed just before, read just after --------
    normalize_u8.launches = conv3x3_int8.launches = 0
    first = step.with_draws(state, images, masks, probe_draws)
    step_ms, median_ms, losses = _timed_steps(torch, np, step, state, images, masks, g,
                                              warmup=3, steps=20)
    last = step.with_draws(state, images, masks, probe_draws)
    train_launches = {"normalize_u8": normalize_u8.launches,
                      "conv3x3_int8": conv3x3_int8.launches}
    check(train_launches == {"normalize_u8": 0, "conv3x3_int8": 0},
          f"the train step launched {train_launches} (want no K1 and no K2)")
    # -------------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k, v in losses.items():
        check(np.isfinite(v).all(), f"train {k} not finite: {v}")
    total = losses["total_loss"]
    probe = (float(first["total_loss"]), float(last["total_loss"]))
    check(np.isfinite(probe).all() and probe[1] < probe[0],
          f"the loss on the fixed batch did not fall over 24 steps: {probe}")
    img_s = b * 1e3 / step_ms
    flops = 3 * forward_flops(base, size) * b
    mfu = flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS
    print(f"[train] AnomalyUNet base {base}, bf16, {size}², b{b}, Adam, per_batch_shear: "
          f"{step_ms:.3f} ms per step (median step {median_ms:.3f} ms), {img_s:.1f} img/s "
          f"(20 steps after 3 warm-up); "
          f"peak memory allocated {peak_gb:.2f} GB; model FLOPs {flops / 1e12:.3f} TFLOP "
          f"per step (3x {forward_flops(base, size) / 1e9:.1f} GFLOP forward per image), "
          f"{100 * mfu:.1f}% of the bf16 dense peak; total loss on the fixed batch "
          f"{probe[0]:.4f} -> {probe[1]:.4f} after 24 steps; last timed step: recon "
          f"{losses['recon_loss'][-1]:.4f}, seg {losses['seg_loss'][-1]:.4f}", flush=True)

    prof = device_breakdown(torch, lambda: step(state, images, masks, g), n_calls=5,
                            top=20, category=_train_category)
    prof["step_ms_in_timed_run"] = step_ms
    print(f"[profile] train, 5 steps back to back, per step: device busy "
          f"{prof['device_busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall (profiled), "
          f"idle share {prof['idle_share']:.4f}; unprofiled timed run {step_ms:.3f} ms "
          f"per step; by category: "
          + ", ".join(f"{c} {ms:.3f} ms" for c, ms in
                      sorted(prof["by_category_ms"].items(), key=lambda kv: -kv[1])),
          flush=True)
    for k, ms, n in prof["top_kernels_ms"]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<4d} {k}")

    # The augment layer alone (train_transform of the batch and its masks),
    # profiled: its device busy time, and its wall time, which the host's
    # launches set when nothing else is queued.
    from tpu_unet_torch.ops.augment import sample_augment_draws, train_transform
    augment = {}
    for mode in ("per_batch_shear", "per_sample", "per_sample_shear"):
        cfg = AugmentConfig(rotation_mode=mode)
        draws = sample_augment_draws(b, cfg, g)
        p = device_breakdown(torch, lambda: train_transform(
            images, masks, draws, **cfg.transform_kwargs()), n_calls=10, top=3,
            category=_train_category)
        augment[mode] = {"device_busy_ms": p["device_busy_ms"], "wall_ms": p["wall_ms"],
                         "top_kernels_ms": p["top_kernels_ms"]}
    print("[train] augment alone (train_transform, b16 images and masks), per call: "
          + ", ".join(f"{m} device busy {a['device_busy_ms']:.3f} ms of {a['wall_ms']:.3f} "
                      f"ms wall" for m, a in augment.items()), flush=True)

    modes = {}
    for mode in ("per_sample", "per_sample_shear"):
        ms, med, ls = _timed_steps(torch, np, make_anomaly_train_step(
            aug_cfg=AugmentConfig(rotation_mode=mode)), state, images, masks, g,
            warmup=2, steps=10)
        check(np.isfinite(ls["total_loss"]).all(), f"{mode}: loss not finite")
        modes[mode] = {"step_ms": ms, "median_step_ms": med, "img_per_s": b * 1e3 / ms}
        print(f"[train] rotation_mode={mode}: {ms:.3f} ms per step (median step "
              f"{med:.3f} ms), {b * 1e3 / ms:.1f} img/s (10 steps after 2 warm-up)",
              flush=True)

    # --- the eval path on the trained state: K1 once per batch ---------------
    eval_step = make_anomaly_eval_step()
    batches = [torch.from_numpy(synth_images(torch, b, size, 50 + i, "cuda")).cuda()
               for i in range(3)]
    eval_masks = synth_masks(torch, b, size, 60, "cuda")
    normalize_u8.launches = conv3x3_int8.launches = 0
    outs = [eval_step(state, x, eval_masks) for x in batches]
    eval_launches = {"normalize_u8": normalize_u8.launches,
                     "conv3x3_int8": conv3x3_int8.launches}
    check(eval_launches == {"normalize_u8": 3, "conv3x3_int8": 0},
          f"3 eval batches launched {eval_launches} (want K1 3x, K2 0x)")
    # -------------------------------------------------------------------------
    shapes = {"score": (b,), "error_map": (b, size, size), "anomaly_map": (b, size, size),
              "reconstruction": (b, size, size, 3), "image": (b, size, size, 3)}
    for out in outs:
        for k, shape in shapes.items():
            check(tuple(out[k].shape) == shape and bool(torch.isfinite(out[k]).all()),
                  f"eval {k}: shape {tuple(out[k].shape)} (want {shape}) or not finite")
        check(all(bool(torch.isfinite(v)) for v in out["losses"].values()),
              "eval losses not finite")
    eval_loss = float(outs[0]["losses"]["total_loss"])
    print(f"[eval] eval step b{b} on the trained state, 3 batches: K1 launched "
          f"{eval_launches['normalize_u8']}x, K2 {eval_launches['conv3x3_int8']}x; outputs "
          f"finite, of the right shapes; total loss {eval_loss:.4f}", flush=True)
    report["train"] = {
        "config": {"model": "anomaly_unet", "base_features": base, "precision": "bf16",
                   "image_size": size, "batch": b, "optimizer": "adam", "lr": 1e-3,
                   "weight_decay": 1e-4, "rotation_mode": "per_batch_shear"},
        "step_ms": step_ms, "median_step_ms": median_ms, "img_per_s": img_s,
        "peak_mem_gb": peak_gb,
        "model_tflop_per_step": flops / 1e12, "model_flop_share_bf16_peak": mfu,
        "total_loss_by_step": total.tolist(), "fixed_batch_total_loss": probe,
        "device_breakdown": prof,
        "rotation_modes": modes, "augment": augment, "eval_total_loss": eval_loss,
        "launches": {"train_step": train_launches, "eval_step": eval_launches}}
    del state, outs
    torch.cuda.empty_cache()
    return {"train_step": train_launches, "eval_step": eval_launches}


def _state_dict_errs(sd_cpu, sd_gpu):
    """Largest |difference| over a leaf's largest |value|: (parameters, BN
    running statistics)."""
    param_err = stat_err = 0.0
    for k, v in sd_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((sd_gpu[k].cpu() - v).abs().max() / v.abs().max().clamp(min=1e-12))
        if k.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, err)
        else:
            param_err = max(param_err, err)
    return param_err, stat_err


def phase_train_cpu_vs_card(torch, np, report):
    """One small f32 SGD step on the CPU and on the card from the same weights
    and the same draws (TF32 is off)."""
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.ops.augment import sample_augment_draws
    from tpu_unet_torch.train.state import create_train_state
    from tpu_unet_torch.train.steps import AugmentConfig, make_anomaly_train_step

    b, size, base = 4, 64, 8
    torch.manual_seed(3)
    cpu_model = build_model("anomaly_unet", base_features=base)
    gpu_model = build_model("anomaly_unet", base_features=base)
    gpu_model.load_state_dict(cpu_model.state_dict())
    cpu = create_train_state(cpu_model, "sgd", 0.05, 1e-4, device="cpu")
    gpu = create_train_state(gpu_model, "sgd", 0.05, 1e-4, device="cuda")
    images = synth_images(torch, b, size, 70, "cpu")
    masks = synth_masks(torch, b, size, 71, "cpu").numpy()
    cfg = AugmentConfig()
    draws = sample_augment_draws(b, cfg, torch.Generator().manual_seed(5))
    step = make_anomaly_train_step(aug_cfg=cfg)
    l_cpu = step.with_draws(cpu, images, masks, draws)
    l_gpu = step.with_draws(gpu, images, masks, draws.to("cuda"))
    loss_rel = max(abs(float(l_gpu[k]) - float(l_cpu[k])) / abs(float(l_cpu[k]))
                   for k in ("total_loss", "recon_loss", "seg_loss"))
    param_err, stat_err = _state_dict_errs(cpu.model.state_dict(), gpu.model.state_dict())
    print(f"[train-cpu] base {base}, {size}², b{b}, f32, SGD, one step, same weights and "
          f"draws: losses max rel diff {loss_rel:.3g}; parameters max |diff| / leaf max "
          f"{param_err:.3g}; BN running stats {stat_err:.3g}", flush=True)
    check(loss_rel <= 1e-5, f"CPU and card losses differ by {loss_rel:.3g} (rel)")
    check(param_err <= TRAIN_PARAM_TOL, f"CPU and card parameters differ by {param_err:.3g}")
    check(stat_err <= TRAIN_STAT_TOL, f"CPU and card BN statistics differ by {stat_err:.3g}")
    report["train_cpu_vs_card"] = {"loss_max_rel": loss_rel, "param_max_rel_to_leaf": param_err,
                                   "bn_stat_max_rel_to_leaf": stat_err,
                                   "param_tol": TRAIN_PARAM_TOL, "stat_tol": TRAIN_STAT_TOL}


# MVTec bottle's split sizes: train/good, test/good and its three defect types.
BOTTLE_TRAIN_GOOD, BOTTLE_TEST_GOOD = 209, 20
BOTTLE_DEFECTS = {"broken_large": 20, "broken_small": 22, "contamination": 21}
BOTTLE_SIZE = 900  # MVTec bottle's images are 900 x 900


def write_bottle(torch, np, root):
    """Write a seeded category ``bottle`` of MVTec bottle's counts and size
    under ``root`` in the MVTec AD layout: textures with round defects
    painted where the ``ground_truth`` masks mark them. Returns the bytes
    written."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def save(arr, path):
        Image.fromarray(arr).save(path, format="PNG", compress_level=1)
        return os.path.getsize(path)

    groups = [("train", "good", BOTTLE_TRAIN_GOOD), ("test", "good", BOTTLE_TEST_GOOD)]
    groups += [("test", t, n) for t, n in sorted(BOTTLE_DEFECTS.items())]
    cat = os.path.join(root, "bottle")
    jobs = []
    with ThreadPoolExecutor(max_workers=8) as pool:
        for gi, (split, atype, n) in enumerate(groups):
            img_dir, gt_dir = (os.path.join(cat, split, atype),
                               os.path.join(cat, "ground_truth", atype))
            os.makedirs(img_dir)
            if atype != "good":
                os.makedirs(gt_dir)
            for lo in range(0, n, 16):
                k = min(16, n - lo)
                seed = 1000 + 100 * gi + lo
                imgs = synth_images(torch, k, BOTTLE_SIZE, seed, "cuda")
                masks = None
                if atype != "good":  # defects drawn at 256 px, scaled
                    m = synth_masks(torch, k, 256, seed + 1, "cuda").permute(0, 3, 1, 2)
                    m = torch.nn.functional.interpolate(m.float(), size=BOTTLE_SIZE)
                    masks = m[:, 0].to(torch.bool).cpu().numpy()
                    imgs[masks] = (imgs[masks] * 0.3).astype(np.uint8) + np.uint8(40)
                for i in range(k):
                    name = f"{lo + i:03d}"
                    jobs.append(pool.submit(save, imgs[i], os.path.join(img_dir, name + ".png")))
                    if masks is not None:
                        jobs.append(pool.submit(save, (masks[i] * 255).astype(np.uint8),
                                                os.path.join(gt_dir, name + "_mask.png")))
        return sum(j.result() for j in jobs)


class _Spans:
    """``train_mvtec.train``'s ``span`` hook: each epoch's train and validate
    pass timed between device syncs, with the kernels' launch counters zeroed
    at its start and read at its end."""

    def __init__(self, torch, kernels):
        self.torch, self.kernels, self.rows = torch, kernels, {}

    @contextlib.contextmanager
    def __call__(self, name, epoch):
        for k in self.kernels:
            k.launches = 0
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        self.torch.cuda.synchronize()
        self.rows[name, epoch] = {"seconds": time.perf_counter() - t0,
                                  **{k.__name__: k.launches for k in self.kernels}}

    def total(self, name):
        rows = [r for (n, _), r in self.rows.items() if n == name]
        return {k.__name__: sum(r[k.__name__] for r in rows) for k in self.kernels}


def _trace_device_ms(path):
    """Device busy ms in a torch.profiler chrome trace (kernels, copies, sets)
    and the ms from the trace's first event to its first kernel."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e.get("dur", 0) for e in gpu) / 1e3
    first = (min(e["ts"] for e in gpu) - min(e["ts"] for e in events)) / 1e3
    return busy, first


def _adam_step(torch, path):
    blob = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return int(blob["optimizer_state_dict"]["state"][0]["step"])


def phase_mvtec(torch, np, report, keep):
    """Phase 8: the MVTec main path at full width through the train and test
    CLIs' own functions (``train_mvtec.train``; ``test_mvtec``'s
    ``make_test_loader``, ``load_model``, ``test_model``, ``evaluate_results``,
    ``save_results``) on a synthetic category written as PNG files and read
    by ``MVTecDataset``. Only the CLIs' ``main``s are not called: their plots
    need matplotlib, which the card's machine does not have. The category
    (``bottle``) and ``best_model.pth`` (``mvtec_best_model.pth``) are moved
    to ``keep`` for phase 12. Returns the launch counts of each leg."""
    from tpu_unet_torch.cli import test_mvtec, train_mvtec
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8

    kernels = (normalize_u8, conv3x3_int8)

    def zero():
        normalize_u8.launches = conv3x3_int8.launches = 0

    def counts():
        return {"normalize_u8": normalize_u8.launches, "conv3x3_int8": conv3x3_int8.launches}

    print("[mvtec] through the CLIs' functions: train_mvtec.train; test_mvtec.make_test_loader, "
          "load_model, test_model, evaluate_results, save_results; MVTecDataset on PNG files "
          "(the CLIs' plots are skipped: matplotlib is not installed on this machine)",
          flush=True)
    b, epochs = 16, 3
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mvtec_")
    data_root = os.path.join(tmp, "data")
    common = ["--data_root", data_root, "--category", "bottle", "--model", "anomaly_unet",
              "--base_features", "64", "--image_size", "256", "--batch_size", str(b),
              "--num_workers", "4", "--device", "cuda"]
    train_flags = common + ["--precision", "bf16", "--optimizer", "adam", "--epochs",
                            str(epochs), "--val_freq", "1", "--save_freq", "2",
                            "--save_dir", os.path.join(tmp, "runs")]
    out = {"mode": "cli functions", "config": {
        "category": "synthetic bottle", "image_px": BOTTLE_SIZE, "train_good": BOTTLE_TRAIN_GOOD,
        "test_good": BOTTLE_TEST_GOOD, "defects": BOTTLE_DEFECTS, "train_flags": train_flags}}
    legs = {}
    try:
        t0 = time.perf_counter()
        n_bytes = write_bottle(torch, np, data_root)
        out["synth_s"] = time.perf_counter() - t0
        train_ds = MVTecDataset(data_root, "bottle", "train", 256, is_train=True)
        test_ds = MVTecDataset(data_root, "bottle", "test", 256, is_train=False)
        check((len(train_ds), len(test_ds))
              == (BOTTLE_TRAIN_GOOD, BOTTLE_TEST_GOOD + sum(BOTTLE_DEFECTS.values())),
              f"dataset sizes {len(train_ds)}, {len(test_ds)}")
        print(f"[mvtec] synthetic bottle: {len(train_ds)} train, {len(test_ds)} test PNGs of "
              f"{BOTTLE_SIZE}² and their masks ({n_bytes / 1e6:.0f} MB) written in "
              f"{out['synth_s']:.1f} s", flush=True)

        # --- 3 epochs, validation each, the 2nd epoch profiled ------------------
        args = train_mvtec.parse_args(train_flags + ["--profile_dir", os.path.join(tmp, "prof")])
        exp = os.path.join(tmp, "runs", "bottle")
        spans = _Spans(torch, kernels)
        results = train_mvtec.train(args, train_ds, test_ds, dev, exp, span=spans)
        with open(os.path.join(exp, "results", "history.jsonl")) as f:
            hist = [json.loads(line) for line in f]
        check([h["epoch"] for h in hist] == list(range(epochs)), f"history {hist}")
        n_steps = BOTTLE_TRAIN_GOOD // b
        n_val = -(-len(test_ds) // b)
        busy, first_kernel = _trace_device_ms(os.path.join(tmp, "prof", "trace.json"))
        rows = []
        for h in hist:
            e = h["epoch"]
            tr, va = spans.rows["train", e], spans.rows["validate", e]
            check(tr["normalize_u8"] == tr["conv3x3_int8"] == 0,
                  f"epoch {e}'s train steps launched {tr} (want no kernel)")
            check(va["normalize_u8"] == n_val and va["conv3x3_int8"] == 0,
                  f"validation launched {va} for {n_val} batches (want K1 once per batch, no K2)")
            check(all(np.isfinite(h[k]) for k in ("total_loss", "val_loss", "val_auroc")),
                  f"epoch {e}: {h}")
            row = {"epoch": e, "train_s": tr["seconds"],
                   "train_img_per_s": n_steps * b / tr["seconds"],
                   "decode": "cold" if e == 0 else "cached", "profiled": e == 1,
                   "val_s": va["seconds"], "val_batches": n_val, **h}
            rows.append(row)
        prof_wall = 1e3 * rows[1]["train_s"]
        idle = {"device_busy_ms": busy, "first_kernel_ms": first_kernel,
                "idle_share_profiled": 1 - busy / prof_wall,
                "idle_share_vs_epoch2_wall": 1 - busy / (1e3 * rows[2]["train_s"])}
        for r in rows:
            print(f"[mvtec] epoch {r['epoch']} ({r['decode']} decode"
                  f"{', profiled' if r['profiled'] else ''}): train {r['train_s']:.3f} s, "
                  f"{r['train_img_per_s']:.1f} img/s with the loader (phase 6, device-resident "
                  f"batches: {report['train']['img_per_s']:.1f}); validation {r['val_s']:.3f} s "
                  f"({n_val} batches, K1 {n_val}x, K2 0x); loss {r['total_loss']:.4f}, val loss "
                  f"{r['val_loss']:.4f}, val AUROC {r['val_auroc']:.4f}", flush=True)
        print(f"[mvtec] epoch 1 profiled (--profile_dir): device busy {busy:.1f} ms of "
              f"{prof_wall:.1f} ms, idle share {idle['idle_share_profiled']:.4f}; against epoch "
              f"2's unprofiled {1e3 * rows[2]['train_s']:.1f} ms: "
              f"{idle['idle_share_vs_epoch2_wall']:.4f}; first kernel {first_kernel:.1f} ms "
              f"into the trace", flush=True)
        for w in results["checkpoint_writes"]:
            print(f"[mvtec] checkpoint {os.path.basename(w['path'])}: {w['bytes'] / 1e6:.1f} MB, "
                  f"async write {w['seconds']:.3f} s", flush=True)
        ckpt = os.path.join(exp, "checkpoints")
        check(sorted(os.listdir(ckpt)) == ["best_model.pth", "checkpoint_epoch_0.pth",
                                           "checkpoint_epoch_2.pth"],
              f"checkpoints {sorted(os.listdir(ckpt))}")
        step_after = _adam_step(torch, os.path.join(ckpt, "checkpoint_epoch_2.pth"))
        check(step_after == epochs * n_steps, f"Adam step {step_after}")
        for name in os.listdir(ckpt):
            blob = torch.load(os.path.join(ckpt, name), map_location="cpu", weights_only=True,
                              mmap=True)
            check(set(blob) == {"epoch", "model_state_dict", "optimizer_state_dict", "loss"},
                  f"{name} keys {sorted(blob)}")
        for name in ("args.json", "results/training_results.json"):
            with open(os.path.join(exp, name)) as f:
                json.load(f)
        out.update(epochs=rows, idle=idle, checkpoint_writes=results["checkpoint_writes"])
        legs["mvtec_train"] = spans.total("train")
        legs["mvtec_validate"] = spans.total("validate")
        torch.cuda.empty_cache()

        # --- the test path on best_model.pth in three modes ---------------------
        best = os.path.join(ckpt, "best_model.pth")
        tests = {}
        for mode, flags in (("bf16", ["--precision", "bf16"]),
                            ("f32_fold_bn", ["--precision", "f32", "--fold_bn"]),
                            ("int8", ["--precision", "bf16", "--quantize", "int8",
                                      "--calib_samples", "64"])):
            targs = test_mvtec.parse_args(common + flags + [
                "--checkpoint", best, "--output_dir", os.path.join(tmp, "test", mode)])
            zero()
            t0 = time.perf_counter()
            loader = test_mvtec.make_test_loader(targs, test_ds, dev)
            state, step = test_mvtec.load_model(targs, dev,
                                                train_ds if mode == "int8" else None)
            torch.cuda.synchronize()
            t1, calib_k1 = time.perf_counter(), normalize_u8.launches
            res = test_mvtec.test_model(step, state, loader)
            t2 = time.perf_counter()
            ev = test_mvtec.evaluate_results(res, targs.pixel_thresholds, targs.threshold)
            t3 = time.perf_counter()
            c = counts()
            legs[f"mvtec_test_{mode}"] = c
            chunks = 64 // 16 if mode == "int8" else 0  # calibration batches
            want = {"normalize_u8": n_val + chunks,
                    "conv3x3_int8": 26 * n_val if mode == "int8" else 0}
            check(c == want and calib_k1 == chunks,
                  f"test {mode} launched {c} (calibration K1 {calib_k1}x), want {want}")
            out_dir = os.path.join(targs.output_dir, "bottle_test_results")
            test_mvtec.save_results(res, ev, out_dir, targs)
            for name in ("test_metrics.json", "detailed_results.json"):
                with open(os.path.join(out_dir, name)) as f:
                    json.load(f)
            metrics = {**ev["image_metrics"],
                       **{f"pixel_f1_{k}": v["f1_score"] for k, v in ev["pixel_metrics"].items()}}
            check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()),
                  f"test {mode} metrics not finite in [0, 1]: {metrics}")
            check(res["anomaly_scores"].shape == (len(test_ds),)
                  and np.isfinite(res["anomaly_scores"]).all(), f"test {mode} scores")
            tests[mode] = {"seconds": t3 - t0, "img_per_s": len(test_ds) / (t3 - t0),
                           "launches": c, "load_model_s": t1 - t0, "test_model_s": t2 - t1,
                           "evaluate_results_s": t3 - t2, "threshold": res["threshold"],
                           "metrics": metrics, "scores": res["anomaly_scores"]}
            print(f"[mvtec] test {mode}: {t3 - t0:.3f} s, {len(test_ds) / (t3 - t0):.1f} img/s "
                  f"(cached decode): load_model {t1 - t0:.3f} s"
                  f"{' (calibration on 64 images included)' if mode == 'int8' else ''}, "
                  f"test_model {t2 - t1:.3f} s, evaluate_results {t3 - t2:.3f} s; "
                  f"K1 {c['normalize_u8']}x, K2 {c['conv3x3_int8']}x for {n_val} batches; "
                  f"AUROC {metrics['auroc']:.4f}, AUPRC {metrics['auprc']:.4f}, threshold "
                  f"{res['threshold']:.5f}, pixel F1 @0.3/0.5/0.7 "
                  + "/".join(f"{metrics[f'pixel_f1_threshold_{t}']:.4f}" for t in (0.3, 0.5, 0.7)),
                  flush=True)
            del state, step
            torch.cuda.empty_cache()
        ref = tests["f32_fold_bn"]["scores"]
        for mode in ("bf16", "int8"):
            s = tests[mode]["scores"]
            tests[mode]["corr_vs_f32"] = float(np.corrcoef(s, ref)[0, 1])
            tests[mode]["median_rel_vs_f32"] = float(np.median(np.abs(s - ref) / np.abs(ref)))
            print(f"[mvtec] test {mode} scores vs f32 --fold_bn: 1 - corr "
                  f"{1 - tests[mode]['corr_vs_f32']:.2e}, median rel diff "
                  f"{tests[mode]['median_rel_vs_f32']:.3e}", flush=True)
        check(tests["int8"]["corr_vs_f32"] > MVTEC_MIN_CORR
              and tests["int8"]["median_rel_vs_f32"] < MVTEC_INT8_REL,
              "int8 test scores do not track f32")
        check(tests["bf16"]["corr_vs_f32"] > MVTEC_MIN_CORR
              and tests["bf16"]["median_rel_vs_f32"] < MVTEC_BF16_REL,
              "bf16 test scores do not track f32")
        for t in tests.values():
            t["scores"] = t["scores"].tolist()
        out["test"] = tests

        # --- --resume checkpoint_epoch_0.pth --epochs 2 ---------------------------
        ck0 = os.path.join(ckpt, "checkpoint_epoch_0.pth")
        rargs = train_mvtec.parse_args(train_flags + ["--epochs", "2", "--resume", ck0])
        rexp = os.path.join(tmp, "runs", "bottle_resume")
        rspans = _Spans(torch, kernels)
        train_mvtec.train(rargs, train_ds, test_ds, dev, rexp, span=rspans)
        with open(os.path.join(rexp, "results", "history.jsonl")) as f:
            rhist = [json.loads(line) for line in f]
        steps = (_adam_step(torch, ck0),
                 _adam_step(torch, os.path.join(rexp, "checkpoints", "checkpoint_epoch_1.pth")))
        legs["mvtec_resume"] = {k: rspans.total("train")[k] + rspans.total("validate")[k]
                                for k in ("normalize_u8", "conv3x3_int8")}
        check([h["epoch"] for h in rhist] == [1], f"resumed history {rhist}")
        check(steps == (n_steps, 2 * n_steps),
              f"Adam step {steps[0]} -> {steps[1]} (want {n_steps} -> {2 * n_steps})")
        check(rspans.total("train") == {"normalize_u8": 0, "conv3x3_int8": 0}
              and rspans.total("validate") == {"normalize_u8": n_val, "conv3x3_int8": 0},
              f"resume launched {rspans.rows}")
        rel = abs(rhist[0]["total_loss"] - hist[1]["total_loss"]) / hist[1]["total_loss"]
        print(f"[mvtec] --resume checkpoint_epoch_0.pth --epochs 2: epochs "
              f"{[h['epoch'] for h in rhist]}, Adam step {steps[0]} -> {steps[1]}; epoch 1 loss "
              f"{rhist[0]['total_loss']:.5f} (cosine LR over 2 epochs) against the 3-epoch "
              f"run's {hist[1]['total_loss']:.5f} (rel diff {rel:.2e})", flush=True)
        out["resume"] = {"history": rhist, "adam_step": list(steps),
                         "epoch1_loss_rel_diff_vs_3_epoch_run": rel}
        shutil.copy(best, os.path.join(keep, "mvtec_best_model.pth"))
        shutil.rmtree(os.path.join(tmp, "runs"))  # 3.6 GB of checkpoints
        torch.cuda.empty_cache()

        out["cpu_vs_card"] = _mvtec_cpu_vs_card(torch, np, data_root, tmp)
        shutil.move(data_root, os.path.join(keep, "bottle"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["main_path"]["mvtec"] = out
    return legs


def _mvtec_cpu_vs_card(torch, np, data_root, tmp):
    """Base 8, 64 px, f32: one epoch of ``train_mvtec.train`` on the card, its
    .pth loaded on the CPU (strict, optimizer included) and back on the card;
    the test path on both."""
    from tpu_unet_torch.cli import test_mvtec, train_mvtec
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from tpu_unet_torch.train.state import create_train_state

    small = ["--data_root", data_root, "--category", "bottle", "--base_features", "8",
             "--image_size", "64", "--batch_size", "16", "--num_workers", "4",
             "--precision", "f32"]
    train_ds = MVTecDataset(data_root, "bottle", "train", 64, is_train=True)
    test_ds = MVTecDataset(data_root, "bottle", "test", 64, is_train=False)
    exp = os.path.join(tmp, "small")
    train_mvtec.train(train_mvtec.parse_args(small + ["--epochs", "1", "--device", "cuda"]),
                      train_ds, test_ds, torch.device("cuda"), exp)
    path = os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth")
    written = torch.load(path, map_location="cpu", weights_only=True)["optimizer_state_dict"]

    def state_on(device):
        return create_train_state(build_model("anomaly_unet", base_features=8),
                                  "adam", 1e-3, 1e-4, device=device)

    def same_adam(opt):
        got = opt.state_dict()["state"]
        return all(torch.equal(got[i][k].cpu(), v) for i, s in written["state"].items()
                   for k, v in s.items())

    cpu = state_on("cpu")
    load_checkpoint(cpu, path)  # strict=True, optimizer included
    check(same_adam(cpu.optimizer), "Adam state differs after the card -> CPU load")
    back = os.path.join(tmp, "small_cpu.pth")
    save_checkpoint(cpu, 0, 0.0, back)
    card = state_on("cuda")
    load_checkpoint(card, back)
    check(same_adam(card.optimizer), "Adam state differs after the card -> CPU -> card trip")
    check(card.optimizer.param_groups[0].get("fused") is True
          and not cpu.optimizer.param_groups[0].get("fused"),
          "a load changed the optimizer's implementation")
    results = {}
    for name in ("cpu", "cuda"):
        targs = test_mvtec.parse_args(small + ["--checkpoint", path, "--device", name])
        dev = torch.device(name)
        state, step = test_mvtec.load_model(targs, dev)
        res = test_mvtec.test_model(step, state, test_mvtec.make_test_loader(targs, test_ds, dev))
        results[name] = (res, test_mvtec.evaluate_results(res, targs.pixel_thresholds))
    (rc, ec), (rg, eg) = results["cpu"], results["cuda"]
    rel = float(np.max(np.abs(rg["anomaly_scores"] - rc["anomaly_scores"])
                       / np.abs(rc["anomaly_scores"])))
    thr_rel = abs(rg["threshold"] - rc["threshold"]) / abs(rc["threshold"])
    print(f"[mvtec-cpu] base 8, 64², f32: a .pth written by train_mvtec.train on the card "
          f"loads on the CPU (strict, Adam state equal, and back); test path scores max rel "
          f"diff {rel:.3g}, threshold rel diff {thr_rel:.3g}, image metrics "
          f"{'equal' if ec['image_metrics'] == eg['image_metrics'] else 'DIFFER'} "
          f"(AUROC {ec['image_metrics']['auroc']:.4f})", flush=True)
    check(rel <= 1e-5, f"CPU and card test scores differ by {rel:.3g} (rel)")
    check(thr_rel <= 1e-5, f"CPU and card thresholds differ by {thr_rel:.3g} (rel)")
    check(ec["image_metrics"] == eg["image_metrics"],
          f"image metrics differ: {ec['image_metrics']} vs {eg['image_metrics']}")
    return {"scores_max_rel": rel, "threshold_rel": thr_rel,
            "image_metrics_cpu": ec["image_metrics"], "image_metrics_card": eg["image_metrics"]}


# Phase 9's KolektorSDD epochs: epoch 0 decodes cold, epoch 1 is profiled
# (a third, cached epoch was cut to give phase 14 its time).
KSDD_EPOCHS = 2
# KolektorSDD's counts and size (SURVEY.md §2.5): 399 parts of about 500 x
# 1240-1280 px in 50 kos folders, split 279/60/60, about 99.95% background.
KSDD_PARTS, KSDD_FOLDERS, KSDD_HW, KSDD_DEFECTIVE = 399, 50, (1260, 500), 52
# Gear's counts and image size are not in the repo: these are chosen.
GEAR_SPLITS, GEAR_SIZE = {"train": 64, "val": 16, "test": 16}, 512
# Share of KolektorSDD test pixels whose int8 or bf16 prediction may differ
# from f32 --fold_bn's: about 5x what an H100 run measured (5.2e-6 int8,
# 4.2e-7 bf16; PERF.md, section 6).
SEG_MAX_DISAGREE = {"int8": 2.6e-5, "bf16": 2e-6}
# CPU against card, f32: a pixel whose top two logits lie closer than this
# may take either class.
SEG_TIE_GAP = 1e-5


def _save_all(jobs):
    """Run (fn, args) jobs on 8 threads (PIL's encoders release the GIL);
    returns the bytes written."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=8) as pool:
        return sum(f.result() for f in [pool.submit(fn, *a) for fn, a in jobs])


def _save_image(arr, path, fmt):
    from PIL import Image
    Image.fromarray(arr).save(path, format=fmt)
    return os.path.getsize(path)


def write_kolektorsdd(np, root):
    """A seeded KolektorSDD tree of the dataset's counts and size: grayscale
    JPEG parts of 1260 x 500 (a brushed-metal texture) and their
    ``_label.bmp`` masks in 50 ``kosNN`` folders. 52 parts carry a thin dark
    streak marked 1 or 2 in the mask; the rest are all background."""
    rng = np.random.default_rng(7)
    h, w = KSDD_HW
    defective = set(rng.choice(KSDD_PARTS, KSDD_DEFECTIVE, replace=False).tolist())
    yy, xx = np.mgrid[:h, :w]
    jobs = []
    for k in range(KSDD_PARTS):
        folder = os.path.join(root, f"kos{k // 8 + 1:02d}")
        os.makedirs(folder, exist_ok=True)
        img = (110 + 40 * np.sin(xx / rng.uniform(3, 9)) * rng.uniform(0.2, 1.0)
               + rng.normal(0, 12, (h, w)))
        mask = np.zeros((h, w), np.uint8)
        if k in defective:  # a streak 4-8 px wide, 200-500 px long, slanted
            y0, x0 = rng.integers(100, h - 600), rng.integers(60, w - 60)
            length, width = rng.integers(200, 500), rng.integers(4, 9)
            slope = rng.uniform(-0.3, 0.3)
            on = ((yy >= y0) & (yy < y0 + length)
                  & (np.abs(xx - x0 - slope * (yy - y0)) < width / 2))
            mask[on] = 1 + k % 2
            img[on] *= 0.35
        name = f"Part{k % 8}"
        jobs.append((_save_image, (np.clip(img, 0, 255).astype(np.uint8),
                                   os.path.join(folder, name + ".jpg"), "JPEG")))
        jobs.append((_save_image, (mask, os.path.join(folder, name + "_label.bmp"), "BMP")))
    return _save_all(jobs)


def write_gear(np, root):
    """A seeded Gear tree: 512² RGB JPEGs with painted pitting, spalling and
    scrape polygons that overlap, and their LabelMe label files."""
    from PIL import Image, ImageDraw
    rng = np.random.default_rng(8)
    colours = {0: (200, 60, 40), 1: (40, 160, 60), 2: (60, 60, 200)}
    jobs = []
    for split, n in GEAR_SPLITS.items():
        img_dir, lbl_dir = (os.path.join(root, "images", split),
                            os.path.join(root, "labels", split))
        os.makedirs(img_dir)
        os.makedirs(lbl_dir)
        for i in range(n):
            base = rng.integers(60, 140, 3)
            arr = (base + rng.normal(0, 14, (GEAR_SIZE, GEAR_SIZE, 3))).clip(0, 255)
            im = Image.fromarray(arr.astype(np.uint8))
            draw = ImageDraw.Draw(im)
            lines = []
            cx, cy = rng.uniform(0.3, 0.7, 2)
            for cls in (2, 0, 1):  # drawn in raster priority: scrape, pitting, spalling
                r = rng.uniform(0.08, 0.2)
                angles = np.sort(rng.uniform(0, 2 * np.pi, 6))
                pts = [(float(np.clip(cx + r * np.cos(a) + rng.uniform(-0.1, 0.1), 0, 1)),
                        float(np.clip(cy + r * np.sin(a) + rng.uniform(-0.1, 0.1), 0, 1)))
                       for a in angles]
                draw.polygon([(x * GEAR_SIZE, y * GEAR_SIZE) for x, y in pts],
                             fill=colours[cls])
                lines.append(f"{cls} " + " ".join(f"{x:.4f} {y:.4f}" for x, y in pts))
            with open(os.path.join(lbl_dir, f"gear_{i:03d}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            jobs.append((_save_image, (np.asarray(im), os.path.join(img_dir, f"gear_{i:03d}.jpg"),
                                       "JPEG")))
    return _save_all(jobs)


def seg_forward_flops(base, h, w, n_classes, n_channels=3):
    """Model FLOPs of one SegmentationUNet forward on one h x w image."""
    return _unet_flops(base, h, w, n_channels, (n_classes,))


class _SegSpans(_Spans):
    """``train_seg``'s ``span`` hook: :class:`_Spans`, plus each train pass's
    peak memory and, for one epoch, a torch.profiler window (device busy
    time by category)."""

    def __init__(self, torch, kernels, profile_epoch=None):
        super().__init__(torch, kernels)
        self.profile_epoch, self.profile = profile_epoch, None

    @contextlib.contextmanager
    def __call__(self, name, epoch):
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.reset_peak_memory_stats()
        prof = None
        if name == "train" and epoch == self.profile_epoch:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with super().__call__(name, epoch):
            if prof is not None:
                prof.start()
            try:
                yield
            finally:
                if prof is not None:
                    torch.cuda.synchronize()
                    prof.stop()
        self.rows[name, epoch]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if prof is not None:
            cats, busy = {}, 0.0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    ms = e.self_device_time_total / 1e3
                    busy += ms
                    cats[_train_category(e.key)] = cats.get(_train_category(e.key), 0.0) + ms
            self.profile = {"epoch": epoch, "device_busy_ms": busy, "by_category_ms": cats}


class _KeepPreds:
    """An eval step that also keeps each batch's predictions (uint8, on the
    device)."""

    def __init__(self, torch, step):
        self.torch, self.step, self.preds = torch, step, []

    def __call__(self, state, images, labels, valid=None):
        losses, preds, cm = self.step(state, images, labels, valid)
        self.preds.append(preds.to(self.torch.uint8))
        return losses, preds, cm

    def all(self, n):
        """The first ``n`` rows (the padded ones dropped)."""
        return self.torch.cat(self.preds)[:n]


class TestMode(collections.namedtuple("TestMode", "mode flags k2_per_batch ref limit")):
    """One leg of a seg test path: its flags, K2's launches per test batch,
    and the mode whose predictions it is held against (at most ``limit`` of
    the pixels may differ), or None."""


def seg_test_modes(k2_per_batch, extra=(), suffix="", limits=None):
    """bf16, f32 --fold_bn and int8 test legs (with ``extra`` flags), the
    two reduced precisions held against f32 --fold_bn within ``limits``
    (SEG_MAX_DISAGREE by default)."""
    limits = limits or SEG_MAX_DISAGREE
    ref = "f32_fold_bn" + suffix
    return [TestMode("bf16" + suffix, ["--precision", "bf16", *extra], 0, ref, limits["bf16"]),
            TestMode(ref, ["--precision", "f32", "--fold_bn", *extra], 0, None, None),
            TestMode("int8" + suffix, ["--precision", "bf16", "--quantize", "int8",
                                       "--calib_samples", "32", *extra], k2_per_batch, ref,
                     limits["int8"])]


def _seg_dataset(torch, np, report_out, legs, name, train_mod, test_mod, data_root, tmp,
                 epochs, test_modes, model_flags=(), profile_epoch=None,
                 flops_fn=None, checkpoint=None, loss_must_fall=False):
    """One dataset's seg path through the CLIs' functions: ``train_seg``
    for ``epochs`` epochs with validation each (``profile_epoch`` profiled),
    then the test path per :class:`TestMode` on ``checkpoint`` (the last
    epoch's by default). ``model_flags`` go to training and testing;
    ``flops_fn(base, h, w, n_classes)`` is the model's forward FLOPs per
    image (SegmentationUNet's by default); ``loss_must_fall``: the last
    epoch's train loss must be below the first's. Returns the experiment
    directory, the flags common to training and testing, and the datasets."""
    from tpu_unet_torch.cli import _seg_common as seg
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8
    from tpu_unet_torch.train.loop import validate_seg_epoch

    kernels = (normalize_u8, conv3x3_int8)
    dev = torch.device("cuda")
    common = ["--data_root", data_root, "--batch_size", str(SEG_BATCH), "--num_workers", "4",
              "--device", "cuda", *model_flags]
    train_flags = common + ["--epochs", str(epochs), "--val_freq", "1", "--save_freq", "1",
                            "--save_dir", os.path.join(tmp, "runs")]
    args = train_mod.parse_args(train_flags)
    workload = train_mod.make_workload()
    h, w = workload.image_size_hw(args)
    train_ds, val_ds, test_ds, n_classes, class_names = workload.make_datasets(args)
    out = {"config": {"train_flags": train_flags, "image_hw": [h, w], "classes": n_classes,
                      "train": len(train_ds), "val": len(val_ds), "test": len(test_ds),
                      "augment": workload.augment.kwargs()}}
    n_steps = len(train_ds) // SEG_BATCH
    n_val = -(-len(val_ds) // SEG_BATCH)
    n_test = -(-len(test_ds) // SEG_BATCH)

    exp = os.path.join(tmp, "runs", name)
    spans = _SegSpans(torch, kernels, profile_epoch=profile_epoch)
    results = seg.train_seg(args, workload, train_ds, val_ds, n_classes, dev, exp, span=spans)
    with open(os.path.join(exp, "results", "history.jsonl")) as f:
        hist = [json.loads(line) for line in f]
    check([h_["epoch"] for h_ in hist] == list(range(epochs)), f"{name} history {hist}")
    flops = 3 * (flops_fn or seg_forward_flops)(args.base_features, h, w, n_classes) * SEG_BATCH
    rows = []
    for e, hrow in enumerate(hist):
        tr, va = spans.rows["train", e], spans.rows["validate", e]
        check(tr["normalize_u8"] == tr["conv3x3_int8"] == 0,
              f"{name} epoch {e}'s train steps launched {tr} (want no kernel)")
        check(va["normalize_u8"] == n_val and va["conv3x3_int8"] == 0,
              f"{name} validation launched {va} for {n_val} batches (want K1 once per batch)")
        for k in ("total_loss", "ce_loss", "dice_loss", "val_loss"):
            check(np.isfinite(hrow[k]), f"{name} epoch {e} {k} = {hrow[k]}")
        for k in ("train_miou", "val_miou", "val_dice", "val_pixel_accuracy"):
            check(0.0 <= hrow[k] <= 1.0, f"{name} epoch {e} {k} = {hrow[k]} not in [0, 1]")
        step_ms = 1e3 * tr["seconds"] / n_steps
        rows.append({"epoch": e, "train_s": tr["seconds"], "ms_per_step": step_ms,
                     "train_img_per_s": n_steps * SEG_BATCH / tr["seconds"],
                     "peak_mem_gb": tr["peak_mem_gb"],
                     "model_flop_share_bf16_peak": flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS,
                     "decode": "cold" if e == 0 else "cached", "profiled": e == spans.profile_epoch,
                     "val_s": va["seconds"], "val_batches": n_val, **hrow})
        r = rows[-1]
        print(f"[seg] {name} epoch {e} ({r['decode']} decode{', profiled' if r['profiled'] else ''}"
              f"): {r['train_s']:.3f} s, {step_ms:.1f} ms per step, {r['train_img_per_s']:.1f} "
              f"img/s with the loader, peak {r['peak_mem_gb']:.2f} GB, model FLOPs "
              f"{100 * r['model_flop_share_bf16_peak']:.1f}% of the bf16 dense peak; validation "
              f"{r['val_s']:.3f} s ({n_val} batches, K1 {va['normalize_u8']}x); loss "
              f"{r['total_loss']:.4f}, train mIoU {r['train_miou']:.4f}, val loss "
              f"{r['val_loss']:.4f}, val mIoU {r['val_miou']:.4f}", flush=True)
    if loss_must_fall:
        check(rows[-1]["total_loss"] < rows[0]["total_loss"],
              f"{name}: the last epoch's train loss {rows[-1]['total_loss']} is not below "
              f"epoch 0's {rows[0]['total_loss']}")
    if profile_epoch is not None:
        p, pe = spans.profile, profile_epoch
        prof_wall = 1e3 * rows[pe]["train_s"]
        out["idle"] = {"epoch": pe, "device_busy_ms": p["device_busy_ms"],
                       "by_category_ms": p["by_category_ms"],
                       "idle_share_profiled": 1 - p["device_busy_ms"] / prof_wall}
        msg = ""
        if pe + 1 < epochs:  # the next epoch runs unprofiled
            wall = 1e3 * rows[pe + 1]["train_s"]
            out["idle"]["idle_share_vs_next_epoch_wall"] = 1 - p["device_busy_ms"] / wall
            msg = (f"; against epoch {pe + 1}'s unprofiled {wall:.1f} ms: "
                   f"{out['idle']['idle_share_vs_next_epoch_wall']:.4f}")
        print(f"[seg] {name} epoch {pe} profiled: device busy {p['device_busy_ms']:.1f} ms of "
              f"{prof_wall:.1f} ms, idle share {out['idle']['idle_share_profiled']:.4f}{msg}; "
              "by category: " + ", ".join(f"{c} {ms:.1f} ms" for c, ms in
                                          sorted(p["by_category_ms"].items(),
                                                 key=lambda kv: -kv[1])), flush=True)
    for wr in results["checkpoint_writes"]:
        print(f"[seg] {name} checkpoint {os.path.basename(wr['path'])}: {wr['bytes'] / 1e6:.1f} MB, "
              f"async write {wr['seconds']:.3f} s", flush=True)
    ckpt = os.path.join(exp, "checkpoints")
    want_ckpts = {f"checkpoint_epoch_{e}.pth" for e in range(epochs)}
    check(want_ckpts <= set(os.listdir(ckpt)), f"{name} checkpoints {sorted(os.listdir(ckpt))}")
    with open(os.path.join(exp, "results", "training_results.json")) as f:
        tres = json.load(f)
    check(set(tres) == {"train_losses", "val_losses", "best_val_miou", "total_epochs",
                        "total_params", "num_classes", "interrupted", "args"},
          f"{name} training_results.json keys {sorted(tres)}")
    out.update(epochs=rows, checkpoint_writes=results["checkpoint_writes"])
    legs[f"seg_{name}_train"] = spans.total("train")
    legs[f"seg_{name}_validate"] = spans.total("validate")
    torch.cuda.empty_cache()

    # --- the test path on the checkpoint ----------------------------------------
    last = os.path.join(ckpt, checkpoint or f"checkpoint_epoch_{epochs - 1}.pth")
    check(os.path.exists(last), f"{name}: no checkpoint {last}")
    tests, preds = {}, {}
    for mode, flags, k2_per_batch, _, _ in test_modes:
        targs = test_mod.parse_args(common + flags + [
            "--checkpoint", last, "--output_dir", os.path.join(tmp, "test", name, mode)])
        seg.check_eval_flags(targs)
        normalize_u8.launches = conv3x3_int8.launches = 0
        t0 = time.perf_counter()
        loader = seg.make_eval_loader(targs, test_ds, dev)
        quantized = targs.quantize == "int8"
        state, step, loss_cfg = seg.load_seg_model(targs, n_classes, dev,
                                                   train_ds if quantized else None)
        torch.cuda.synchronize()
        t1, calib_k1 = time.perf_counter(), normalize_u8.launches
        keep = _KeepPreds(torch, step)
        losses, cm = validate_seg_epoch(state, keep, loader, n_classes,
                                        ignore_index=loss_cfg.ignore_index)
        t2 = time.perf_counter()
        summary = seg.save_seg_results(targs, losses, cm, class_names)
        t3 = time.perf_counter()
        c = {"normalize_u8": normalize_u8.launches, "conv3x3_int8": conv3x3_int8.launches}
        legs[f"seg_{name}_test_{mode}"] = c
        chunks = -(-min(len(train_ds), targs.calib_samples) // 8) if quantized else 0
        want = {"normalize_u8": n_test + chunks, "conv3x3_int8": k2_per_batch * n_test}
        check(c == want and calib_k1 == chunks,
              f"{name} test {mode} launched {c} (calibration K1 {calib_k1}x), want {want}")
        total = int(np.asarray(summary["confusion_matrix"]).sum())
        check(total == len(test_ds) * h * w,
              f"{name} test {mode}: the confusion matrix counts {total} pixels, want "
              f"{len(test_ds)} x {h} x {w}")
        with open(os.path.join(targs.output_dir, "evaluation_results.json")) as f:
            check(set(json.load(f)) == {"evaluation_args", "overall_metrics",
                                        "per_class_metrics", "confusion_matrix", "loss"},
                  f"{name} test {mode}: evaluation_results.json keys")
        om = summary["overall_metrics"]
        check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in om.values()),
              f"{name} test {mode} metrics not finite in [0, 1]: {om}")
        check(all(np.isfinite(v) for v in losses.values()), f"{name} test {mode} losses {losses}")
        preds[mode] = keep.all(len(test_ds))
        tests[mode] = {"seconds": t3 - t0, "img_per_s": len(test_ds) / (t3 - t0),
                       "load_model_s": t1 - t0, "device_pass_s": t2 - t1,
                       "host_metrics_s": t3 - t2, "launches": c, "overall": om,
                       "loss": losses, "confusion_matrix": summary["confusion_matrix"]}
        print(f"[seg] {name} test {mode}: {t3 - t0:.3f} s, {len(test_ds) / (t3 - t0):.1f} img/s "
              f"(load_model {t1 - t0:.3f} s"
              f"{f' with calibration on {targs.calib_samples} images' if quantized else ''}"
              f", device pass {t2 - t1:.3f} s, host metrics {t3 - t2:.3f} s); K1 "
              f"{c['normalize_u8']}x, K2 {c['conv3x3_int8']}x for {n_test} batches; mIoU "
              f"{om['mean_iou']:.4f}, mean Dice {om['mean_dice']:.4f}, pixel accuracy "
              f"{om['pixel_accuracy']:.4f}, loss {losses['total_loss']:.4f}", flush=True)
        del state, step, keep
        torch.cuda.empty_cache()
    for mode, _, _, ref, limit in test_modes:
        if ref is None or ref not in preds:
            continue
        differ = int((preds[mode] != preds[ref]).sum())
        share = differ / preds[ref].numel()
        tests[mode][f"pixel_agreement_vs_{ref}"] = 1 - share
        print(f"[seg] {name} test {mode} against {ref}: {differ} of "
              f"{preds[ref].numel()} pixels differ ({share:.3g}, limit {limit})", flush=True)
        check(share <= limit, f"{name} {mode} predictions differ from {ref}'s "
                              f"on {share:.3g} of pixels")
    out["test"] = tests
    report_out[name] = out
    return exp, common, (train_ds, val_ds, test_ds, n_classes, workload)


def _seg_resume(torch, np, out, legs, exp, train_mod, common, data, tmp):
    """``--resume checkpoint_epoch_0.pth --epochs 2``: the epoch and the
    Adam step continue, and epoch 1 repeats the first run's (the seg
    trainer has no LR schedule, and the draws and order are the same)."""
    from tpu_unet_torch.cli import _seg_common as seg
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8

    train_ds, val_ds, _, n_classes, workload = data
    n_steps, n_val = len(train_ds) // SEG_BATCH, -(-len(val_ds) // SEG_BATCH)
    ck0 = os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth")
    rargs = train_mod.parse_args(common + ["--epochs", "2", "--val_freq", "1", "--save_freq",
                                           "1", "--save_dir", os.path.join(tmp, "runs"),
                                           "--resume", ck0])
    rexp = os.path.join(tmp, "runs", "kolektorsdd_resume")
    spans = _Spans(torch, (normalize_u8, conv3x3_int8))
    seg.train_seg(rargs, workload, train_ds, val_ds, n_classes, torch.device("cuda"), rexp,
                  span=spans)
    with open(os.path.join(rexp, "results", "history.jsonl")) as f:
        rhist = [json.loads(line) for line in f]
    steps = (_adam_step(torch, ck0),
             _adam_step(torch, os.path.join(rexp, "checkpoints", "checkpoint_epoch_1.pth")))
    check([h["epoch"] for h in rhist] == [1], f"resumed history {rhist}")
    check(steps == (n_steps, 2 * n_steps),
          f"Adam step {steps[0]} -> {steps[1]} (want {n_steps} -> {2 * n_steps})")
    check(spans.total("train") == {"normalize_u8": 0, "conv3x3_int8": 0}
          and spans.total("validate") == {"normalize_u8": n_val, "conv3x3_int8": 0},
          f"resume launched {spans.rows}")
    first = out["kolektorsdd"]["epochs"][1]["total_loss"]
    rel = abs(rhist[0]["total_loss"] - first) / first
    tr = spans.rows["train", 1]
    legs["seg_kolektorsdd_resume"] = {k: spans.total("train")[k] + spans.total("validate")[k]
                                      for k in ("normalize_u8", "conv3x3_int8")}
    print(f"[seg] kolektorsdd --resume checkpoint_epoch_0.pth --epochs 2: epochs "
          f"{[h['epoch'] for h in rhist]}, Adam step {steps[0]} -> {steps[1]}; its epoch 1 "
          f"{tr['seconds']:.3f} s, {n_steps * SEG_BATCH / tr['seconds']:.1f} img/s; loss "
          f"{rhist[0]['total_loss']:.5f} against the first run's {first:.5f} (rel diff "
          f"{rel:.2e})", flush=True)
    out["kolektorsdd"]["resume"] = {"history": rhist, "adam_step": list(steps),
                                    "epoch1_loss_rel_diff": rel,
                                    "epoch1_train_s": tr["seconds"]}


def _seg_cpu_vs_card(torch, np, data_root, tmp):
    """KolektorSDD at base 8, 64 x 32: one f32 epoch of ``train_seg`` on the
    card, then its checkpoint's test path on the CPU and on the card in f32
    (the predictions equal except at near-ties of the top two logits), and
    in int8 on the card against the same int8 forward with K1's and K2's
    plain versions on the card (bit for bit; base 8 has Cout 8 layers, which
    K2's wrapper pads to 16)."""
    from tpu_unet_torch.cli import _seg_common as seg
    from tpu_unet_torch.cli import test_kolektorsdd, train_kolektorsdd
    from tpu_unet_torch.ops import quantize as tq
    from tpu_unet_torch.ops.augment import eval_transform
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8, normalize_u8_plain
    from tpu_unet_torch.ops.seg_head import sliced_argmax
    from tpu_unet_torch.train.loop import validate_seg_epoch

    small = ["--data_root", data_root, "--image_height", "64", "--image_width", "32",
             "--base_features", "8", "--batch_size", str(SEG_BATCH), "--num_workers", "4",
             "--precision", "f32"]
    args = train_kolektorsdd.parse_args(small + ["--epochs", "1", "--device", "cuda",
                                                 "--save_dir", os.path.join(tmp, "small")])
    workload = train_kolektorsdd.make_workload()
    train_ds, val_ds, test_ds, n_classes, _ = workload.make_datasets(args)
    exp = os.path.join(tmp, "small", "ksdd_base8")
    seg.train_seg(args, workload, train_ds, val_ds, n_classes, torch.device("cuda"), exp)
    path = os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth")
    n = len(test_ds)
    images = torch.from_numpy(np.stack([test_ds.load(i)["image"] for i in range(n)]))

    def test_path(device, extra=()):
        targs = test_kolektorsdd.parse_args(small + ["--checkpoint", path, "--device", device,
                                                     "--output_dir", os.path.join(tmp, "o"),
                                                     *extra])
        dev = torch.device(device)
        state, step, _ = seg.load_seg_model(targs, n_classes, dev, train_ds)
        keep = _KeepPreds(torch, step)
        losses, cm = validate_seg_epoch(state, keep, seg.make_eval_loader(targs, test_ds, dev),
                                        n_classes)
        return state, step, keep.all(n).cpu(), losses, cm.confusion_matrix

    cpu_state, _, p_cpu, l_cpu, cm_cpu = test_path("cpu")
    _, _, p_card, l_card, cm_card = test_path("cuda")
    differ = p_cpu != p_card
    n_diff, max_gap = int(differ.sum()), 0.0
    if n_diff:  # each differing pixel must be a near-tie of the CPU's logits
        with torch.no_grad():
            cpu_state.model.eval()
            logits = cpu_state.model(eval_transform(images).permute(0, 3, 1, 2))
        top2 = logits.permute(0, 2, 3, 1).topk(2, dim=-1).values
        max_gap = float((top2[..., 0] - top2[..., 1])[differ].max())
    loss_rel = max(abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu)
    print(f"[seg-cpu] base 8, 64x32, f32: the test path's predictions differ in {n_diff} of "
          f"{differ.numel()} pixels (largest top-two logit gap there {max_gap:.3g}, limit "
          f"{SEG_TIE_GAP}); confusion matrices {'equal' if (cm_cpu == cm_card).all() else 'differ'}"
          f"; losses max rel diff {loss_rel:.3g}", flush=True)
    check(max_gap < SEG_TIE_GAP, f"CPU and card predictions differ away from ties ({max_gap})")
    check(n_diff or (cm_cpu == cm_card).all(), "CPU and card confusion matrices differ")
    check(loss_rel <= 1e-5, f"CPU and card test losses differ by {loss_rel:.3g} (rel)")

    # int8 at base 8 on the card, against the plain K1/K2 forward on the card
    _, step, p_int8, _, cm_int8 = test_path("cuda", ("--quantize", "int8"))


    plan = tq.build_plan("seg_unet")
    with torch.no_grad():
        x = images.cuda()
        card = tq._run(tq._QuantExec(step.qparams), normalize_u8(x), plan)
        plain = tq._run(plain_k2_exec(step.qparams), normalize_u8_plain(x), plan)
    same_logits = torch.equal(card.view(torch.int32), plain.view(torch.int32))
    same_preds = torch.equal(p_int8, sliced_argmax(plain).to(torch.uint8).cpu())
    print(f"[seg-cpu] base 8, 64x32, int8 (Cout 8 layers padded to 16 for K2): the test path's "
          f"predictions {'equal' if same_preds else 'DIFFER FROM'} those of the same forward "
          f"with plain K1/K2 on the card; logits bit for bit "
          f"{'equal' if same_logits else 'DIFFER'}", flush=True)
    check(same_logits and same_preds, "int8 base 8 on the card differs from the plain forward")
    return {"f32_pixels_differ": n_diff, "f32_max_tie_gap": max_gap,
            "f32_loss_max_rel": loss_rel, "f32_cm_equal": bool((cm_cpu == cm_card).all()),
            "int8_base8_equal_plain": True}


def phase_seg(torch, np, report, tmp, keep=None):
    """Phase 9: the segmentation path at full width through the seg CLIs'
    own functions (``_seg_common.train_seg``; ``make_eval_loader``,
    ``load_seg_model``, ``train/loop.py::validate_seg_epoch`` and
    ``save_seg_results``, which is ``run_seg_evaluation`` without its plots)
    with flags from the CLIs' parsers, on synthetic KolektorSDD and Gear
    trees written under ``tmp`` (``ksdd``, ``gear``) and read by the port's
    datasets. Returns the launch counts of each leg."""
    from tpu_unet_torch.cli import (test_gear, test_kolektorsdd, train_gear,
                                    train_kolektorsdd)

    print("[seg] through the CLIs' functions: _seg_common.train_seg; make_eval_loader, "
          "load_seg_model, validate_seg_epoch, save_seg_results (the test CLIs' plots are "
          "skipped: matplotlib is not installed on this machine)", flush=True)
    legs, out = {}, {}
    t0 = time.perf_counter()
    ksdd_root, gear_root = os.path.join(tmp, "ksdd"), os.path.join(tmp, "gear")
    n_ksdd = write_kolektorsdd(np, ksdd_root)
    n_gear = write_gear(np, gear_root)
    out["synth_s"] = time.perf_counter() - t0
    print(f"[seg] synthetic KolektorSDD: {KSDD_PARTS} parts of {KSDD_HW[1]}x{KSDD_HW[0]} in "
          f"{KSDD_FOLDERS} folders, {KSDD_DEFECTIVE} defective ({n_ksdd / 1e6:.0f} MB); "
          f"synthetic Gear: {sum(GEAR_SPLITS.values())} JPGs of {GEAR_SIZE}² "
          f"({n_gear / 1e6:.0f} MB); written in {out['synth_s']:.1f} s", flush=True)

    modes = seg_test_modes(18)
    exp, common, data = _seg_dataset(
        torch, np, out, legs, "kolektorsdd", train_kolektorsdd, test_kolektorsdd,
        ksdd_root, tmp, epochs=KSDD_EPOCHS, test_modes=modes, profile_epoch=1,
        loss_must_fall=True)
    _seg_resume(torch, np, out, legs, exp, train_kolektorsdd, common, data, tmp)
    shutil.rmtree(os.path.join(tmp, "runs"))
    out["kolektorsdd"]["cpu_vs_card"] = _seg_cpu_vs_card(torch, np, ksdd_root, tmp)

    exp, _, _ = _seg_dataset(torch, np, out, legs, "gear", train_gear, test_gear, gear_root,
                             tmp, epochs=1, test_modes=(modes[0], modes[2]))
    if keep:  # for phase 12's visualize_seg
        shutil.copy(os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth"),
                    os.path.join(keep, "gear_seg.pth"))
    report["main_path"]["seg"] = out
    return legs


# Phase 10's limits on the share of test pixels whose class differs from f32
# --fold_bn's, set from a first H100 run of the phase, at about 5x what it
# measured (UNet++ at heads 4: bf16 9.1e-6, int8 4.6e-5; the attention UNet:
# 2.2e-7, 3.9e-6); for UNet++'s pruned head X[0][1] (bf16 9.8e-4, int8
# 5.2e-3) the limits set before that run. The attention UNet's run after
# its gate's stride-2 projection became a sampled 1x1 conv (other cuDNN
# kernels, another trained model) measured 7.0e-7 and 1.69e-5.
EXT_MAX_DISAGREE = {"gear_unetpp": {"bf16": 5e-5, "int8": 2.5e-4},
                    "gear_unetpp_heads1": {"bf16": 5e-3, "int8": 1e-2},
                    "kolektorsdd_attn": {"bf16": 2e-6, "int8": 2e-5}}


def unetpp_forward_flops(base, h, w, n_classes, n_channels=3):
    """Model FLOPs of one UNet++ forward with deep supervision (every node,
    the four heads) on one h x w image: the 3x3 convs, the k2s2 level-ups
    and the heads."""
    convs = unetpp_convs(base, h, w)
    total = sum(2 * 9 * hh * ww * cin * cout for hh, ww, cin, cout in convs)
    total += 2 * 9 * h * w * (n_channels - 3) * base  # the first conv's other inputs
    for j in range(1, 5):
        for i in range(5 - j):
            c = base * 2 ** i
            total += 2 * (2 * c) * c * (h >> i) * (w >> i)
    return total + 4 * 2 * base * n_classes * h * w


def attn_forward_flops(base, h, w, n_classes, n_channels=3):
    """Model FLOPs of one attention UNet forward: SegmentationUNet's and the
    four gates' 1x1 projections at the coarse resolution."""
    total = seg_forward_flops(base, h, w, n_classes, n_channels)
    for level in range(1, 5):  # up4..up1 gate at levels 1..4 (coarse = level)
        cg, cx = base * 2 ** level, base * 2 ** (level - 1)
        f_int = max(1, cx // 2)
        total += 2 * (cg + cx + 1) * f_int * (h >> level) * (w >> level)
    return total


def _ext_bilinear_serving(torch, np, out, legs):
    """(c) AnomalyScorer(bilinear=True) at serving's default (base 64, 256²,
    b128) in bf16 and int8 against f32: K1 once and K2 18 times per int8
    batch, the int8 scores bit for bit against the plain K1/K2 forward."""
    from tpu_unet_torch.metrics.anomaly import anomaly_score
    from tpu_unet_torch.ops import quantize as tq
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8, normalize_u8_plain
    from tpu_unet_torch.serve import AnomalyScorer

    t0 = time.perf_counter()
    state_dict = warm_anomaly_state_dict(torch, bilinear=True)
    check(not any(k.endswith(".up.weight") for k in state_dict), "bilinear model has up convs")
    kw = dict(image_size=256, batch_size=128, device="cuda", bilinear=True)
    bf16 = AnomalyScorer.from_state_dict(state_dict, precision="bf16", **kw)
    f32 = AnomalyScorer.from_state_dict(state_dict, precision="f32", **kw)
    int8 = AnomalyScorer.from_state_dict(state_dict, quantize="int8",
                                         calib_images=synth_images(torch, 32, 256, 21, "cuda"),
                                         **kw)
    images = synth_images(torch, 384, 256, 31, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the bilinear serving path: counters zeroed just before, read just after
    normalize_u8.launches = conv3x3_int8.launches = 0
    s_bf16 = bf16.score_array(images)
    legs["serve_bilinear_bf16"] = {"normalize_u8": normalize_u8.launches,
                                   "conv3x3_int8": conv3x3_int8.launches}
    normalize_u8.launches = conv3x3_int8.launches = 0
    s_int8 = int8.score_array(images)
    legs["serve_bilinear_int8"] = {"normalize_u8": normalize_u8.launches,
                                   "conv3x3_int8": conv3x3_int8.launches}
    # ---------------------------------------------------------------------------
    check(legs["serve_bilinear_bf16"] == {"normalize_u8": 3, "conv3x3_int8": 0}
          and legs["serve_bilinear_int8"] == {"normalize_u8": 3, "conv3x3_int8": 54},
          f"bilinear serving launched {legs} (want K1 3 and 3, K2 0 and 54)")


    batch = torch.from_numpy(images[:128]).cuda()
    with torch.inference_mode():
        img = normalize_u8_plain(batch)
        recon = tq._run(plain_k2_exec(int8.qparams), img,
                        tq.build_plan("anomaly_unet", score_only=True))
        s_plain = anomaly_score(recon, img).cpu().numpy()
    del img, recon
    n_diff = int((s_plain != s_int8[:128]).sum())
    check(n_diff == 0, f"bilinear int8 scores differ from the plain K1/K2 forward ({n_diff})")
    s_f32 = f32.score_array(images)
    del f32
    for name, sc in (("bf16", s_bf16), ("int8", s_int8), ("f32", s_f32)):
        check(sc.shape == (384,) and np.isfinite(sc).all(), f"bilinear {name} scores")
    r = {"setup_s": setup_s, "launches": {k: legs[k] for k in legs if k.startswith("serve")},
         "int8_equal_plain_b128": True}
    for name, sc in (("int8", s_int8), ("bf16", s_bf16)):
        r[f"corr_{name}_f32"] = float(np.corrcoef(sc, s_f32)[0, 1])
        r[f"median_rel_{name}_f32"] = float(np.median(np.abs(sc - s_f32) / np.abs(s_f32)))
    r["throughput_img_per_s"] = {"bf16": bf16.throughput(n_batches=10),
                                 "int8": int8.throughput(n_batches=10)}
    print(f"[ext] bilinear AnomalyUNet 256² b128 serving: bf16 "
          f"{r['throughput_img_per_s']['bf16']:.1f} img/s, int8 "
          f"{r['throughput_img_per_s']['int8']:.1f} img/s; K1 3x and 3x, K2 0x and 54x for 3 "
          f"batches; int8 scores bit for bit those of the plain K1/K2 forward; int8 vs f32 corr "
          f"{r['corr_int8_f32']:.6f}, median rel diff {r['median_rel_int8_f32']:.2e}; bf16 vs "
          f"f32 corr {r['corr_bf16_f32']:.6f}, median rel diff {r['median_rel_bf16_f32']:.2e} "
          f"(set-up {setup_s:.1f} s)", flush=True)
    # The main path's limits (about 5x its measured medians).
    check(r["corr_int8_f32"] > 0.9999 and r["median_rel_int8_f32"] < 1.5e-3,
          "bilinear int8 scores do not track f32 scores")
    check(r["corr_bf16_f32"] > 0.9999 and r["median_rel_bf16_f32"] < 1e-3,
          "bilinear bf16 scores do not track f32 scores")
    out["bilinear_serving"] = r
    del bf16, int8
    torch.cuda.empty_cache()


def _update_err(sd, ref, before):
    """The relative L2 error of one step's parameter update against a
    reference step's, over every parameter (BN statistics left out)."""
    num = den = 0.0
    for k, v0 in before.items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        want = ref[k].cpu().double() - v0
        num += float(((sd[k].cpu().double() - v0 - want) ** 2).sum())
        den += float((want ** 2).sum())
    return (num / den) ** 0.5


def _ext_cpu_vs_card(torch, np):
    """(d) Base 8 in f32: one seg train step of UNet++ with deep supervision
    and of the attention UNet on the CPU and on the card from the same
    weights and draws: the losses and BN statistics within phase 7's
    tolerances. Their parameters are held against the same step in float64
    on the CPU: these models' small BN gradients (UNet++'s deep nodes, the
    gates' 1-channel bn2) make float32 round-off reach 1% of some leaves'
    updates on either device, far beyond phase 7's per-leaf tolerance, so
    the card's update must be as close to the float64 one as the CPU's
    float32 update is (relative L2 error at most 3x the CPU's). Then the
    int8 forwards of UNet++ (heads 4 and 1), the attention UNet and a
    bilinear AnomalyUNet on the card, bit for bit against the same forwards
    with K1's and K2's plain versions on the card."""
    from tpu_unet_torch.core.precision import Policy
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.ops import quantize as tq
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8, normalize_u8_plain
    from tpu_unet_torch.train.state import create_train_state
    from tpu_unet_torch.train.steps import AugmentConfig, SegLossConfig, make_seg_train_step

    rng = np.random.default_rng(12)
    b, size, base, c = 4, 64, 8, 3
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    labels = np.zeros((b, size, size), np.uint8)
    for i in range(b):
        for k in (1, 2):
            y, x = rng.integers(0, size - 20, 2)
            labels[i, y:y + 20, x:x + 20] = k
    step = make_seg_train_step(c, SegLossConfig(class_weights=(1.0, 50.0, 50.0)),
                               AugmentConfig(degrees=5.0))
    f64 = Policy(param_dtype=torch.float64, compute_dtype=torch.float64,
                 norm_dtype=torch.float64, output_dtype=torch.float64)
    res, trained = {}, {}
    for name, kw in (("unetpp", {"deep_supervision": True}), ("attn_unet", {})):
        torch.manual_seed(4)
        models = [build_model(name, n_classes=c, base_features=base, **kw) for _ in range(2)]
        models.append(build_model(name, n_classes=c, base_features=base, policy=f64, **kw))
        before = {k: v.double() for k, v in models[0].state_dict().items()}
        for m in models[1:]:
            m.load_state_dict(models[0].state_dict())
        states = [create_train_state(models[0], "sgd", 0.05, 1e-4, device="cpu"),
                  create_train_state(models[1], "sgd", 0.05, 1e-4, device="cuda"),
                  create_train_state(models[2].double(), "sgd", 0.05, 1e-4, device="cpu")]
        draws, keeps = step.draws(states[0].model, b, torch.Generator().manual_seed(6))
        l_cpu, l_gpu, _ = [step.with_draws(st, images, labels, draws, keeps)[0] for st in states]
        loss_rel = max(abs(float(l_gpu[k]) - float(l_cpu[k])) / abs(float(l_cpu[k]))
                       for k in l_cpu)
        sd_cpu, sd_gpu, sd_64 = [st.model.state_dict() for st in states]
        param_err, stat_err = _state_dict_errs(sd_cpu, sd_gpu)
        err_cpu, err_gpu = _update_err(sd_cpu, sd_64, before), _update_err(sd_gpu, sd_64, before)
        print(f"[ext-cpu] {name} base {base}, {size}², b{b}, f32, SGD, one seg step, same "
              f"weights and draws: losses max rel diff {loss_rel:.3g}; BN running stats "
              f"{stat_err:.3g}; parameters max |diff| / leaf max {param_err:.3g}; the update "
              f"against the float64 step's: card {err_gpu:.3g}, CPU {err_cpu:.3g} (rel L2)",
              flush=True)
        check(loss_rel <= 1e-5, f"{name}: CPU and card losses differ by {loss_rel:.3g} (rel)")
        check(stat_err <= TRAIN_STAT_TOL, f"{name}: CPU and card BN statistics differ by "
                                          f"{stat_err:.3g}")
        check(err_gpu <= 3 * err_cpu, f"{name}: the card's update is {err_gpu:.3g} from the "
                                      f"float64 step's, the CPU's {err_cpu:.3g}")
        res[f"{name}_train_step"] = {"loss_max_rel": loss_rel, "param_max_rel_to_leaf": param_err,
                                     "bn_stat_max_rel_to_leaf": stat_err,
                                     "update_rel_l2_vs_f64_card": err_gpu,
                                     "update_rel_l2_vs_f64_cpu": err_cpu}
        trained[name] = sd_cpu


    torch.manual_seed(5)
    trained["anomaly_unet"] = build_model("anomaly_unet", base_features=base,
                                          bilinear=True).state_dict()
    calib = [rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)]
    x = torch.from_numpy(images).cuda()
    for arch, ds, heads in (("unetpp", True, 4), ("unetpp", True, 1), ("attn_unet", False, 4),
                            ("anomaly_unet", False, 4)):
        qp = tq.quantize_from_train_state(arch, trained[arch], calib, device="cuda",
                                          deep_supervision=ds)
        plan = tq.build_plan(arch, deep_supervision=ds, heads=heads)
        with torch.no_grad():
            card = tq._run(tq._QuantExec(qp), normalize_u8(x), plan)
            plain = tq._run(plain_k2_exec(qp), normalize_u8_plain(x), plan)
        card, plain = (card, plain) if isinstance(card, tuple) else ((card,), (plain,))
        same = all(torch.equal(a.view(torch.int32), p.view(torch.int32))
                   for a, p in zip(card, plain))
        tag = f"{arch}{' heads ' + str(heads) if arch == 'unetpp' else ''}"
        tag += " (bilinear)" if arch == "anomaly_unet" else ""
        print(f"[ext-cpu] int8 {tag} base {base}, {size}², b{b} on the card: outputs "
              f"{'equal' if same else 'DIFFER FROM'} those of the plain K1/K2 forward, bit for "
              f"bit", flush=True)
        check(same, f"int8 {tag} on the card differs from the plain K1/K2 forward")
        res[f"int8_{arch}_heads{heads}_equal_plain"] = True
    return res


def phase_extensions(torch, np, report, tmp, keep=None):
    """Phase 10: the model extensions at full width. (a) UNet++ with deep
    supervision on phase 9's synthetic Gear tree through the seg CLIs'
    functions (train_gear's defaults: base 64, bf16, 512², b8, Adam 1e-3):
    2 epochs (epoch 0 decodes cold, epoch 1 cached; not profiled since PR
    12, whose phase 15 took the time of the profile and a third epoch), then
    the test path on best_model.pth in bf16, f32 --fold_bn and int8, at
    --heads 4 and --heads 1 (K2 30 and 6 times per int8 batch). (b) The
    attention UNet on the synthetic KolektorSDD tree at its defaults
    (1024 x 512, b8), one epoch (cold decode, not profiled: phase 14 took
    the time of its profiled and cached epochs), tested in bf16, f32
    --fold_bn and int8 (K2 18 times per batch, the gates in float). (c) Bilinear AnomalyUNet
    serving. (d) The CPU against the card. Returns the launch counts of each
    leg."""
    from tpu_unet_torch.cli import test_gear, test_kolektorsdd, train_gear, train_kolektorsdd

    shutil.rmtree(os.path.join(tmp, "runs"), ignore_errors=True)
    legs, out = {}, {}
    unetpp_modes = (seg_test_modes(30, limits=EXT_MAX_DISAGREE["gear_unetpp"])
                    + seg_test_modes(6, extra=["--heads", "1"], suffix="_heads1",
                                     limits=EXT_MAX_DISAGREE["gear_unetpp_heads1"]))
    exp, _, _ = _seg_dataset(torch, np, out, legs, "gear_unetpp", train_gear, test_gear,
                             os.path.join(tmp, "gear"), tmp, epochs=2, test_modes=unetpp_modes,
                             model_flags=["--model", "unetpp", "--deep_supervision"],
                             flops_fn=unetpp_forward_flops,
                             checkpoint="best_model.pth")
    if keep:  # for phase 12's visualize_seg
        shutil.copy(os.path.join(exp, "checkpoints", "best_model.pth"),
                    os.path.join(keep, "gear_unetpp.pth"))
    shutil.rmtree(os.path.join(tmp, "runs"))
    _seg_dataset(torch, np, out, legs, "kolektorsdd_attn", train_kolektorsdd, test_kolektorsdd,
                 os.path.join(tmp, "ksdd"), tmp, epochs=1,
                 test_modes=seg_test_modes(18, limits=EXT_MAX_DISAGREE["kolektorsdd_attn"]),
                 model_flags=["--model", "attn_unet"], flops_fn=attn_forward_flops)
    shutil.rmtree(os.path.join(tmp, "runs"))
    _ext_bilinear_serving(torch, np, out, legs)
    out["cpu_vs_card"] = _ext_cpu_vs_card(torch, np)
    report["main_path"]["extensions"] = out
    return legs


# Phase 11: the serving surface. serve_seg's defaults (SegmentationUNet base 64,
# 4 classes, 512², b16) and KolektorSDD's (1024 x 512, b8, 3 classes); the
# tiled extent is chosen (Gear's native size is not in the repo): 1024² images
# in 512² tiles overlapping by 64 px, a 3 x 3 grid.
SERVE_HW, SERVE_BATCH = (512, 512), 16
KSDD_SERVE_HW, KSDD_SERVE_BATCH = (1024, 512), 8
TILED_HW, TILED_BATCH, TILE_OVERLAP = (1024, 1024), 2, 64
DAEMON_REQUESTS, DAEMON_CLIENTS = 64, 16
# Shares of served pixels whose class differs from the f32 --fold_bn engine's,
# about 5x what an H100 run measured (bf16 9.2e-3 and 7.2e-3, int8 5.8e-2 and
# 4.2e-2 at 512² and 1024 x 512). The weights are seeded, not trained, so the
# class logits sit close together and a rounding flips many argmaxes; the int8
# forwards are held bit for bit against the plain K1/K2 forward besides.
SERVE_MAX_DISAGREE = {"seg_bf16": 0.05, "seg_int8": 0.3, "ksdd_bf16": 0.04,
                      "ksdd_int8": 0.2}


def synth_hw(torch, n, hw, seed):
    """synth_images' textures cut to (h, w)."""
    return synth_images(torch, n, max(hw), seed, "cuda")[:, :hw[0], :hw[1]].copy()


def warm_seg_state_dict(torch, name, n_classes, hw, seed=0, **kw):
    """A full-width seg model (base 64) from ``seed`` with BN statistics
    warmed on synthetic ``hw`` images (the cumulative mean of 3 batches of
    4); its state_dict on the CPU."""
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8

    torch.manual_seed(seed)
    model = build_model(name, n_classes=n_classes, base_features=64, dropout=0.0, **kw).to(
        "cuda", memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    model.train()
    with torch.no_grad():
        for i in range(3):
            imgs = torch.from_numpy(synth_hw(torch, 4, hw, 50 + seed + i)).cuda()
            model(normalize_u8(imgs).permute(0, 3, 1, 2))
    return {k: v.cpu() for k, v in model.state_dict().items()}


def _launches():
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8
    return {"normalize_u8": normalize_u8.launches, "conv3x3_int8": conv3x3_int8.launches}


def _zero_launches():
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8
    normalize_u8.launches = conv3x3_int8.launches = 0


def _serve_leg(np, legs, name, engine, images, k2_per_batch):
    """``engine.predict_array(images)`` with the launch counters zeroed just
    before and read just after: K1 once and K2 ``k2_per_batch`` times per
    batch; masks of the image shape with valid classes, finite confidences."""
    _zero_launches()
    masks, confs = engine.predict_array(images)
    legs[name] = _launches()
    n_batches = -(-len(images) // engine.batch_size)
    want = {"normalize_u8": n_batches, "conv3x3_int8": k2_per_batch * n_batches}
    check(legs[name] == want, f"{name} launched {legs[name]} (want {want})")
    check(masks.shape == (len(images), *engine.image_size_hw) and masks.dtype == np.uint8
          and int(masks.max()) < engine.num_classes and np.isfinite(confs).all()
          and confs.shape == (len(images),), f"{name}: bad outputs")
    return masks, confs


def _plain_predict(torch, qparams, plan, images_u8, tiling=None):
    """The int8 predictor's function with K1's and K2's plain versions on the
    card: (masks, mean confidences); ``tiling`` (image_hw, tile_hw, overlap)."""
    from tpu_unet_torch.ops import quantize as tq
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8_plain
    from tpu_unet_torch.ops.seg_head import sliced_pred_confidence
    from tpu_unet_torch.ops.tiling import make_tiled_logits_fn

    exc = plain_k2_exec(qparams)

    def apply(x):
        return tq._run(exc, normalize_u8_plain(x), plan)

    fn = apply if tiling is None else make_tiled_logits_fn(apply, *tiling)
    with torch.inference_mode():
        preds, conf = sliced_pred_confidence(fn(torch.from_numpy(images_u8).cuda()))
        return preds.cpu().numpy(), conf.mean(dim=(1, 2)).cpu().numpy()


def _check_plain(torch, np, name, engine, plan, images, got, tiling=None):
    masks, confs = _plain_predict(torch, engine.qparams, plan, images, tiling)
    n = len(images)
    check(np.array_equal(masks, got[0][:n]) and np.array_equal(confs, got[1][:n]),
          f"{name}: masks or confidences differ from the plain K1/K2 forward")


def _serve_models(torch, np, out, legs):
    """(a) SegmentationUNet at serve_seg's defaults and at KolektorSDD's, in
    f32 --fold_bn, bf16 and int8; (b) UNet++ at --heads 1 and the attention
    UNet in int8; (c) tiling. Returns the 512² engines and state_dict."""
    from tpu_unet_torch.ops.quantize import build_plan
    from tpu_unet_torch.serve import SegmentationPredictor

    r = out.setdefault("predictor", {})
    keep = {}
    for ds, hw, batch, classes in (("seg", SERVE_HW, SERVE_BATCH, 4),
                                   ("ksdd", KSDD_SERVE_HW, KSDD_SERVE_BATCH, 3)):
        t0 = time.perf_counter()
        sd = warm_seg_state_dict(torch, "seg_unet", classes, hw)
        kw = dict(num_classes=classes, image_size_hw=hw, batch_size=batch, device="cuda")
        engines = {
            "f32": SegmentationPredictor.from_state_dict(sd, precision="f32", **kw),
            "bf16": SegmentationPredictor.from_state_dict(sd, precision="bf16", **kw),
            "int8": SegmentationPredictor.from_state_dict(
                sd, quantize="int8", calib_images=synth_hw(torch, 16, hw, 60), **kw)}
        images = synth_hw(torch, 2 * batch, hw, 61)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        res = {m: _serve_leg(np, legs, f"serve_{ds}_{m}", e, images, 18 if m == "int8" else 0)
               for m, e in engines.items()}
        _check_plain(torch, np, f"serve_{ds}_int8", engines["int8"], build_plan("seg_unet"),
                     images[:batch], res["int8"])
        leg = r[ds] = {"setup_s": setup_s, "int8_equal_plain": True}
        for m in ("bf16", "int8"):
            leg[f"disagree_{m}_f32"] = float((res[m][0] != res["f32"][0]).mean())
        for m, e in engines.items():
            b1 = SegmentationPredictor.from_state_dict(
                sd, **{**kw, "batch_size": 1},
                **({"quantize": "int8", "qparams": e.qparams} if m == "int8"
                   else {"precision": m}))
            leg[m] = {"img_per_s": e.throughput(n_batches=10),
                      "latency_b1_ms": b1.latency_ms(n_iters=20)}
            del b1
        print(f"[serve] SegmentationUNet {hw[0]}x{hw[1]} b{batch}, {classes} classes: "
              + "; ".join(f"{m} {leg[m]['img_per_s']:.1f} img/s, b1 p50 "
                          f"{leg[m]['latency_b1_ms']['p50_ms']} ms p95 "
                          f"{leg[m]['latency_b1_ms']['p95_ms']} ms" for m in engines)
              + f"; K1 2 and K2 0/0/36 for 2 batches; int8 bit for bit the plain K1/K2 "
              f"forward; pixels differing from f32: bf16 {leg['disagree_bf16_f32']:.3g}, int8 "
              f"{leg['disagree_int8_f32']:.3g} (set-up {setup_s:.1f} s)", flush=True)
        for m in ("bf16", "int8"):
            share = leg[f"disagree_{m}_f32"]
            check(share <= SERVE_MAX_DISAGREE[f"{ds}_{m}"],
                  f"serve_{ds} {m} masks differ from f32's on {share:.3g} of the pixels")
        if ds == "seg":
            keep = {"sd": sd, "engines": engines, "images": images}
        else:
            del engines
    torch.cuda.empty_cache()

    # (b) UNet++ with deep supervision at --heads 1, and the attention UNet, in int8.
    for name, model_kw, pred_kw, k2 in (
            ("unetpp_heads1", {"deep_supervision": True},
             {"model_name": "unetpp", "deep_supervision": True, "heads": 1}, 6),
            ("attn", {}, {"model_name": "attn_unet"}, 18)):
        arch = pred_kw["model_name"]
        sd = warm_seg_state_dict(torch, arch, 4, SERVE_HW, seed=1, **model_kw)
        e = SegmentationPredictor.from_state_dict(
            sd, quantize="int8", calib_images=synth_hw(torch, 16, SERVE_HW, 62),
            num_classes=4, image_size_hw=SERVE_HW, batch_size=SERVE_BATCH, device="cuda",
            **pred_kw)
        images = synth_hw(torch, 2 * SERVE_BATCH, SERVE_HW, 63)
        got = _serve_leg(np, legs, f"serve_{name}_int8", e, images, k2)
        plan = build_plan(arch, deep_supervision=pred_kw.get("deep_supervision", False),
                          heads=pred_kw.get("heads", 4))
        _check_plain(torch, np, f"serve_{name}_int8", e, plan, images[:SERVE_BATCH], got)
        r[name] = {"int8_img_per_s": e.throughput(n_batches=10), "int8_equal_plain": True}
        print(f"[serve] {arch} {pred_kw} int8 512² b16: {r[name]['int8_img_per_s']:.1f} img/s; "
              f"K1 2 and K2 {2 * k2} for 2 batches; bit for bit the plain K1/K2 forward",
              flush=True)
        del e
    torch.cuda.empty_cache()

    # (c) The 512² model over 1024² images: 9 tiles per image, 18 per batch of 2.
    sd, engines = keep["sd"], keep["engines"]
    tkw = dict(num_classes=4, image_size_hw=TILED_HW, batch_size=TILED_BATCH, device="cuda",
               tile_hw=SERVE_HW, tile_overlap=TILE_OVERLAP)
    tiled = {"bf16": SegmentationPredictor.from_state_dict(sd, precision="bf16", **tkw),
             "int8": SegmentationPredictor.from_state_dict(
                 sd, quantize="int8", qparams=engines["int8"].qparams, **tkw)}
    images = synth_hw(torch, 2 * TILED_BATCH, TILED_HW, 64)
    res = {m: _serve_leg(np, legs, f"serve_tiled_{m}", e, images, 18 if m == "int8" else 0)
           for m, e in tiled.items()}
    _check_plain(torch, np, "serve_tiled_int8", tiled["int8"], build_plan("seg_unet"),
                 images[:TILED_BATCH], res["int8"], (TILED_HW, SERVE_HW, TILE_OVERLAP))
    one = {m: SegmentationPredictor.from_state_dict(
        sd, num_classes=4, image_size_hw=SERVE_HW, batch_size=SERVE_BATCH, device="cuda",
        tile_hw=SERVE_HW, tile_overlap=TILE_OVERLAP,
        **({"quantize": "int8", "qparams": engines["int8"].qparams} if m == "int8"
           else {"precision": m})) for m in ("bf16", "int8")}
    for m, e in one.items():
        a, b = e.predict_array(keep["images"]), engines[m].predict_array(keep["images"])
        check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
              f"{m}: one 512² tile differs from the untiled engine")
    r["tiled"] = {"grid": "3x3", "tiles_per_batch": 9 * TILED_BATCH,
                  "one_tile_equals_untiled": True, "int8_equal_plain": True,
                  **{f"{m}_img_per_s": e.throughput(n_batches=5) for m, e in tiled.items()}}
    print(f"[serve] tiled {TILED_HW[0]}² in 512² tiles, overlap {TILE_OVERLAP} (3x3 grid, "
          f"{9 * TILED_BATCH} tiles per batch of {TILED_BATCH}): bf16 "
          f"{r['tiled']['bf16_img_per_s']:.2f} img/s, int8 {r['tiled']['int8_img_per_s']:.2f} "
          f"img/s; K1 1 and K2 18 per tile batch; int8 bit for bit the plain K1/K2 tiled "
          f"forward; one 512² tile equals the untiled engine in bf16 and int8", flush=True)
    return keep


def _png_bytes(arr):
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _png_array(b64):
    import base64
    import io

    import numpy as np
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _http(port, method, path, body=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body)
        r = conn.getresponse()
        data = r.read()
        return r.status, dict(r.getheaders()), data, (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def _engine_counters(metrics_text):
    """The engine batch and request counters of a /metrics text."""
    counters = {}
    for line in metrics_text.splitlines():
        if line.startswith(("tpu_unet_engine_batches_total", "tpu_unet_engine_requests_total")):
            key, value = line.rsplit(" ", 1)
            counters[key] = int(value)
    return counters


def _recording(batcher, log):
    """Record each flush's image stack and results (the batcher's run_batch)."""
    inner = batcher._run

    def run(images):
        results = inner(images)
        log.append((images.copy(), results))
        return results

    batcher._run = run


def _daemon_leg(torch, np, out, legs, name, service, requests):
    """``requests`` ((path, image) pairs) from DAEMON_CLIENTS threads against
    make_server on 127.0.0.1:0. Every response must equal its row of its
    flush's results, and the engine run again on each flush's stack must
    give those results bit for bit. Returns the per-request latencies."""
    import json
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from tpu_unet_torch.serve_http import make_server

    logs = {"main": []}
    _recording(service.batcher, logs["main"])
    if service.heatmap_batcher is not None:
        logs["heatmap"] = []
        _recording(service.heatmap_batcher, logs["heatmap"])
    server = make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        bodies = [(path, _png_bytes(img)) for path, img in requests]
        before = _engine_counters(_http(port, "GET", "/metrics")[2].decode())
        _zero_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(DAEMON_CLIENTS) as pool:
            replies = list(pool.map(lambda pb: _http(port, "POST", pb[0], pb[1]), bodies))
        wall = time.perf_counter() - t0
        legs[name] = _launches()
        metrics = _http(port, "GET", "/metrics")[2].decode()
        meta = json.loads(_http(port, "GET", "/healthz")[2])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(all(r[0] == 200 for r in replies), f"{name}: statuses {[r[0] for r in replies]}")
    engine = service.engine
    rows = {}
    for prog, log in logs.items():
        for stack, results in log:
            if prog == "main" and service.kind == "segmentation_predictor":
                again = list(zip(*engine.predict_array(stack)))
            elif prog == "main":
                again = list(engine.score_array(stack))
            else:
                again = list(zip(*engine.heatmap_array(stack)))
            for img, res, res2 in zip(stack, results, again):
                same = (np.array_equal(res[0], res2[0]) and np.array_equal(res[1], res2[1])
                        if isinstance(res, tuple) else res == res2)
                check(same, f"{name}: a flush's results differ from the engine run again")
                rows[(prog, img.tobytes())] = res
    for (path, img), reply in zip(requests, replies):
        r = json.loads(reply[2])
        if path == "/v1/predict":
            mask, conf = rows[("main", img.tobytes())]
            ok = (np.array_equal(_png_array(r["mask_png_base64"]), mask)
                  and r["mean_confidence"] == float(conf))
        elif path == "/v1/score":
            ok = r["score"] == float(rows[("main", img.tobytes())])
        else:
            score, heat = rows[("heatmap", img.tobytes())]
            ok = r["score"] == float(score) and np.array_equal(
                _png_array(r["heatmap_png_base64"]), heat)
        check(ok, f"{name}: a response differs from the engine's output for its image")
    lat = np.array([rep[3] for rep in replies])
    flushes = {prog: [len(s) for s, _ in log] for prog, log in logs.items()}
    counters = {k: v - before.get(k, 0) for k, v in _engine_counters(metrics).items()}
    for prog, sizes in flushes.items():
        check(counters[f'tpu_unet_engine_batches_total{{program="{prog}"}}'] == len(sizes)
              and counters[f'tpu_unet_engine_requests_total{{program="{prog}"}}'] == sum(sizes),
              f"{name}: /metrics disagrees with the flushes of {prog}")
    r = {"requests": len(requests), "clients": DAEMON_CLIENTS, "wall_s": wall,
         "request_p50_ms": float(np.percentile(lat, 50)),
         "request_p95_ms": float(np.percentile(lat, 95)),
         "flush_sizes": flushes, "metrics_counters_during_requests": counters,
         "requests_served": meta["requests_served"], "launches": legs[name]}
    out[name] = r
    print(f"[serve] daemon {name}: {len(requests)} PNG requests from {DAEMON_CLIENTS} client "
          f"threads in {wall:.2f} s, request p50 {r['request_p50_ms']:.1f} ms p95 "
          f"{r['request_p95_ms']:.1f} ms; flushes (from /metrics) "
          + ", ".join(f"{p}: {len(s)} of mean size {sum(s) / len(s):.2f}"
                      for p, s in flushes.items())
          + f"; launches {legs[name]}; every response equals its flush's engine output",
          flush=True)
    return flushes


def _overload(torch, np, out, engine):
    """max_queue 2 with the engine held: a burst of DAEMON_CLIENTS requests
    gets 503s with Retry-After, as many as /healthz counts rejected."""
    import json
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from tpu_unet_torch.serve_http import ServingService, make_server

    service = ServingService(engine, max_wait_ms=0, max_queue=2)
    gate, entered = threading.Event(), threading.Event()
    inner = service.batcher._run

    def held(images):
        entered.set()
        gate.wait(timeout=120)
        return inner(images)

    service.batcher._run = held
    server = make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    body = _png_bytes(synth_hw(torch, 1, engine.image_size_hw, 70)[0])
    try:
        with ThreadPoolExecutor(DAEMON_CLIENTS) as pool:
            first = pool.submit(_http, port, "POST", "/v1/predict", body)
            check(entered.wait(timeout=120), "overload: the first request never ran")
            burst = [pool.submit(_http, port, "POST", "/v1/predict", body)
                     for _ in range(DAEMON_CLIENTS - 1)]
            time.sleep(1.0)
            gate.set()
            replies = [first.result()] + [f.result() for f in burst]
        meta = json.loads(_http(port, "GET", "/healthz")[2])
    finally:
        gate.set()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    codes = [rep[0] for rep in replies]
    refused = [rep for rep in replies if rep[0] == 503]
    check(refused and all(rep[1].get("Retry-After") == "1" for rep in refused)
          and meta["requests_rejected"] == len(refused)
          and codes.count(200) == len(codes) - len(refused),
          f"overload: statuses {codes}, /healthz rejected {meta['requests_rejected']}")
    out["overload"] = {"max_queue": 2, "burst": len(codes), "served": codes.count(200),
                       "refused_503": len(refused), "healthz_rejected": meta["requests_rejected"]}
    print(f"[serve] overload: max_queue 2, engine held, burst of {len(codes)}: "
          f"{codes.count(200)} served, {len(refused)} refused with 503 + Retry-After; "
          f"/healthz counts {meta['requests_rejected']} rejected", flush=True)


def _artifact_leg(torch, np, out, legs, name, engine, images, tmp, want):
    """Export ``engine``, load it, and hold the loaded engine's outputs bit for
    bit against the live one's; the launches through the loaded programs must
    be ``want``."""
    from tpu_unet_torch.serve import AnomalyScorer
    from tpu_unet_torch.serve_artifact import export_artifact, load_artifact

    d = os.path.join(tmp, name)
    t0 = time.perf_counter()
    meta = export_artifact(engine, d)
    export_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e6
    t0 = time.perf_counter()
    loaded = load_artifact(d, device=engine.device)
    load_s = time.perf_counter() - t0
    anomaly = isinstance(engine, AnomalyScorer)
    run = ((lambda e: (e.score_array(images),) + e.heatmap_array(images)) if anomaly
           else (lambda e: e.predict_array(images)))
    _zero_launches()
    got = run(loaded)
    legs[name] = _launches()
    check(legs[name] == want, f"{name} launched {legs[name]} (want {want})")
    live = run(engine)
    check(all(np.array_equal(a, b) for a, b in zip(got, live)),
          f"{name}: the loaded artifact's outputs differ from the live engine's")
    out[name] = {"mb": mb, "export_s": export_s, "load_s": load_s, "files": sorted(os.listdir(d)),
                 "bucket_sizes": meta.get("bucket_sizes"), "launches": legs[name],
                 "equal_live": True}
    print(f"[serve] artifact {name}: {mb:.1f} MB ({len(os.listdir(d)) - 2} programs), export "
          f"{export_s:.1f} s, load {load_s:.2f} s; through the loaded programs K1 "
          f"{legs[name]['normalize_u8']}x, K2 {legs[name]['conv3x3_int8']}x; outputs bit for "
          f"bit the live engine's", flush=True)
    shutil.rmtree(d)


def phase_serving(torch, np, report, tmp):
    """Phase 11: the serving surface at full width through the port's entry
    points. SegmentationPredictor at serve_seg's defaults (SegmentationUNet
    base 64, 4 classes, 512², b16) in f32 --fold_bn, bf16 and int8, and at
    KolektorSDD's 1024 x 512 b8 with 3 classes; UNet++ at --heads 1 and the
    attention UNet in int8; the 512² model tiled over 1024² images; the HTTP
    daemon over the bf16 seg engine (buckets 1, 4, 16) and the int8 AnomalyScorer
    with its heatmap; artifacts exported and loaded. Weights are seeded, BN
    warmed. Returns the launch counts of each leg."""
    from tpu_unet_torch.serve import AnomalyScorer, SegmentationPredictor
    from tpu_unet_torch.serve_http import ServingService

    print(f"[serve] card: {nvidia_smi_line()}", flush=True)
    legs, out = {}, {}
    report["main_path"]["serving"] = out
    keep = _serve_models(torch, np, out, legs)

    # (d) The HTTP daemon.
    t0 = time.perf_counter()
    seg = SegmentationPredictor.from_state_dict(
        keep["sd"], precision="bf16", num_classes=4, image_size_hw=SERVE_HW,
        batch_size=SERVE_BATCH, bucket_sizes=(1, 4, 16), device="cuda")
    anomaly = AnomalyScorer.from_state_dict(
        warm_anomaly_state_dict(torch), quantize="int8", with_heatmap=True, image_size=256,
        batch_size=8, calib_images=synth_images(torch, 32, 256, 71, "cuda"), device="cuda")
    for service in (ServingService(seg, max_wait_ms=5), ServingService(anomaly, max_wait_ms=5)):
        service.warmup()
        try:
            if service.kind == "segmentation_predictor":
                imgs = synth_hw(torch, DAEMON_REQUESTS, SERVE_HW, 72)
                requests = [("/v1/predict", im) for im in imgs]
                flushes = _daemon_leg(torch, np, out, legs, "daemon_seg_bf16", service, requests)
                n = len(flushes["main"])
                check(legs["daemon_seg_bf16"] == {"normalize_u8": n, "conv3x3_int8": 0},
                      f"daemon_seg_bf16 launched {legs['daemon_seg_bf16']} for {n} flushes")
            else:
                imgs = synth_images(torch, DAEMON_REQUESTS, 256, 73, "cuda")
                requests = [("/v1/score" if i % 2 else "/v1/heatmap", im)
                            for i, im in enumerate(imgs)]
                flushes = _daemon_leg(torch, np, out, legs, "daemon_anomaly_int8", service,
                                      requests)
                ns, nh = len(flushes["main"]), len(flushes["heatmap"])
                want = {"normalize_u8": ns + nh, "conv3x3_int8": 18 * ns + 26 * nh}
                check(legs["daemon_anomaly_int8"] == want,
                      f"daemon_anomaly_int8 launched {legs['daemon_anomaly_int8']} (want {want})")
        finally:
            service.close()
    _overload(torch, np, out, seg)
    out["daemon_s"] = time.perf_counter() - t0

    # (e) Artifacts.
    images = keep["images"]
    # 20 images: one batch of 16 and one padded to the bucket of 4.
    _artifact_leg(torch, np, out, legs, "artifact_seg_bf16_buckets", seg, images[:20], tmp,
                  {"normalize_u8": 2, "conv3x3_int8": 0})
    _artifact_leg(torch, np, out, legs, "artifact_seg_int8", keep["engines"]["int8"], images,
                  tmp, {"normalize_u8": 2, "conv3x3_int8": 36})
    # 16 images at b8 through the score and the heatmap programs: 18 and 26 K2 each.
    _artifact_leg(torch, np, out, legs, "artifact_anomaly_int8", anomaly,
                  synth_images(torch, 16, 256, 74, "cuda"), tmp,
                  {"normalize_u8": 4, "conv3x3_int8": 2 * 18 + 2 * 26})
    del keep, seg, anomaly
    torch.cuda.empty_cache()
    return legs


# Phase 12: the host data path (the native resampler, the packed sample
# store), the viewers' collect halves and remat. The resize timings run over
# 16 of phase 8's 900² bottle PNGs and 16 of phase 9's 1260 x 500 KolektorSDD
# parts; the viewers over the first 16 test images (visualize_mvtec's and
# visualize_seg's batch defaults, 8 and 4).
RESIZE_IMAGES = 16
VIZ_SAMPLES = 16
REMAT_STEPS = 10


def _host_ms(np, fn, items, reps=3):
    """Median over ``reps`` passes of the host ms per item of ``fn``."""
    passes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for it in items:
            fn(it)
        passes.append(1e3 * (time.perf_counter() - t0) / len(items))
    return float(np.median(passes))


def _dir_mb(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 1e6


def _native_leg(np, out, tmp, bottle_root, ksdd_root):
    """[native]: a fresh g++ build, then ms per resize (native area on 1
    and on the default threads, PIL BILINEAR) at MVTec's and KolektorSDD's
    downscales; native within 1 LSB of PIL; the batch entry bit for bit the
    per-image calls."""
    import glob

    from PIL import Image

    from tpu_unet_torch.data import native

    built = native.build(os.path.join(tmp, "native_build"))
    threads = native._threads(0)
    rows = {"build_s": built["seconds"], "flags": " ".join(native.CXX_FLAGS),
            "default_threads": threads}
    print(f"[native] g++ {' '.join(native.CXX_FLAGS)} built {native.SOURCE.name} in "
          f"{built['seconds']:.2f} s", flush=True)
    sets = {"mvtec_900_to_256": (sorted(glob.glob(os.path.join(
        bottle_root, "bottle", "train", "good", "*.png")))[:RESIZE_IMAGES], (256, 256)),
        "ksdd_1260x500_to_1024x512": (sorted(glob.glob(os.path.join(
            ksdd_root, "kos*", "*.jpg")))[:RESIZE_IMAGES], (1024, 512))}
    for name, (paths, (h, w)) in sets.items():
        check(len(paths) == RESIZE_IMAGES, f"{name}: {len(paths)} images")
        ims = []
        for p in paths:
            with Image.open(p) as im:
                ims.append(im.convert("RGB"))
        arrs = [np.asarray(im, np.uint8) for im in ims]
        r = {"images": len(paths), "src_hw": list(arrs[0].shape[:2]), "dst_hw": [h, w],
             "native_1_thread_ms": _host_ms(
                 np, lambda a: native.resize_u8(a, (h, w), "area", n_threads=1), arrs),
             "native_ms": _host_ms(np, lambda a: native.resize_u8(a, (h, w), "area"), arrs),
             "pil_bilinear_ms": _host_ms(np, lambda im: im.resize((w, h), Image.BILINEAR),
                                         ims)}
        # Four callers at once, as the loader's workers call load_image_rgb:
        # wall ms per image of native on 1 thread per call (load_image_rgb's
        # setting), on the default threads per call, and of PIL.
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=4) as pool:
            for key, fn, items in (
                    ("4_callers_native_1_thread_ms",
                     lambda a: native.resize_u8(a, (h, w), "area", n_threads=1), arrs),
                    ("4_callers_native_ms", lambda a: native.resize_u8(a, (h, w), "area"),
                     arrs),
                    ("4_callers_pil_bilinear_ms",
                     lambda im: im.resize((w, h), Image.BILINEAR), ims)):
                r[key] = _host_ms(np, lambda _: list(pool.map(fn, items)), [None]) / len(items)
        stack = np.stack(arrs)
        t0 = time.perf_counter()
        batch = native.resize_u8_batch(stack, (h, w), "area")
        r["native_batch_ms_per_image"] = 1e3 * (time.perf_counter() - t0) / len(arrs)
        diff = 0
        for i, (im, a) in enumerate(zip(ims, arrs)):
            mine = native.resize_u8(a, (h, w), "area")
            check(np.array_equal(batch[i], mine),
                  f"{name}: the batch entry differs from the per-image call at image {i}")
            pil = np.asarray(im.resize((w, h), Image.BILINEAR), np.uint8)
            diff = max(diff, int(np.abs(mine.astype(np.int16) - pil.astype(np.int16)).max()))
        r["max_abs_diff_vs_pil"] = diff
        check(diff <= 1, f"{name}: native area differs from PIL BILINEAR by {diff} LSB")
        rows[name] = r
        print(f"[native] {name} ({r['src_hw'][0]}x{r['src_hw'][1]} -> {h}x{w} RGB, "
              f"{len(paths)} images): native area {r['native_1_thread_ms']:.2f} ms on 1 "
              f"thread, {r['native_ms']:.2f} ms on {threads}; batch entry "
              f"{r['native_batch_ms_per_image']:.2f} ms per image (bit for bit the "
              f"per-image calls); PIL BILINEAR {r['pil_bilinear_ms']:.2f} ms; 4 callers at "
              f"once, wall ms per image: native on 1 thread per call (load_image_rgb) "
              f"{r['4_callers_native_1_thread_ms']:.2f}, on {threads} per call "
              f"{r['4_callers_native_ms']:.2f}, PIL {r['4_callers_pil_bilinear_ms']:.2f}; "
              f"max |native - PIL| {diff} LSB (limit 1)", flush=True)
    out["native"] = rows


def _same_samples(np, name, packed, direct):
    """Every sample of ``packed`` bit for bit ``direct``'s (decoded on 8
    threads)."""
    from concurrent.futures import ThreadPoolExecutor
    check(len(packed) == len(direct), f"{name}: {len(packed)} against {len(direct)}")
    with ThreadPoolExecutor(max_workers=8) as pool:
        for i, want in enumerate(pool.map(direct.load, range(len(direct)))):
            got = packed.load(i)
            check(set(got) == set(want), f"{name} sample {i}: keys {sorted(got)}")
            for k, v in want.items():
                same = (got[k] == v if isinstance(v, str) else
                        np.asarray(got[k]).dtype == np.asarray(v).dtype
                        and np.array_equal(np.asarray(got[k]), np.asarray(v)))
                check(same, f"{name} sample {i}: packed {k} differs from the direct decode")


@contextlib.contextmanager
def _data_env(cache, use_native=True):
    """``TPU_UNET_DATA_CACHE`` (None: no pack) and the resampler for the
    datasets built inside."""
    from tpu_unet_torch.data import transforms
    before = os.environ.get("TPU_UNET_DATA_CACHE"), transforms._USE_NATIVE
    os.environ["TPU_UNET_DATA_CACHE"] = cache or ""
    transforms._USE_NATIVE = use_native
    try:
        yield
    finally:
        os.environ["TPU_UNET_DATA_CACHE"] = before[0] or ""
        transforms._USE_NATIVE = before[1]


def _mvtec_epoch0(torch, np, legs, tmp, data_root, leg, cache, use_native):
    """Epoch 0 of ``train_mvtec.train`` (phase 8's flags, one epoch) on
    fresh datasets; returns its train img/s and seconds."""
    from tpu_unet_torch.cli import train_mvtec
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8

    b = 16
    args = train_mvtec.parse_args([
        "--data_root", data_root, "--category", "bottle", "--model", "anomaly_unet",
        "--base_features", "64", "--image_size", "256", "--batch_size", str(b),
        "--num_workers", "4", "--device", "cuda", "--precision", "bf16", "--optimizer",
        "adam", "--epochs", "1", "--val_freq", "1", "--save_freq", "2",
        "--save_dir", os.path.join(tmp, "runs")])
    with _data_env(cache, use_native):
        train_ds = MVTecDataset(data_root, "bottle", "train", 256, is_train=True)
        val_ds = MVTecDataset(data_root, "bottle", "test", 256, is_train=False)
        check((train_ds._pack is not None) == bool(cache), f"{leg}: pack {train_ds._pack}")
        spans = _Spans(torch, (normalize_u8, conv3x3_int8))
        train_mvtec.train(args, train_ds, val_ds, torch.device("cuda"),
                          os.path.join(tmp, "runs", leg), span=spans)
    shutil.rmtree(os.path.join(tmp, "runs"))
    legs[f"pack_{leg}"] = {k: spans.total("train")[k] + spans.total("validate")[k]
                           for k in ("normalize_u8", "conv3x3_int8")}
    tr = spans.rows["train", 0]
    n = (len(train_ds) // b) * b
    return {"train_s": tr["seconds"], "img_per_s": n / tr["seconds"],
            "val_s": spans.rows["validate", 0]["seconds"]}


def _ksdd_epoch0(torch, np, legs, tmp, data_root, leg, cache):
    """Epoch 0 of ``train_kolektorsdd``'s defaults (one epoch) through
    ``_seg_common.train_seg`` on fresh datasets."""
    from tpu_unet_torch.cli import _seg_common as seg
    from tpu_unet_torch.cli import train_kolektorsdd
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8

    args = train_kolektorsdd.parse_args([
        "--data_root", data_root, "--batch_size", str(SEG_BATCH), "--num_workers", "4",
        "--device", "cuda", "--epochs", "1", "--val_freq", "1", "--save_freq", "1",
        "--save_dir", os.path.join(tmp, "runs")])
    workload = train_kolektorsdd.make_workload()
    with _data_env(cache):
        t0 = time.perf_counter()
        train_ds, val_ds, test_ds, n_classes, _ = workload.make_datasets(args)
        index_s = time.perf_counter() - t0
        check((train_ds._pack is not None) == bool(cache), f"{leg}: pack {train_ds._pack}")
        spans = _Spans(torch, (normalize_u8, conv3x3_int8))
        seg.train_seg(args, workload, train_ds, val_ds, n_classes, torch.device("cuda"),
                      os.path.join(tmp, "runs", leg), span=spans)
    shutil.rmtree(os.path.join(tmp, "runs"))
    legs[f"pack_{leg}"] = {k: spans.total("train")[k] + spans.total("validate")[k]
                           for k in ("normalize_u8", "conv3x3_int8")}
    tr = spans.rows["train", 0]
    n = (len(train_ds) // SEG_BATCH) * SEG_BATCH
    return {"train_s": tr["seconds"], "img_per_s": n / tr["seconds"],
            "val_s": spans.rows["validate", 0]["seconds"], "datasets_s": index_s,
            "datasets": (train_ds, val_ds, test_ds)}


def _pack_leg(torch, np, out, legs, tmp, bottle_root, ksdd_root, phase8_epoch0):
    """[pack]: packs of phase 8's bottle tree and phase 9's KolektorSDD tree
    under TMPDIR (build seconds and MB), every packed sample bit for bit the
    direct decode, and epoch 0 of the trainers reading the packs beside the
    same epoch decoding natively without a pack (and, for MVTec, with PIL)."""
    from tpu_unet_torch.data.kolektorsdd import KolektorSDDDataset
    from tpu_unet_torch.data.mvtec import MVTecDataset

    packs = os.path.join(tmp, "packs")
    rows = {}
    with _data_env(packs):
        t0 = time.perf_counter()
        train_ds = MVTecDataset(bottle_root, "bottle", "train", 256, is_train=True)
        test_ds = MVTecDataset(bottle_root, "bottle", "test", 256, is_train=False)
        build_s = time.perf_counter() - t0
    check(train_ds._pack is not None and test_ds._pack is not None, "no MVTec pack")
    mb = _dir_mb(packs)
    for split, ds in (("train", train_ds), ("test", test_ds)):
        _same_samples(np, f"bottle {split}", ds, MVTecDataset(
            bottle_root, "bottle", split, 256, is_train=split == "train",
            cache_samples=False, disk_cache_dir=None))
    n_mvtec = len(train_ds) + len(test_ds)
    print(f"[pack] bottle: {n_mvtec} samples packed in {build_s:.2f} s "
          f"({n_mvtec / build_s:.1f} img/s, 8 threads), {mb:.1f} MB; every sample bit for "
          f"bit the direct decode", flush=True)
    epochs = {"pack": _mvtec_epoch0(torch, np, legs, tmp, bottle_root, "mvtec_pack", packs,
                                    True),
              "native_no_pack": _mvtec_epoch0(torch, np, legs, tmp, bottle_root,
                                              "mvtec_native", None, True),
              "pil_no_pack": _mvtec_epoch0(torch, np, legs, tmp, bottle_root,
                                           "mvtec_pil", None, False)}
    rows["mvtec"] = {"samples": n_mvtec, "build_s": build_s, "mb": mb,
                     "epoch0": epochs, "epoch0_native_no_pack_phase8": phase8_epoch0}
    print(f"[pack] bottle epoch 0 (train_mvtec.train, base 64, bf16, 256², b16, a fresh "
          f"MVTecDataset): reading the pack {epochs['pack']['img_per_s']:.1f} img/s "
          f"({epochs['pack']['train_s']:.3f} s); decoding natively without a pack "
          f"{epochs['native_no_pack']['img_per_s']:.1f} img/s "
          f"({epochs['native_no_pack']['train_s']:.3f} s; phase 8's epoch 0, the same decode: "
          f"{phase8_epoch0['train_img_per_s']:.1f}); decoding with PIL "
          f"{epochs['pil_no_pack']['img_per_s']:.1f} img/s "
          f"({epochs['pil_no_pack']['train_s']:.3f} s)", flush=True)

    before = _dir_mb(packs)
    kp = _ksdd_epoch0(torch, np, legs, tmp, ksdd_root, "ksdd_pack", packs)
    kmb = _dir_mb(packs) - before
    for split, ds in zip(("train", "val", "test"), kp.pop("datasets")):
        direct = KolektorSDDDataset(ksdd_root, split, (1024, 512), cache_samples=False,
                                    disk_cache_dir=None)
        _same_samples(np, f"kolektorsdd {split}", ds, direct)
    kn = _ksdd_epoch0(torch, np, legs, tmp, ksdd_root, "ksdd_native", None)
    kn.pop("datasets")
    rows["kolektorsdd"] = {"samples": KSDD_PARTS, "build_s": kp["datasets_s"], "mb": kmb,
                           "epoch0": {"pack": kp, "native_no_pack": kn}}
    print(f"[pack] KolektorSDD: {KSDD_PARTS} samples packed in {kp['datasets_s']:.2f} s, "
          f"{kmb:.1f} MB; every sample bit for bit the direct decode; epoch 0 "
          f"(train_seg, SegmentationUNet base 64, bf16, 1024x512, b8): reading the pack "
          f"{kp['img_per_s']:.1f} img/s ({kp['train_s']:.3f} s), decoding natively without "
          f"a pack {kn['img_per_s']:.1f} img/s ({kn['train_s']:.3f} s)", flush=True)
    out["pack"] = rows
    return packs


def _viz_leg(torch, np, out, legs, tmp, keep, packs):
    """[viz]: the viewers' collect halves on phase 8's, 9's and 10's
    checkpoints, held against ``test_mvtec``'s eval step and the bf16
    ``SegmentationPredictor`` on the same images, with K1's launches."""
    import importlib.util

    from tpu_unet_torch.cli import test_mvtec, visualize_mvtec, visualize_seg
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8
    from tpu_unet_torch.serve import SegmentationPredictor

    dev = torch.device("cuda")
    rows = {}
    render = importlib.util.find_spec("matplotlib") is not None
    with _data_env(packs):
        # --- visualize_mvtec on phase 8's best_model.pth ---------------------
        bottle = os.path.join(keep, "bottle")
        ckpt = os.path.join(keep, "mvtec_best_model.pth")
        vargs = visualize_mvtec.parse_args([
            "--data_root", bottle, "--category", "bottle", "--checkpoint", ckpt,
            "--max_samples", str(VIZ_SAMPLES), "--output_dir", os.path.join(tmp, "viz")])
        normalize_u8.launches = conv3x3_int8.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = visualize_mvtec.collect_records(vargs, dev)
        seconds = time.perf_counter() - t0
        launches = {"normalize_u8": normalize_u8.launches,
                    "conv3x3_int8": conv3x3_int8.launches}
        legs["viz_mvtec"] = launches
        n_batches = -(-VIZ_SAMPLES // vargs.batch_size)
        check(len(records) == VIZ_SAMPLES and launches == {"normalize_u8": n_batches,
                                                          "conv3x3_int8": 0},
              f"visualize_mvtec: {len(records)} records, launches {launches}")
        targs = test_mvtec.parse_args(["--data_root", bottle, "--checkpoint", ckpt,
                                       "--batch_size", str(vargs.batch_size)])
        state, step = test_mvtec.load_model(targs, dev)
        ds = MVTecDataset(bottle, "bottle", "test", 256, is_train=False)
        for lo in range(0, VIZ_SAMPLES, vargs.batch_size):
            batch = [ds.load(i) for i in range(lo, lo + vargs.batch_size)]
            ref = step(state, torch.from_numpy(np.stack([s["image"] for s in batch])).to(dev),
                       torch.from_numpy(np.stack([s["mask"] for s in batch])).to(dev))
            ref = {k: ref[k].cpu().numpy() for k in ("anomaly_map", "error_map",
                                                     "reconstruction", "score", "image")}
            for i in range(len(batch)):
                r = records[lo + i]
                check(r["image_path"] == batch[i]["image_path"], "visualize_mvtec order")
                for k in ("anomaly_map", "error_map", "reconstruction", "image"):
                    check(np.array_equal(r[k], ref[k][i]),
                          f"visualize_mvtec {k} of sample {lo + i} differs from test_mvtec's")
                check(r["score"] == float(ref["score"][i]),
                      f"visualize_mvtec score of sample {lo + i} differs from test_mvtec's")
        del state, step
        rows["mvtec"] = {"samples": len(records), "batch": vargs.batch_size,
                         "collect_s": seconds, "samples_per_s": len(records) / seconds,
                         "launches": launches}
        print(f"[viz] visualize_mvtec collect (AnomalyUNet base 64, bf16, phase 8's "
              f"best_model.pth): {len(records)} samples at b{vargs.batch_size} in "
              f"{seconds:.3f} s ({len(records) / seconds:.1f} samples/s, model load "
              f"included); K1 {launches['normalize_u8']}x for {n_batches} batches; anomaly "
              f"maps, error maps, reconstructions and scores bit for bit test_mvtec's eval "
              f"step", flush=True)
        if render:
            visualize_mvtec.render(vargs, records)

    # --- visualize_seg on phase 9's Gear and phase 10's UNet++ (no pack) ---------
    with _data_env(None):
        for name, ckpt, flags, kw in (
                ("gear_seg_unet", "gear_seg.pth", [], {}),
                ("gear_unetpp_heads1", "gear_unetpp.pth",
                 ["--model", "unetpp", "--deep_supervision", "--heads", "1"],
                 {"model_name": "unetpp", "deep_supervision": True, "heads": 1})):
            sargs = visualize_seg.parse_args([
                "--dataset", "gear", "--data_root", os.path.join(tmp, "gear"),
                "--checkpoint", os.path.join(keep, ckpt), "--num_samples", str(VIZ_SAMPLES),
                "--output_dir", os.path.join(tmp, "viz", name), *flags])
            ds, n_classes, class_names, hw = visualize_seg.build_dataset(sargs)
            normalize_u8.launches = conv3x3_int8.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples = visualize_seg.collect_samples(sargs, dev, ds)
            seconds = time.perf_counter() - t0
            launches = {"normalize_u8": normalize_u8.launches,
                        "conv3x3_int8": conv3x3_int8.launches}
            legs[f"viz_{name}"] = launches
            n_batches = -(-VIZ_SAMPLES // sargs.batch_size)
            check(len(samples) == VIZ_SAMPLES and launches == {"normalize_u8": n_batches,
                                                              "conv3x3_int8": 0},
                  f"visualize_seg {name}: {len(samples)} samples, launches {launches}")
            predictor = SegmentationPredictor.from_checkpoint(
                os.path.join(keep, ckpt), num_classes=n_classes, image_size_hw=hw,
                batch_size=sargs.batch_size, precision="bf16", fold_bn=False,
                base_features=64, device="cuda", **kw)
            images = np.stack([ds.load(i)["image"] for i in range(VIZ_SAMPLES)])
            masks, confs = predictor.predict_array(images)
            preds = np.stack([s["pred"] for s in samples])
            check(np.array_equal(preds, masks),
                  f"visualize_seg {name}: predictions differ from the bf16 predictor's on "
                  f"{int((preds != masks).sum())} pixels")
            conf_rel = float(np.max(np.abs(np.array([s["conf"].mean() for s in samples])
                                           - confs) / confs))
            check(conf_rel < 1e-5, f"visualize_seg {name}: mean confidence off by {conf_rel}")
            del predictor
            torch.cuda.empty_cache()
            rows[name] = {"samples": len(samples), "batch": sargs.batch_size,
                          "collect_s": seconds, "samples_per_s": len(samples) / seconds,
                          "launches": launches, "mean_conf_max_rel_vs_predictor": conf_rel}
            print(f"[viz] visualize_seg collect {name} (base 64, bf16, {hw[0]}x{hw[1]}): "
                  f"{len(samples)} samples at b{sargs.batch_size} in {seconds:.3f} s "
                  f"({len(samples) / seconds:.1f} samples/s, model load included); K1 "
                  f"{launches['normalize_u8']}x for {n_batches} batches; predictions bit "
                  f"for bit the bf16 SegmentationPredictor's, mean confidence within "
                  f"{conf_rel:.1e}", flush=True)
            if render:
                visualize_seg.render(sargs, samples, n_classes, class_names)
    if render:
        pngs = sum(f.endswith(".png") for _, _, fs in os.walk(os.path.join(tmp, "viz"))
                   for f in fs)
        check(pngs > 0, "the viewers rendered no PNG")
        print(f"[viz] render: {pngs} PNGs", flush=True)
    else:
        print("[viz] render: not run on this machine (no matplotlib)", flush=True)
    rows["rendered"] = render
    out["viz"] = rows


def _remat_timings(torch, np, name, make_state, make_step, batch, modes, b):
    """ms per step (the median of ``REMAT_STEPS`` after 2 warm-up steps),
    img/s and peak GB of each remat mode, each from a fresh state."""
    rows = {}
    for mode in modes:
        state = make_state()
        step = make_step(mode)

        def run(*a, step=step):  # the seg step returns (losses, cm)
            r = step(*a)
            return r[0] if isinstance(r, tuple) else r

        g = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, median_ms, losses = _timed_steps(torch, np, run, state, *batch, g, warmup=2,
                                            steps=REMAT_STEPS)
        check(np.isfinite(losses["total_loss"]).all(), f"{name} remat {mode}: loss")
        rows[mode] = {"median_ms": median_ms, "img_per_s": 1e3 * b / median_ms,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state
        torch.cuda.empty_cache()
        print(f"[remat] {name} remat={mode}: {median_ms:.2f} ms per step (median of "
              f"{REMAT_STEPS}), {rows[mode]['img_per_s']:.1f} img/s, peak "
              f"{rows[mode]['peak_gb']:.2f} GB", flush=True)
    return rows


def _remat_gate(torch, np, name, make_state, make_step, step_args, modes):
    """One step from the same state and batch: each remat mode's loss equals
    the plain step's exactly, its BN running statistics bit for bit (and
    ``num_batches_tracked`` + 1), its parameters within the difference of
    two plain runs or 1e-4, whichever is larger."""
    def one(mode):
        state = make_state()
        losses = make_step(mode).with_draws(state, *step_args)
        if isinstance(losses, tuple):
            losses = losses[0]
        sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        del state
        return {k: float(v) for k, v in losses.items()}, sd

    (l0, sd0), (l1, sd1) = one("none"), one("none")

    def param_diff(sd):
        return max(float((sd[k].float() - sd0[k].float()).abs().max()) for k in sd0
                   if "running" not in k and "num_batches" not in k)

    plain_diff = param_diff(sd1)
    rows = {"plain_vs_plain_param_max_abs": plain_diff}
    for mode in modes:
        lm, sdm = one(mode)
        check(lm == l0, f"{name} remat={mode}: losses {lm} against the plain step's {l0}")
        for k, v in sd0.items():
            if "running" in k or "num_batches_tracked" in k:
                check(torch.equal(sdm[k], v), f"{name} remat={mode}: {k} differs")
        check(all(int(v) == 1 for k, v in sdm.items() if k.endswith("num_batches_tracked")),
              f"{name} remat={mode}: num_batches_tracked did not rise by 1")
        d = param_diff(sdm)
        check(d <= max(plain_diff, 1e-4),
              f"{name} remat={mode}: parameters differ by {d:.3g} (two plain runs: "
              f"{plain_diff:.3g})")
        rows[mode] = {"param_max_abs_vs_plain": d, "loss_equal": True, "bn_stats_equal": True}
        print(f"[remat] {name} remat={mode} gate: loss {lm['total_loss']:.6f} equal to the "
              f"plain step's, BN running statistics bit for bit, num_batches_tracked +1, "
              f"parameters within {d:.3g} (two plain runs: {plain_diff:.3g})", flush=True)
    torch.cuda.empty_cache()
    return rows


def _remat_leg(torch, np, out):
    """[remat]: the flagship step (AnomalyUNet base 64, bf16, 256², b16,
    Adam) with remat none / full_res / full, and the KolektorSDD step
    (SegmentationUNet base 64, bf16, 1024 x 512, b8) with none and full_res:
    ms per step, img/s, peak GB, and the one-step gates."""
    from tpu_unet_torch.cli import train_kolektorsdd
    from tpu_unet_torch.core.precision import get_policy
    from tpu_unet_torch.models.unet import AnomalyUNet, SegmentationUNet
    from tpu_unet_torch.train.state import create_train_state
    from tpu_unet_torch.train.steps import (AugmentConfig, SegLossConfig,
                                            make_anomaly_train_step, make_seg_train_step)

    bf16 = get_policy("bf16")
    rows = {}

    torch.manual_seed(3)
    sd = AnomalyUNet(base_features=64, policy=bf16, remat_full_res=True).state_dict()

    def anomaly_state():
        model = AnomalyUNet(base_features=64, policy=bf16, remat_full_res=True)
        model.load_state_dict(sd)
        return create_train_state(model, "adam", 1e-3, 1e-4, device="cuda")

    def anomaly_step(mode):
        return make_anomaly_train_step(aug_cfg=AugmentConfig(), remat=mode)

    images = torch.from_numpy(synth_images(torch, 16, 256, 60, "cuda")).cuda()
    masks = synth_masks(torch, 16, 256, 61, "cuda")
    modes = ("none", "full_res", "full")
    flagship = _remat_timings(torch, np, "flagship", anomaly_state, anomaly_step,
                              (images, masks), modes, 16)
    draws = anomaly_step("none").draws(16, torch.Generator(device="cuda").manual_seed(5))
    flagship["gate"] = _remat_gate(torch, np, "flagship", anomaly_state, anomaly_step,
                                   (images, masks, draws), modes[1:])
    rows["flagship"] = flagship
    del sd
    torch.cuda.empty_cache()

    h, w = 1024, 512
    torch.manual_seed(4)
    ksd = SegmentationUNet(n_classes=3, base_features=64, policy=bf16,
                           remat_full_res=True).state_dict()
    aug = train_kolektorsdd.make_workload().augment
    loss = SegLossConfig(class_weights=(1.0, 50.0, 50.0))

    def seg_state():
        model = SegmentationUNet(n_classes=3, base_features=64, policy=bf16,
                                 remat_full_res=True)
        model.load_state_dict(ksd)
        return create_train_state(model, "adam", 1e-3, 1e-4, device="cuda")

    def seg_step(mode):
        return make_seg_train_step(3, loss, aug, remat=mode)

    g = torch.Generator(device="cuda").manual_seed(6)
    seg_images = torch.randint(0, 256, (SEG_BATCH, h, w, 3), generator=g, device="cuda",
                               dtype=torch.uint8)
    labels = (torch.rand(SEG_BATCH, h, w, generator=g, device="cuda") > 0.995).to(torch.uint8)
    ksdd = _remat_timings(torch, np, "kolektorsdd", seg_state, seg_step, (seg_images, labels),
                          ("none", "full_res"), SEG_BATCH)
    probe = seg_state()
    augment, dropout = seg_step("none").draws(probe.model, SEG_BATCH,
                                              torch.Generator(device="cuda").manual_seed(7))
    del probe
    ksdd["gate"] = _remat_gate(torch, np, "kolektorsdd", seg_state, seg_step,
                               (seg_images, labels, augment, dropout), ("full_res",))
    rows["kolektorsdd"] = ksdd
    out["remat"] = rows


def phase_host_data(torch, np, report, tmp, keep):
    """Phase 12: the host data path, the viewers and remat. ``keep`` holds
    phase 8's bottle tree and best checkpoint and phases 9 and 10's Gear
    checkpoints; ``tmp`` phase 9's trees. Returns the launch counts of each
    leg."""
    out, legs = {}, {}
    t0 = time.perf_counter()
    bottle = os.path.join(keep, "bottle")
    _native_leg(np, out, tmp, bottle, os.path.join(tmp, "ksdd"))
    phase8_epoch0 = report["main_path"]["mvtec"]["epochs"][0]
    packs = _pack_leg(torch, np, out, legs, tmp, bottle, os.path.join(tmp, "ksdd"),
                      {k: phase8_epoch0[k] for k in ("train_s", "train_img_per_s")})
    _viz_leg(torch, np, out, legs, tmp, keep, packs)
    _remat_leg(torch, np, out)
    out["seconds"] = time.perf_counter() - t0
    print(f"[phase 12] {out['seconds']:.1f} s", flush=True)
    report["main_path"]["host_data"] = out
    return legs


# ---------------------------------------------------------------------------
# Phase 13: data parallelism on the one card
# ---------------------------------------------------------------------------

# Phase 13's tolerances. The flagship step's loss at world size 1 over NCCL
# (sync BN, the gradient all-reduce) against the plain step on the same batch
# and draws, bf16: relative. The 2-rank f32 SGD step (and FSDP's) against the
# world-size-1 step: the update's relative L2 error over every parameter
# (``_update_err``), and the BN statistics' largest |difference| over each
# leaf's largest |value|. Reordered float32 sums (two ranks' partial sums;
# cuDNN's algorithms at batch 8 against 16, NCHW under FSDP against
# channels_last) move single leaves' gradients by up to 2% where a max-pool
# window's values tie or a value sits at ReLU's edge (ROADMAP §3, note 8), so
# the update is held as a whole.
DP_LOSS_RTOL = 5e-3
DP_UPDATE_TOL = 5e-3
DP_STAT_TOL = 2.5e-5
DP_STEPS = 5
# The widest base_features at which phase 13 holds FSDP against DP on two
# gloo ranks sharing the card: the full width (``chip_smoke.py fsdp_widths``
# bisects it).
FSDP_BASE = 64


def _dp_batch(torch, b=16, size=256):
    """Phase 13's global batch: seeded textures and masks on the current
    card, the same in every process."""
    images = torch.from_numpy(synth_images(torch, b, size, 130, "cuda")).cuda()
    return images, synth_masks(torch, b, size, 131, "cuda")


def _dp_state(torch, precision, opt, lr, group_mesh=None, fsdp=False, base=64, tp=False):
    """AnomalyUNet at ``base`` from seed 3 (the same weights in every
    process), placed on ``group_mesh`` when given (``tp``: tensor-parallel
    over its 'model' axis); (state, group)."""
    from tpu_unet_torch.core.precision import get_policy
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.parallel.fsdp import shard_state
    from tpu_unet_torch.parallel.mesh import group_of
    from tpu_unet_torch.train.state import create_train_state

    torch.manual_seed(3)
    model = build_model("anomaly_unet", base_features=base, policy=get_policy(precision))
    state = create_train_state(model, opt, lr, 1e-4, device="cuda")
    return shard_state(group_mesh, state, fsdp=fsdp, tp=tp), group_of(group_mesh)


def _dp_step_ms(torch, step, state, images, masks, g, sync=None, steps=DP_STEPS, warmup=2):
    """Mean ms of ``steps`` train steps after ``warmup`` ones, host clock to
    a synchronize (``sync()``, a barrier across ranks, after it)."""
    for _ in range(warmup):
        step(state, images, masks, g)
    torch.cuda.synchronize()
    if sync:
        sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, images, masks, g)
    torch.cuda.synchronize()
    if sync:
        sync()
    return (time.perf_counter() - t0) * 1e3 / steps


def _cpu_state_dict(state):
    """The state's model tensors, whole (FSDP's gathered over 'data', tensor
    parallelism's over 'model': every rank joins), on the CPU."""
    from tpu_unet_torch.parallel.tensor import full_tensors
    from tpu_unet_torch.train.checkpoint import _full
    sd, _ = full_tensors(state, _full(state.model.state_dict()), {"state": {}})
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _dp_one_step(torch, mesh, local, fsdp, opt="sgd", base=64, tp=False):
    """One f32 step (SGD lr 1e-2, or Adam lr 1e-3: fused on CUDA) from seed
    3 at ``base`` on this rank's rows of phase 13's batch under the global
    batch's draws: rank 0's whole state and the losses."""
    from tpu_unet_torch.train.steps import AugmentConfig, make_anomaly_train_step

    state, group = _dp_state(torch, "f32", opt, 1e-2 if opt == "sgd" else 1e-3, mesh, fsdp,
                             base, tp)
    step = make_anomaly_train_step(aug_cfg=AugmentConfig(), group=group)
    draws = step.draws(len(local[0]), torch.Generator(device="cuda").manual_seed(0))
    losses = step.with_draws(state, *local, draws)
    return _cpu_state_dict(state), {k: float(v) for k, v in losses.items()}


def _dp_flagship(torch, mesh, local, fsdp, ckpt=None, base=64, tp=False, evaluate=False,
                 steps=DP_STEPS):
    """The flagship step (bf16 Adam) on this rank's rows: ms per step and
    the state's bytes per rank beside the JAX package's placement on the
    same mesh; ``ckpt``: then a checkpoint there (every rank joins, rank 0
    writes); ``evaluate``: then the eval step on the trained state, its
    launches counted."""
    import torch.distributed as dist

    from tpu_unet_torch.parallel import fsdp as fsdp_mod
    from tpu_unet_torch.parallel import tensor
    from tpu_unet_torch.parallel.mesh import data_size
    from tpu_unet_torch.train.checkpoint import CheckpointWriter
    from tpu_unet_torch.train.steps import (AugmentConfig, make_anomaly_eval_step,
                                            make_anomaly_train_step)

    state, group = _dp_state(torch, "bf16", "adam", 1e-3, mesh, fsdp, base, tp)
    step = make_anomaly_train_step(aug_cfg=AugmentConfig(), group=group)
    ms = _dp_step_ms(torch, step, state, *local, torch.Generator(device="cuda").manual_seed(1),
                     sync=dist.barrier, steps=steps, warmup=min(2, steps))
    jax_bytes = (tensor.jax_placement_bytes(state, data_size(), fsdp) if tp
                 else fsdp_mod.jax_placement_bytes(state, dist.get_world_size()))
    out = {"step_ms": ms, "state_bytes": fsdp_mod.per_device_state_bytes(state),
           "jax_placement_bytes": jax_bytes,
           "sharded_fraction": (tensor.sharded_fraction if tp
                                else fsdp_mod.sharded_fraction)(state),
           "adam_steps": state.step}
    if evaluate:
        _zero_launches()
        ev = make_anomaly_eval_step(group=group)(state, *local)
        torch.cuda.synchronize()
        out["eval"] = {"launches": _launches(), "rows": int(ev["score"].shape[0]),
                       "finite": bool(torch.isfinite(ev["score"]).all()
                                      and torch.isfinite(ev["reconstruction"]).all()),
                       "loss": float(ev["losses"]["total_loss"])}
    if ckpt:
        with CheckpointWriter() as writer:
            writer.save(state, 3, 0.0, ckpt)
    del state
    torch.cuda.empty_cache()
    return out


def _dp_setup(torch):
    import torch.distributed as dist

    from tpu_unet_torch.parallel.mesh import make_mesh, shard_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return make_mesh(dist.get_world_size(), device_type="cuda"), shard_batch(_dp_batch(torch))


def _fsdp_rank(base):
    """FSDP against plain DP on one of two ranks sharing the card over gloo,
    at ``base``: one f32 SGD step and one f32 Adam step (fused on CUDA) each
    way from the same state, batch and draws, then the flagship step's ms
    and bytes under FSDP. The caller holds FSDP against DP."""
    import torch
    import torch.distributed as dist

    mesh, local = _dp_setup(torch)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    out = {"before": _cpu_state_dict(_dp_state(torch, "f32", "sgd", 0.0, base=base)[0])}
    for opt in ("sgd", "adam"):
        for fsdp in (False, True):
            out[opt, fsdp] = _dp_one_step(torch, mesh, local, fsdp, opt, base)
            say(f"[dp] rank 0: the {'FSDP' if fsdp else 'DP'} {opt} step at base {base} ran",
                flush=True)
    out["timing"] = _dp_flagship(torch, mesh, local, fsdp=True, base=base)
    say(f"[dp] rank 0: the FSDP flagship steps at base {base} ran", flush=True)
    return out


def _dp_rank(keep, work):
    """Phase 13 on one of two ranks sharing the card over gloo: the f32 SGD
    step, the flagship bf16 Adam step timed with a checkpoint written, and
    test_mvtec's int8 path on phase 8's checkpoint. Returns what rank 0
    gathered."""
    import torch
    import torch.distributed as dist

    from tpu_unet_torch.cli import test_mvtec
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8

    mesh, local = _dp_setup(torch)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    out = {}
    out["sgd"], out["sgd_losses"] = _dp_one_step(torch, mesh, local, fsdp=False)
    say("[dp] rank 0: the f32 SGD step ran", flush=True)
    out["timing"] = {"dp": _dp_flagship(torch, mesh, local, fsdp=False,
                                        ckpt=os.path.join(work, "dp_adam.pth"))}
    say("[dp] rank 0: the flagship steps ran and the checkpoint is written", flush=True)

    # test_mvtec's functions in --quantize int8 over both ranks.
    flags = ["--data_root", os.path.join(keep, "bottle"), "--category", "bottle",
             "--base_features", "64", "--image_size", "256", "--batch_size", "16",
             "--num_workers", "4", "--device", "cuda", "--precision", "bf16",
             "--quantize", "int8", "--calib_samples", "64",
             "--checkpoint", os.path.join(keep, "mvtec_best_model.pth")]
    targs = test_mvtec.parse_args(flags + ["--output_dir", os.path.join(work, "test")])
    test_ds = MVTecDataset(targs.data_root, "bottle", "test", 256, is_train=False)
    train_ds = MVTecDataset(targs.data_root, "bottle", "train", 256, is_train=True)
    dev = torch.device("cuda")
    normalize_u8.launches = conv3x3_int8.launches = 0
    loader = test_mvtec.make_test_loader(targs, test_ds, dev)
    state, eval_step = test_mvtec.load_model(targs, dev, train_ds)
    t0 = time.perf_counter()
    res = test_mvtec.test_model(eval_step, state, loader)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev = test_mvtec.evaluate_results(res, targs.pixel_thresholds, targs.threshold)
    counts = {"normalize_u8": normalize_u8.launches, "conv3x3_int8": conv3x3_int8.launches}
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, {"launches": counts, "test_model_s": t1 - t0})
    from tpu_unet_torch.ops.quantize import tree_to
    out["test"] = {"scores": res["anomaly_scores"], "paths": res["image_paths"],
                   "auroc": ev["image_metrics"]["auroc"], "per_rank": per_rank,
                   "n_batches": len(loader), "qparams": tree_to(eval_step.qparams, "cpu")}
    return out


def phase_dp(torch, np, report, keep):
    """Phase 13: data parallelism on the one card. The flagship step at world
    size 1 over NCCL against the plain step; two ranks sharing the card over
    gloo (the f32 SGD step against world size 1, FSDP where gloo takes its
    collectives, the flagship step's ms and per-rank bytes, a checkpoint,
    test_mvtec's int8 path on phase 8's checkpoint against one process);
    the 2-rank checkpoint resumed at world size 1; AnomalyScorer int8 with
    two replicas on the card against one. Returns the launch counts."""
    import torch.distributed as dist

    from tpu_unet_torch.cli import test_mvtec
    from tpu_unet_torch.cli._seg_common import QuantizedEvalStep
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.ops.quantize import make_quantized_anomaly_eval_step, tree_to
    from tpu_unet_torch.parallel.mesh import _free_port, launch, make_mesh
    from tpu_unet_torch.serve import AnomalyScorer
    from tpu_unet_torch.train.checkpoint import load_checkpoint
    from tpu_unet_torch.train.steps import AugmentConfig, make_anomaly_train_step

    out, legs = {}, {}
    smi = nvidia_smi_line()
    label = (f"one card ({smi}); ranks share it: not a scaling figure")
    images, masks = _dp_batch(torch)
    b = len(images)

    # --- 13.1: world size 1 over NCCL against the plain step ------------------
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device_type="cuda")
        plain, _ = _dp_state(torch, "bf16", "adam", 1e-3)
        dp, group = _dp_state(torch, "bf16", "adam", 1e-3, mesh)
        plain_step = make_anomaly_train_step(aug_cfg=AugmentConfig())
        dp_step = make_anomaly_train_step(aug_cfg=AugmentConfig(), group=group)
        draws = plain_step.draws(b, torch.Generator(device="cuda").manual_seed(0))
        _zero_launches()
        l_plain = float(plain_step.with_draws(plain, images, masks, draws)["total_loss"])
        l_dp = float(dp_step.with_draws(dp, images, masks, draws)["total_loss"])
        check(abs(l_dp - l_plain) <= DP_LOSS_RTOL * abs(l_plain),
              f"world-size-1 DP loss {l_dp} vs plain {l_plain}")
        times = {}
        for name, st, s in (("plain", plain, plain_step), ("dp_nccl_ws1", dp, dp_step),
                            ("dp_nccl_ws1_again", dp, dp_step), ("plain_again", plain,
                                                                 plain_step)):
            times[name] = _dp_step_ms(torch, s, st, images, masks,
                                      torch.Generator(device="cuda").manual_seed(1))
        prof = device_breakdown(torch, lambda: dp_step(
            dp, images, masks, torch.Generator(device="cuda").manual_seed(1)), n_calls=3,
            top=12, category=_train_category)
        legs["dp_train_ws1_nccl"] = _launches()
        check(legs["dp_train_ws1_nccl"] == {"normalize_u8": 0, "conv3x3_int8": 0},
              f"the DP train step launched {legs['dp_train_ws1_nccl']}")
        del plain, dp
        torch.cuda.empty_cache()
        # The world-size-1 f32 SGD step the two ranks are held against.
        ref, group = _dp_state(torch, "f32", "sgd", 1e-2, mesh)
        before = _cpu_state_dict(ref)
        step = make_anomaly_train_step(aug_cfg=AugmentConfig(), group=group)
        ref_losses = step.with_draws(ref, images, masks, step.draws(
            b, torch.Generator(device="cuda").manual_seed(0)))
        ref_sd = _cpu_state_dict(ref)
        del ref
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    cost = 100 * (0.5 * (times["dp_nccl_ws1"] + times["dp_nccl_ws1_again"])
                  / (0.5 * (times["plain"] + times["plain_again"])) - 1)
    print(f"[dp] flagship step (AnomalyUNet base 64, bf16, 256², b{b}, Adam) at world size 1 "
          f"over NCCL (sync BN, gradient all-reduce): {times['dp_nccl_ws1']:.3f} / "
          f"{times['dp_nccl_ws1_again']:.3f} ms per step against the plain step's "
          f"{times['plain']:.3f} / {times['plain_again']:.3f} ms in this phase (phase 6: "
          f"{report['train']['step_ms']:.3f} ms), {cost:+.1f}%; first-step loss "
          f"{l_dp:.6f} vs plain {l_plain:.6f} (rel {abs(l_dp - l_plain) / l_plain:.2e}, "
          f"tol {DP_LOSS_RTOL}); {label}", flush=True)
    print(f"[profile] DP step at world size 1, 3 steps back to back, per step: device busy "
          f"{prof['device_busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall (profiled), idle "
          f"share {prof['idle_share']:.4f}; by category: "
          + ", ".join(f"{c} {ms:.3f} ms" for c, ms in
                      sorted(prof["by_category_ms"].items(), key=lambda kv: -kv[1])),
          flush=True)
    for k, ms, n in prof["top_kernels_ms"]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<4d} {k}")
    out["ws1_nccl"] = {"step_ms": times, "dp_cost_pct": cost, "loss_dp": l_dp,
                       "loss_plain": l_plain, "device_breakdown": prof}

    # --- 13.2 / 13.3: two ranks sharing the card over gloo -------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=keep)
    t0 = time.perf_counter()
    r0 = launch(_dp_rank, (keep, work), devices=["cuda:0", "cuda:0"], backend="gloo")
    launch_s = time.perf_counter() - t0
    errs = (_update_err(r0["sgd"], ref_sd, before), _state_dict_errs(r0["sgd"], ref_sd)[1])
    check(errs[0] <= DP_UPDATE_TOL and errs[1] <= DP_STAT_TOL,
          f"2-rank f32 SGD step vs world size 1: the update {errs[0]:.2e} (tol "
          f"{DP_UPDATE_TOL}), BN statistics {errs[1]:.2e} (tol {DP_STAT_TOL})")
    for k, v in r0["sgd_losses"].items():
        check(abs(v - float(ref_losses[k])) <= 1e-5 * abs(float(ref_losses[k])) + 1e-7,
              f"2-rank f32 loss {k} {v} vs world size 1 {float(ref_losses[k])}")
    print(f"[dp] two ranks sharing cuda:0 over gloo, one f32 SGD step (base 64, 256², global "
          f"batch {b}, 8 per rank) against world size 1 on the same batch and draws: the "
          f"update {errs[0]:.2e} (rel L2, tol {DP_UPDATE_TOL}), BN statistics {errs[1]:.2e} of "
          f"each leaf's largest (tol {DP_STAT_TOL}); losses within 1e-5; launch and run "
          f"{launch_s:.1f} s", flush=True)
    # FSDP against plain DP at FSDP_BASE, in a launch of its own: one f32 SGD
    # and one f32 Adam step (fused on CUDA) each way from the same state,
    # batch and draws, then the flagship's ms and bytes under FSDP. A rank
    # that fails fails the run.
    t0 = time.perf_counter()
    fsdp = launch(_fsdp_rank, (FSDP_BASE,), devices=["cuda:0", "cuda:0"], backend="gloo")
    fsdp_s = time.perf_counter() - t0
    r0["timing"]["fsdp"] = fsdp["timing"]
    fsdp_errs = {}
    for opt in ("sgd", "adam"):
        (got, got_l), (want, want_l) = fsdp[opt, True], fsdp[opt, False]
        fsdp_errs[opt] = (_update_err(got, want, fsdp["before"]),
                          _state_dict_errs(got, want)[1])
        check(fsdp_errs[opt][0] <= DP_UPDATE_TOL and fsdp_errs[opt][1] <= DP_STAT_TOL,
              f"FSDP vs DP, {opt}, base {FSDP_BASE}: the update {fsdp_errs[opt][0]:.2e}, BN "
              f"statistics {fsdp_errs[opt][1]:.2e}")
        for k, v in got_l.items():
            check(abs(v - want_l[k]) <= 1e-5 * abs(want_l[k]) + 1e-7,
                  f"FSDP {opt} loss {k} {v} vs DP {want_l[k]}")
    print(f"[dp] --fsdp on two ranks sharing cuda:0 over gloo at base {FSDP_BASE} (the "
          f"flagship's geometry), against plain DP on the same batch and draws: f32 SGD the "
          f"update {fsdp_errs['sgd'][0]:.2e} (rel L2), BN statistics {fsdp_errs['sgd'][1]:.2e}; "
          f"f32 Adam (fused) the update {fsdp_errs['adam'][0]:.2e}, BN statistics "
          f"{fsdp_errs['adam'][1]:.2e} (tol {DP_UPDATE_TOL}, {DP_STAT_TOL}); losses within "
          f"1e-5; launch and run {fsdp_s:.1f} s", flush=True)
    for name, t in r0["timing"].items():
        print(f"[dp] flagship step bf16 Adam, {name}, 2 ranks sharing cuda:0 (gloo), global "
              f"batch {b}: {t['step_ms']:.3f} ms per step; state {t['state_bytes'] / 1e6:.1f} "
              f"MB per rank (the JAX placement {t['jax_placement_bytes'] / 1e6:.1f} MB), "
              f"sharded fraction {t['sharded_fraction']:.4f}; {label}", flush=True)

    # test_mvtec int8 on two ranks against one process, bit for bit.
    test = r0["test"]
    n_batches = test["n_batches"]
    for part in test["per_rank"]:
        c = part["launches"]
        want = {"normalize_u8": n_batches + 64 // 16, "conv3x3_int8": 26 * n_batches}
        check(c == want, f"DP test int8 rank launched {c} (want {want})")
    for i, part in enumerate(test["per_rank"]):
        legs[f"dp_test_int8_rank{i}"] = part["launches"]
    flags = ["--data_root", os.path.join(keep, "bottle"), "--category", "bottle",
             "--base_features", "64", "--image_size", "256", "--batch_size", "16",
             "--num_workers", "4", "--device", "cuda", "--precision", "bf16",
             "--checkpoint", os.path.join(keep, "mvtec_best_model.pth"),
             "--output_dir", os.path.join(work, "test1")]
    targs = test_mvtec.parse_args(flags)
    test_ds = MVTecDataset(targs.data_root, "bottle", "test", 256, is_train=False)
    dev = torch.device("cuda")
    state, _ = test_mvtec.load_model(targs, dev)
    # Rank 0's qparams (every rank takes them): a calibration on CUDA can
    # differ by an ulp from process to process.
    eval_step = QuantizedEvalStep(make_quantized_anomaly_eval_step(),
                                  tree_to(test["qparams"], dev))
    one = test_mvtec.test_model(eval_step, state, test_mvtec.make_test_loader(targs, test_ds,
                                                                              dev))
    ev = test_mvtec.evaluate_results(one, targs.pixel_thresholds, targs.threshold)
    del state, eval_step
    check(test["paths"] == one["image_paths"], "DP test: image order differs")
    check(np.array_equal(test["scores"], one["anomaly_scores"]),
          "DP test int8 scores differ from one process's")
    check(test["auroc"] == ev["image_metrics"]["auroc"], "DP test AUROC differs")
    print(f"[dp] test_mvtec --quantize int8 on phase 8's best_model.pth over 2 gloo ranks: "
          f"{len(test['scores'])} scores bit for bit one process's, AUROC "
          f"{test['auroc']:.6f} identical; per rank K1 "
          f"{test['per_rank'][0]['launches']['normalize_u8']}x, K2 "
          f"{test['per_rank'][0]['launches']['conv3x3_int8']}x for {n_batches} batches of 8 "
          f"rows (+ 4 calibration chunks); test_model "
          + "/".join(f"{p['test_model_s']:.2f}" for p in test["per_rank"]) + " s", flush=True)

    # --- 13.4: the 2-rank .pth at world size 1 --------------------------------
    pth = os.path.join(work, "dp_adam.pth")
    state, _ = _dp_state(torch, "bf16", "adam", 1e-3)
    state, epoch, _ = load_checkpoint(state, pth)
    adam = int(next(iter(state.optimizer.state.values()))["step"])
    want_steps = r0["timing"]["dp"]["adam_steps"]
    check(epoch == 3 and adam == want_steps, f"resumed epoch {epoch}, Adam step {adam}")
    make_anomaly_train_step(aug_cfg=AugmentConfig())(
        state, images, masks, torch.Generator(device="cuda").manual_seed(2))
    adam2 = int(next(iter(state.optimizer.state.values()))["step"])
    check(adam2 == want_steps + 1, f"Adam step after resuming {adam2}")
    print(f"[dp] the 2-rank checkpoint ({os.path.getsize(pth) / 1e6:.0f} MB, written by rank "
          f"0) loads strict at world size 1: epoch {epoch}, Adam step {adam} -> {adam2} "
          f"after one more step", flush=True)
    del state
    torch.cuda.empty_cache()

    # --- 13.5: AnomalyScorer int8 b128 with two replicas on the card ---------
    sd = warm_anomaly_state_dict(torch)
    calib = synth_images(torch, 32, 256, 140, "cuda")
    single = AnomalyScorer.from_state_dict(sd, quantize="int8", calib_images=calib,
                                           batch_size=128, device="cuda")
    double = AnomalyScorer.from_state_dict(sd, quantize="int8", qparams=single.qparams,
                                           batch_size=128, devices=("cuda:0", "cuda:0"))
    served = synth_images(torch, 256, 256, 141, "cuda")
    want = single.score_array(served)
    _zero_launches()
    got = double.score_array(served)
    legs["dp_serve_int8_2_replicas"] = _launches()
    check(legs["dp_serve_int8_2_replicas"] == {"normalize_u8": 4, "conv3x3_int8": 72},
          f"2 replicas, 2 batches launched {legs['dp_serve_int8_2_replicas']}")
    check(np.array_equal(got, want), "2 replicas' int8 scores differ from one engine's")
    print(f"[dp] AnomalyScorer int8 b128 with devices=('cuda:0', 'cuda:0'): 256 scores bit "
          f"for bit the single engine's; K1 2x and K2 36x per batch (one per replica)",
          flush=True)
    out.update(two_ranks={"sgd_update_err": errs[0], "sgd_stat_err": errs[1],
                          "fsdp_base": FSDP_BASE, "fsdp_errs": fsdp_errs, "fsdp_s": fsdp_s,
                          "timing": r0["timing"], "launch_s": launch_s,
                          "test_auroc": test["auroc"], "test_per_rank": test["per_rank"]},
               resume={"epoch": epoch, "adam_step": [adam, adam2]}, nvidia_smi=smi)
    report["main_path"]["dp"] = out
    shutil.rmtree(work, ignore_errors=True)
    return legs, {"before": before, "ref_sd": ref_sd,
                  "ref_losses": {k: float(v) for k, v in ref_losses.items()}}


# Phase 14: tensor parallelism over 'model' and artifacts for more than one
# platform. The seg and attention legs run at a reduced width on Gear's 512²
# batch of 8; the CLI leg at full width on phase 8's bottle tree.
TP_SEG_BASE = 16
# Timed bf16 Adam steps under TP (after one warm-up): gloo stages every
# activation's all-reduce through the host, seconds per step.
TP_STEPS = 1
# The CLI leg's epoch: train_mvtec's --debug subset of phase 8's tree.
TP_CLI_SAMPLES = 32


def _tp_setup(torch, n_data):
    """A (n_data, 1, 2) mesh over this launch's gloo ranks on cuda:0 and this
    data rank's rows of phase 13's batch."""
    from tpu_unet_torch.parallel.mesh import make_mesh, shard_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return make_mesh(n_data, n_model=2, device_type="cuda"), shard_batch(_dp_batch(torch))


def _tp_rank():
    """Phase 14 on one of two ranks sharing cuda:0 over gloo, a (1, 1, 2)
    mesh: the f32 SGD step, then the bf16 Adam flagship's ms and bytes per
    rank and the eval step on its state."""
    import torch
    import torch.distributed as dist

    mesh, local = _tp_setup(torch, 1)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    out = {}
    out["sgd"], out["sgd_losses"] = _dp_one_step(torch, mesh, local, False, "sgd", 64, tp=True)
    say("[tp] rank 0: the f32 SGD step ran", flush=True)
    out["timing"] = _dp_flagship(torch, mesh, local, fsdp=False, base=64, tp=True,
                                 evaluate=True, steps=TP_STEPS)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, out["timing"]["eval"])
    out["eval_per_rank"] = parts
    return out


def _tp_fsdp_rank(base):
    """Four ranks sharing cuda:0 over gloo, a (2, 1, 2) mesh with FSDP over
    'data': one f32 SGD step at ``base``; rank 0's whole state, the losses,
    and the state's bytes per rank beside the JAX placement's."""
    import torch

    from tpu_unet_torch.parallel.fsdp import per_device_state_bytes
    from tpu_unet_torch.parallel.tensor import jax_placement_bytes
    from tpu_unet_torch.train.steps import AugmentConfig, make_anomaly_train_step

    mesh, local = _tp_setup(torch, 2)
    state, group = _dp_state(torch, "f32", "sgd", 1e-2, mesh, True, base, True)
    step = make_anomaly_train_step(aug_cfg=AugmentConfig(), group=group)
    draws = step.draws(len(local[0]), torch.Generator(device="cuda").manual_seed(0))
    losses = step.with_draws(state, *local, draws)
    return {"sd": _cpu_state_dict(state), "losses": {k: float(v) for k, v in losses.items()},
            "bytes": per_device_state_bytes(state),
            "jax_bytes": jax_placement_bytes(state, 2, fsdp=True)}


def _gear_batch(torch, n=8, size=512):
    """Gear's train batch: seeded textures and 4-class label maps."""
    images = torch.from_numpy(synth_images(torch, n, size, 150, "cuda")).cuda()
    a, b = synth_masks(torch, n, size, 151, "cuda"), synth_masks(torch, n, size, 152, "cuda")
    return images, (a + 2 * b).clamp(max=3)[..., 0].to(torch.uint8)


def _tp_segs(names, base, n_model):
    """:func:`_tp_seg` of each of ``names``."""
    return {name: _tp_seg(name, base, n_model) for name in names}


def _tp_seg(name, base, n_model, n_space=1):
    """One f32 SGD seg step (dropout drawn from the global batch's
    generator) of ``name`` at ``base`` on Gear's batch, on a (1, ``n_space``,
    ``n_model``) mesh (1, 1: this process alone); the whole state before and
    after, the losses and confusion matrix, and the logits it counts (the
    whole images' under 'space')."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_unet_torch.core.precision import get_policy
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.parallel.fsdp import shard_state
    from tpu_unet_torch.parallel.mesh import group_of, make_mesh, model_rank
    from tpu_unet_torch.parallel.spatial import mesh_exchanger
    from tpu_unet_torch.train import steps
    from tpu_unet_torch.train.state import create_train_state
    from tpu_unet_torch.train.steps import AugmentConfig, make_seg_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = (make_mesh(1, n_space=n_space, n_model=n_model, device_type="cuda")
            if n_model * n_space > 1 else None)
    torch.manual_seed(4)
    model = build_model(name, n_classes=4, base_features=base, policy=get_policy("f32"))
    state = create_train_state(model, "sgd", 1e-2, 1e-4, device="cuda")
    before = _cpu_state_dict(state)
    state = shard_state(mesh, state, tp=n_model > 1)
    images, labels = _gear_batch(torch)
    step = make_seg_train_step(4, aug_cfg=AugmentConfig(), group=group_of(mesh),
                               space=mesh_exchanger(mesh))
    augment, dropout = step.draws(state.model, len(images),
                                  torch.Generator(device="cuda").manual_seed(0))
    with _keeping_logits(steps, "sliced_argmax") as logits:
        losses, cm = step.with_draws(state, images, labels, augment, dropout)
    logits = logits[0]
    if n_space > 1:  # ranks (s, m) in rank order: model rank 0's rows of each s
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, (model_rank(), logits))
        logits = np.concatenate([x for m, x in parts if m == 0], axis=1)
    return {"before": before, "sd": _cpu_state_dict(state), "cm": cm.cpu().numpy(),
            "losses": {k: float(v) for k, v in losses.items()}, "logits": logits,
            "dropped": float((~dropout[0]).float().mean())}


def _tp_cli_rank(keep, work, flags):
    """train_mvtec.train with ``--n_model 2`` on phase 8's bottle tree, on
    one of two ranks sharing cuda:0; the results and the experiment
    directory."""
    import torch

    from tpu_unet_torch.cli import train_mvtec
    from tpu_unet_torch.cli.train_mvtec import _Subset
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.parallel.mesh import synced_timestamp

    args = train_mvtec.parse_args(flags)
    root = os.path.join(keep, "bottle")
    train_ds = MVTecDataset(root, "bottle", "train", args.image_size, is_train=True)
    val_ds = MVTecDataset(root, "bottle", "test", args.image_size, is_train=False)
    if args.debug:  # as train_mvtec's _train_rank
        train_ds = _Subset(train_ds, args.debug_samples, args.seed)
        val_ds = _Subset(val_ds, args.debug_samples, args.seed + 1)
    exp = os.path.join(work, f"bottle_tp_{synced_timestamp()}")
    _zero_launches()
    t0 = time.perf_counter()
    results = train_mvtec.train(args, train_ds, val_ds, torch.device("cuda"), exp)
    torch.cuda.synchronize()
    return {"results": results, "exp": exp, "seconds": time.perf_counter() - t0,
            "launches": _launches()}


def _tp_legs(torch, np, out, legs, keep, dp_ref, label):
    """Phase 14's tensor-parallel legs (module docstring, phase 14)."""
    from tpu_unet_torch.cli import test_mvtec
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.parallel.mesh import launch

    two, four = ["cuda:0"] * 2, ["cuda:0"] * 4
    before, ref_sd, ref_losses = dp_ref["before"], dp_ref["ref_sd"], dp_ref["ref_losses"]

    # --- 14.1: the flagship on a (1, 1, 2) mesh --------------------------------
    t0 = time.perf_counter()
    r0 = launch(_tp_rank, (), devices=two, backend="gloo")
    tp_s = time.perf_counter() - t0
    errs = (_update_err(r0["sgd"], ref_sd, before), _state_dict_errs(r0["sgd"], ref_sd)[1])
    check(errs[0] <= DP_UPDATE_TOL and errs[1] <= DP_STAT_TOL,
          f"TP f32 SGD step vs world size 1: the update {errs[0]:.2e} (tol {DP_UPDATE_TOL}), "
          f"BN statistics {errs[1]:.2e} (tol {DP_STAT_TOL})")
    for k, v in r0["sgd_losses"].items():
        check(abs(v - ref_losses[k]) <= 1e-5 * abs(ref_losses[k]) + 1e-7,
              f"TP f32 loss {k} {v} vs world size 1 {ref_losses[k]}")
    t = r0["timing"]
    for i, ev in enumerate(r0["eval_per_rank"]):
        check(ev["launches"] == {"normalize_u8": 1, "conv3x3_int8": 0} and ev["finite"]
              and ev["rows"] == 16, f"TP eval step on rank {i}: {ev}")
        legs[f"tp_eval_rank{i}"] = ev["launches"]
    print(f"[tp] AnomalyUNet base 64 on a (1, 1, 2) mesh, two gloo ranks sharing cuda:0, "
          f"one f32 SGD step (256², batch 16, the default augment) against phase 13's world "
          f"size 1 on the same batch and draws: the update {errs[0]:.2e} (rel L2, tol "
          f"{DP_UPDATE_TOL}), BN statistics {errs[1]:.2e} (tol {DP_STAT_TOL}), losses within "
          f"1e-5", flush=True)
    print(f"[tp] flagship step bf16 Adam under TP: {t['step_ms']:.3f} ms per step; state "
          f"{t['state_bytes'] / 1e6:.1f} MB per rank (the JAX placement on the same mesh "
          f"{t['jax_placement_bytes'] / 1e6:.1f} MB; sharded fraction "
          f"{t['sharded_fraction']:.4f}); the eval step on its state: K1 once per rank, "
          f"16 rows, loss {t['eval']['loss']:.6f}; launch and run {tp_s:.1f} s; {label}",
          flush=True)

    # --- 14.2: TP with FSDP over 'data' on a (2, 1, 2) mesh ---------------------
    t0 = time.perf_counter()
    both = launch(_tp_fsdp_rank, (FSDP_BASE,), devices=four, backend="gloo")
    both_s = time.perf_counter() - t0
    both_errs = (_update_err(both["sd"], ref_sd, before),
                 _state_dict_errs(both["sd"], ref_sd)[1])
    check(both_errs[0] <= DP_UPDATE_TOL and both_errs[1] <= DP_STAT_TOL,
          f"TP+FSDP vs world size 1: the update {both_errs[0]:.2e}, BN statistics "
          f"{both_errs[1]:.2e}")
    for k, v in both["losses"].items():
        check(abs(v - ref_losses[k]) <= 1e-5 * abs(ref_losses[k]) + 1e-7,
              f"TP+FSDP loss {k} {v} vs world size 1 {ref_losses[k]}")
    print(f"[tp] --n_model 2 --fsdp on a (2, 1, 2) mesh, four gloo ranks sharing cuda:0, "
          f"base {FSDP_BASE}: one f32 SGD step against world size 1, the update "
          f"{both_errs[0]:.2e}, BN statistics {both_errs[1]:.2e}, losses within 1e-5; f32 SGD "
          f"state {both['bytes'] / 1e6:.1f} MB per rank (the JAX placement "
          f"{both['jax_bytes'] / 1e6:.1f} MB); launch and run {both_s:.1f} s", flush=True)

    # --- 14.3: the seg step with dropout and the attention UNet ------------------
    seg, names = {}, ("seg_unet", "attn_unet")
    ones = _tp_segs(names, TP_SEG_BASE, 1)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tps = launch(_tp_segs, (names, TP_SEG_BASE, 2), devices=two, backend="gloo")
    seg_s = time.perf_counter() - t0
    for name in names:
        one, tp = ones[name], tps[name]
        e = (_update_err(tp["sd"], one["sd"], one["before"]),
             _state_dict_errs(tp["sd"], one["sd"])[1])
        check(e[0] <= DP_UPDATE_TOL and e[1] <= DP_STAT_TOL,
              f"TP {name} seg step vs world size 1: the update {e[0]:.2e}, BN statistics "
              f"{e[1]:.2e}")
        for k, v in tp["losses"].items():
            check(abs(v - one["losses"][k]) <= 1e-5 * abs(one["losses"][k]) + 1e-7,
                  f"TP {name} loss {k} {v} vs world size 1 {one['losses'][k]}")
        check(np.array_equal(tp["cm"], one["cm"]) or
              np.abs(tp["cm"] - one["cm"]).sum() <= 1e-5 * one["cm"].sum(),
              f"TP {name} confusion matrix differs")
        seg[name] = {"update_err": e[0], "stat_err": e[1], "launch_s": seg_s,
                     "cm_equal": bool(np.array_equal(tp["cm"], one["cm"])),
                     "dropped": tp["dropped"]}
        print(f"[tp] {name} base {TP_SEG_BASE}, Gear 512² batch 8, one f32 SGD seg step on a "
              f"(1, 1, 2) mesh (two gloo ranks on cuda:0; dropout dropped "
              f"{tp['dropped']:.3f} of the first microbatch's bottleneck channels) against "
              f"world size 1: the update {e[0]:.2e}, BN statistics {e[1]:.2e}, losses within "
              f"1e-5, confusion matrix {'equal' if seg[name]['cm_equal'] else 'within 1e-5'}",
              flush=True)

    # --- 14.4: train_mvtec --n_model 2, then test_mvtec bf16 on its checkpoint ---
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=keep)
    flags = ["--data_root", os.path.join(keep, "bottle"), "--category", "bottle",
             "--base_features", "64", "--image_size", "256", "--batch_size", "16",
             "--num_workers", "4", "--device", "cuda", "--precision", "bf16", "--epochs", "1",
             "--val_freq", "1", "--n_model", "2", "--progress_every", "0",
             "--debug", "--debug_samples", str(TP_CLI_SAMPLES), "--save_dir", work]
    cli = launch(_tp_cli_rank, (keep, work, flags), devices=two, backend="gloo")
    best = os.path.join(cli["exp"], "checkpoints", "best_model.pth")
    blob = torch.load(best, map_location="cpu", weights_only=True)
    build_model("anomaly_unet", base_features=64).load_state_dict(blob["model_state_dict"],
                                                                   strict=True)
    check(cli["launches"]["conv3x3_int8"] == 0, f"TP CLI launched {cli['launches']}")
    legs["tp_cli_train_rank0"] = cli["launches"]
    targs = test_mvtec.parse_args(flags[:16] + ["--checkpoint", best,
                                                "--output_dir", os.path.join(work, "test")])
    test_ds = MVTecDataset(targs.data_root, "bottle", "test", 256, is_train=False)
    dev = torch.device("cuda")
    _zero_launches()
    t0 = time.perf_counter()
    loader = test_mvtec.make_test_loader(targs, test_ds, dev)
    state, eval_step = test_mvtec.load_model(targs, dev)
    res = test_mvtec.test_model(eval_step, state, loader)
    ev = test_mvtec.evaluate_results(res, targs.pixel_thresholds, targs.threshold)
    test_s = time.perf_counter() - t0
    legs["tp_cli_test_bf16"] = _launches()
    check(legs["tp_cli_test_bf16"] == {"normalize_u8": len(loader), "conv3x3_int8": 0}
          and np.isfinite(res["anomaly_scores"]).all(),
          f"test_mvtec bf16 on the TP checkpoint: {legs['tp_cli_test_bf16']}")
    del state, eval_step
    r = cli["results"]
    print(f"[tp] train_mvtec.train --n_model 2 (two gloo ranks on cuda:0, AnomalyUNet base 64, "
          f"bf16, 256², b16) one epoch of --debug_samples {TP_CLI_SAMPLES} of phase 8's bottle "
          f"tree (train and validation): {cli['seconds']:.1f} s "
          f"(train loss {r['train_losses'][0]:.4f}, val loss {r['val_losses'][0]:.4f}); its "
          f"best_model.pth ({os.path.getsize(best) / 1e6:.0f} MB) loads strict at world size "
          f"1; test_mvtec bf16 on it: {len(res['anomaly_scores'])} scores, AUROC "
          f"{ev['image_metrics']['auroc']:.6f}, K1 {legs['tp_cli_test_bf16']['normalize_u8']}x "
          f"for {len(loader)} batches, {test_s:.1f} s", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    out["tp"] = {"sgd_update_err": errs[0], "sgd_stat_err": errs[1], "timing": t,
                 "launch_s": tp_s, "tp_fsdp": {"update_err": both_errs[0],
                                                "stat_err": both_errs[1], "bytes": both["bytes"],
                                                "jax_bytes": both["jax_bytes"],
                                                "seconds": both_s},
                 "seg": seg, "cli": {"seconds": cli["seconds"], "results": {
                     k: r[k] for k in ("train_losses", "val_losses")},
                     "test_auroc": ev["image_metrics"]["auroc"], "test_s": test_s}}


def _artifact_legs(torch, np, out, legs, tmp):
    """Phase 14's artifacts: serve_mvtec's default engine (AnomalyUNet base
    64, 256², batch 128) in int8 and bf16, with a bucket of 2 beside 128 so
    that the CPU programs run at a size the CPU serves, exported with cuda
    and cpu programs and loaded on each."""
    from tpu_unet_torch.ops.quantize import tree_to
    from tpu_unet_torch.serve import AnomalyScorer
    from tpu_unet_torch.serve_artifact import export_artifact, load_artifact

    sd = warm_anomaly_state_dict(torch)
    calib = synth_images(torch, 32, 256, 140, "cuda")
    served = synth_images(torch, 128, 256, 141, "cuda")
    small = served[:2]
    res = {}
    for prec, kw in (("int8", {"quantize": "int8", "calib_images": calib}),
                     ("bf16", {"precision": "bf16"})):
        live = AnomalyScorer.from_state_dict(sd, batch_size=128, bucket_sizes=(2, 128),
                                             device="cuda", **kw)
        art = os.path.join(tmp, f"artifact_{prec}")
        t0 = time.perf_counter()
        meta = export_artifact(live, art, platforms=["cuda", "cpu"])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gpu, cpu = load_artifact(art, device="cuda"), load_artifact(art, device="cpu")
        load_s = time.perf_counter() - t0
        check(meta["platforms"] == ["cuda", "cpu"], f"artifact platforms {meta['platforms']}")
        want = live.score_array(served)
        _zero_launches()
        got = gpu.score_array(served)
        legs[f"artifact_{prec}_cuda_b128"] = _launches()
        k2 = 18 if prec == "int8" else 0
        check(legs[f"artifact_{prec}_cuda_b128"] == {"normalize_u8": 1, "conv3x3_int8": k2},
              f"{prec} artifact's b128 cuda program launched "
              f"{legs[f'artifact_{prec}_cuda_b128']}")
        check(np.array_equal(got, want), f"{prec} artifact's cuda program differs from the "
                                         f"live engine")
        gpu2, cpu2 = gpu.score_array(small), cpu.score_array(small)
        check(np.array_equal(gpu2, live.score_array(small)),
              f"{prec} artifact's b2 cuda program differs from the live engine")
        # The live engine on the CPU, with the artifact's weights (the
        # engine's own: BN folded, int8 constants of the card's calibration).
        ref = AnomalyScorer.from_state_dict(
            sd, batch_size=2, device="cpu",
            **({"quantize": "int8", "qparams": tree_to(live.qparams, "cpu")}
               if prec == "int8" else {"precision": "bf16"}))
        weights = torch.load(os.path.join(art, "weights.pt"), map_location="cpu",
                             weights_only=True)
        with ref._serving():
            ref._score_fn(torch.from_numpy(small))  # prepares the int8 layers' constants
            with ref._export_state[1](weights):
                live_cpu = ref._score_fn(torch.from_numpy(small)).numpy()
        check(np.array_equal(cpu2, live_cpu),
              f"{prec} artifact's cpu program differs from the live engine on the CPU")
        same = bool(np.array_equal(cpu2, gpu2))
        if prec == "int8":
            check(same, f"int8 artifact: the cpu program's scores {cpu2} differ from the cuda "
                        f"program's {gpu2}")
        res[prec] = {"mb": _dir_mb(art), "export_s": export_s, "load_s": load_s,
                     "cpu_equals_cuda": same,
                     "cpu_vs_cuda_max_rel": float(np.max(np.abs(cpu2 - gpu2) / np.abs(gpu2)))}
        print(f"[artifact] AnomalyScorer {prec} (base 64, 256², buckets 2 and 128), platforms "
              f"cuda and cpu: {res[prec]['mb']:.1f} MB, export {export_s:.1f} s, load (both) "
              f"{load_s:.1f} s; the cuda programs bit for bit the live engine (b128: K1 1x, "
              f"K2 {k2}x); the cpu program bit for bit the live engine on the CPU with the "
              f"same weights; cpu against cuda scores at b2: "
              + ("bit for bit" if same else f"max rel {res[prec]['cpu_vs_cuda_max_rel']:.2e}"),
              flush=True)
        shutil.rmtree(art, ignore_errors=True)
        del live, gpu, cpu, ref
        torch.cuda.empty_cache()
    out["artifacts"] = res


def phase_tp(torch, np, report, tmp, keep, dp_ref):
    """Phase 14: tensor parallelism on the one card (gloo ranks sharing it),
    and serving artifacts with cuda and cpu programs. Returns the launch
    counts."""
    out, legs = {}, {}
    label = f"one card ({nvidia_smi_line()}); ranks share it: not a scaling figure"
    torch.cuda.empty_cache()  # the ranks share the card with this process's cache
    t0 = time.perf_counter()
    _tp_legs(torch, np, out, legs, keep, dp_ref, label)
    _artifact_legs(torch, np, out, legs, tmp)
    out["seconds"] = time.perf_counter() - t0
    report["main_path"]["tp"] = out["tp"]
    report["main_path"]["artifacts"] = out["artifacts"]
    report["main_path"]["tp"]["phase_seconds"] = out["seconds"]
    return legs


# ---------------------------------------------------------------------------
# Phase 15: the 'space' axis on the one card
# ---------------------------------------------------------------------------

# Timed bf16 Adam steps of the KolektorSDD step on the (1, 2, 1) mesh and in
# one process (after one warm-up step each).
SPACE_STEPS = 3
# The CLI leg's --debug subset of phase 9's KolektorSDD tree (train, and the
# test split's evaluation).
SPACE_CLI_SAMPLES = 16
# train_kolektorsdd's defaults: SegmentationUNet base 64, 3 classes, 1024 x
# 512, b8, class weights 1/50/50, dropout 0.1, the KolektorSDD augment.
SPACE_HW = (1024, 512)
# Largest f32 logit difference of phase 15's sharded runs against one
# process, relative to the largest logit: 1.5e-6 to 5.3e-6 on an H100
# (the KolektorSDD step in two runs, the predictor and both Gear steps in
# one), so 1e-4 leaves
# rounding room; a halo fault moves logits by their own size.
SPACE_LOGIT_TOL = 1e-4
# SegmentationPredictor(n_space=2) against one device: f32 (TF32 off) masks
# equal but for ties and mean confidences within SPACE_CONF_RTOL (the CPU
# test's; 6.8e-8 measured twice on an H100); int8 bit for bit. The
# bf16 leg is a secondary check: the share of pixels whose class may differ,
# about 5x what two H100 runs measured (1.88e-4 both). The weights are
# seeded, not trained, so the class logits nearly tie (phase 11's
# SERVE_MAX_DISAGREE), and cuDNN's bf16 algorithms differ between the
# 514-row and 1024-row inputs.
SPACE_CONF_RTOL = 2e-5
SPACE_MAX_DISAGREE = 1e-3


@contextlib.contextmanager
def _keeping_logits(module, name):
    """Within the block, ``module.name`` (a head taking NHWC logits first)
    also keeps a host copy of each call's logits, in the list yielded."""
    kept, fn = [], getattr(module, name)

    def keep(logits, *args, **kwargs):
        kept.append(logits.detach().float().cpu().numpy())
        return fn(logits, *args, **kwargs)

    setattr(module, name, keep)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def _ties_only(np, one, other, what):
    """Hold two runs' f32 NHWC logits of the same batch: their largest
    difference within SPACE_LOGIT_TOL of the largest logit (a halo fault
    moves logits by their own size), and every pixel whose class differs a
    tie at that rounding (its top-two margin in ``one`` within twice that
    difference). Returns the numbers."""
    d_logit = float(np.abs(other - one).max())
    scale = float(np.abs(one).max())
    top2 = np.sort(one, axis=-1)[..., -2:]
    moved = one.argmax(-1) != other.argmax(-1)
    margin = float((top2[..., 1] - top2[..., 0])[moved].max()) if moved.any() else 0.0
    check(d_logit <= SPACE_LOGIT_TOL * scale,
          f"{what}: f32 logits differ by {d_logit:.2e} (largest logit {scale:.2e}, "
          f"tol {SPACE_LOGIT_TOL})")
    check(margin <= 2 * d_logit,
          f"{what}: {int(moved.sum())} pixels changed class, top-two margin up to "
          f"{margin:.2e} against logits {d_logit:.2e} apart")
    return {"logit_max_diff": d_logit, "logit_scale": scale, "moved_pixels": int(moved.sum()),
            "moved_max_margin": margin}


def _tie_note(t):
    return (f"logits within {t['logit_max_diff']:.2e} (largest {t['logit_scale']:.2e}), "
            + ("no pixel changed class" if not t["moved_pixels"] else
               f"{t['moved_pixels']} pixels changed class, each a tie (top-two margin at "
               f"most {t['moved_max_margin']:.2e})"))


def _ksdd_batch(torch, seed):
    """A KolektorSDD batch of 8: seeded textures and 3-class label maps."""
    images = torch.from_numpy(synth_hw(torch, 8, SPACE_HW, seed)).cuda()
    a = synth_masks(torch, 8, SPACE_HW[0], seed + 1, "cuda")[:, :, :SPACE_HW[1]]
    b = synth_masks(torch, 8, SPACE_HW[0], seed + 2, "cuda")[:, :, :SPACE_HW[1]]
    return images, (a + 2 * b).clamp(max=2)[..., 0].to(torch.uint8).contiguous()


def _ksdd_step(torch, precision, opt, lr, mesh=None):
    """train_kolektorsdd's model and seg step from seed 5, placed on
    ``mesh`` (None: this process alone): (state, step)."""
    from tpu_unet_torch.cli.train_kolektorsdd import make_workload
    from tpu_unet_torch.core.precision import get_policy
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.parallel.fsdp import shard_state
    from tpu_unet_torch.parallel.mesh import group_of
    from tpu_unet_torch.parallel.spatial import mesh_exchanger
    from tpu_unet_torch.train.state import create_train_state
    from tpu_unet_torch.train.steps import SegLossConfig, make_seg_train_step

    torch.manual_seed(5)
    model = build_model("seg_unet", n_classes=3, base_features=64, dropout=0.1,
                        policy=get_policy(precision))
    state = shard_state(mesh, create_train_state(model, opt, lr, 1e-4, device="cuda"))
    step = make_seg_train_step(3, SegLossConfig(class_weights=(1.0, 50.0, 50.0)),
                               make_workload().augment, group=group_of(mesh),
                               space=mesh_exchanger(mesh))
    return state, step


def _ksdd_leg(torch, mesh=None):
    """One f32 SGD step of the KolektorSDD step (the state before and
    after, losses, matrix, halo bytes), then the bf16 Adam step's ms per
    step and peak GB on this process's allocator."""
    from tpu_unet_torch.parallel import spatial

    from tpu_unet_torch.train import steps

    images, labels = _ksdd_batch(torch, 160)
    state, step = _ksdd_step(torch, "f32", "sgd", 1e-2, mesh)
    before = _cpu_state_dict(state)
    draws = step.draws(state.model, len(images), torch.Generator(device="cuda").manual_seed(0))
    spatial.COUNTERS.update(exchanges=0, bytes=0)
    with _keeping_logits(steps, "sliced_argmax") as logits:  # what the matrix counts
        losses, cm = step.with_draws(state, images, labels, *draws)
    out = {"before": before, "sd": _cpu_state_dict(state), "cm": cm.cpu().numpy(),
           "losses": {k: float(v) for k, v in losses.items()}, "halo": dict(spatial.COUNTERS),
           "dropped": float((~draws[1][0]).float().mean()), "logits": logits[0]}
    del state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step = _ksdd_step(torch, "bf16", "adam", 1e-3, mesh)
    g = torch.Generator(device="cuda").manual_seed(1)
    float(step(state, images, labels, g)[0]["total_loss"])  # warm-up
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(SPACE_STEPS):
        loss = step(state, images, labels, g)[0]["total_loss"]
    t1.record()
    out["bf16_loss"] = float(loss)
    torch.cuda.synchronize()
    out["bf16_ms"] = t0.elapsed_time(t1) / SPACE_STEPS
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    torch.cuda.empty_cache()
    return out


def _int8_eval(torch, qparams, images, labels, mesh=None):
    """The int8 seg eval step (SegmentationUNet) on ``mesh`` with the launch
    counters zeroed just before and read just after: predictions, matrix,
    losses and launches."""
    from tpu_unet_torch.ops.quantize import make_quantized_seg_eval_step, tree_to
    from tpu_unet_torch.parallel.mesh import group_of
    from tpu_unet_torch.parallel.spatial import mesh_exchanger
    from tpu_unet_torch.train.steps import SegLossConfig

    step = make_quantized_seg_eval_step(3, SegLossConfig(class_weights=(1.0, 50.0, 50.0)),
                                        group=group_of(mesh), space=mesh_exchanger(mesh))
    qparams = tree_to(qparams, "cuda")
    _zero_launches()
    losses, preds, cm = step(qparams, images, labels)
    torch.cuda.synchronize()
    return {"preds": preds.cpu().numpy(), "cm": cm.cpu().numpy(), "launches": _launches(),
            "losses": {k: float(v) for k, v in losses.items()}}


def _space_rank(qparams):
    """Phase 15.1-15.2 on one of two ranks sharing cuda:0 over gloo, a (1,
    2, 1) mesh: the KolektorSDD leg and the int8 eval; rank 0's results,
    with every rank's launches and peak."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_unet_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, n_space=2, device_type="cuda")
    out = _ksdd_leg(torch, mesh)
    out["int8"] = _int8_eval(torch, qparams, *_ksdd_batch(torch, 170), mesh)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {"launches": out["int8"]["launches"], "logits": out["logits"],
                                   "peak_gb": out["peak_gb"], "bf16_ms": out["bf16_ms"]})
    out["logits"] = np.concatenate([p.pop("logits") for p in parts], axis=1)  # whole images
    out["per_rank"] = parts
    return out


def _space_cli_rank(data_root, work, train_flags, test_flags):
    """train_seg (train_kolektorsdd --n_space 2 on the --debug subset), then
    the test split's evaluation on its last checkpoint in f32 (load_seg_model,
    make_eval_loader, validate_seg_epoch): rank 0's results, metrics and
    launches."""
    import torch

    from tpu_unet_torch.cli import test_kolektorsdd, train_kolektorsdd
    from tpu_unet_torch.cli._seg_common import _Subset, train_seg
    from tpu_unet_torch.parallel.mesh import synced_timestamp

    torch.backends.cudnn.allow_tf32 = False  # the f32 test is held to one process's
    torch.backends.cuda.matmul.allow_tf32 = False
    args = train_kolektorsdd.parse_args(train_flags)
    workload = train_kolektorsdd.make_workload()
    train_ds, val_ds, _, n_classes, _ = workload.make_datasets(args)
    train_ds = _Subset(train_ds, args.debug_samples, args.seed)
    val_ds = _Subset(val_ds, args.debug_samples, args.seed + 1)
    exp = os.path.join(work, f"ksdd_space_{synced_timestamp()}")
    t0 = time.perf_counter()
    results = train_seg(args, workload, train_ds, val_ds, n_classes, torch.device("cuda"), exp)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ckpt = os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth")
    test = _seg_test(torch, test_kolektorsdd.parse_args(test_flags + ["--checkpoint", ckpt]))
    return {"results": results, "ckpt": ckpt, "train_s": train_s, "test": test}


def _seg_test(torch, targs):
    """The seg evaluator's work (run_seg_evaluation without its plots) with
    the launch counters zeroed just before and read just after: the
    metrics, losses, matrix, batches and launches."""
    from tpu_unet_torch.cli import test_kolektorsdd
    from tpu_unet_torch.cli._seg_common import (_Subset, eval_mesh, load_seg_model,
                                                make_eval_loader)
    from tpu_unet_torch.train.loop import validate_seg_epoch

    workload = test_kolektorsdd.make_workload()
    train_ds, _, test_ds, n_classes, _ = workload.make_datasets(targs)
    ds = _Subset(test_ds, targs.debug_samples, 0)
    dev = torch.device("cuda")
    _zero_launches()
    t0 = time.perf_counter()
    mesh = eval_mesh(targs, dev)
    state, eval_step, loss_cfg = load_seg_model(targs, n_classes, dev, train_ds, mesh)
    loader = make_eval_loader(targs, ds, dev, mesh)
    losses, cm = validate_seg_epoch(state, eval_step, loader, n_classes)
    torch.cuda.synchronize()
    metrics = {k: float(v) for k, v in cm.compute_all_metrics().items()
               if getattr(v, "ndim", 0) == 0}
    return {"metrics": metrics, "losses": losses, "cm": cm.confusion_matrix,
            "batches": len(loader), "launches": _launches(),
            "seconds": time.perf_counter() - t0}


def _space_legs(torch, np, out, legs, tmp, label):
    """Phase 15's legs (module docstring, phase 15)."""
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.ops.quantize import chunk_calibration, quantize_from_train_state, tree_to
    from tpu_unet_torch import serve
    from tpu_unet_torch.parallel.mesh import launch
    from tpu_unet_torch.serve import SegmentationPredictor

    two, four = ["cuda:0"] * 2, ["cuda:0"] * 4
    res = {}

    # --- 15.1-15.2: the KolektorSDD step and the int8 eval on (1, 2, 1) --------
    one = _ksdd_leg(torch)
    sd = warm_seg_state_dict(torch, "seg_unet", 3, SPACE_HW)
    calib = synth_hw(torch, 16, SPACE_HW, 171)
    qparams = quantize_from_train_state("seg_unet", sd, chunk_calibration(calib, 8),
                                        device="cuda")
    one_int8 = _int8_eval(torch, qparams, *_ksdd_batch(torch, 170))
    legs["space_int8_eval_one"] = one_int8["launches"]
    check(one_int8["launches"] == {"normalize_u8": 1, "conv3x3_int8": 18},
          f"one-process int8 eval launched {one_int8['launches']}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r0 = launch(_space_rank, (tree_to(qparams, "cpu"),), devices=two, backend="gloo")
    launch_s = time.perf_counter() - t0
    e = (_update_err(r0["sd"], one["sd"], one["before"]),
         _state_dict_errs(r0["sd"], one["sd"])[1])
    check(e[0] <= DP_UPDATE_TOL and e[1] <= DP_STAT_TOL,
          f"space f32 SGD step vs world size 1: the update {e[0]:.2e} (tol {DP_UPDATE_TOL}), "
          f"BN statistics {e[1]:.2e} (tol {DP_STAT_TOL})")
    for k, v in r0["losses"].items():
        check(abs(v - one["losses"][k]) <= 1e-5 * abs(one["losses"][k]) + 1e-7,
              f"space f32 loss {k} {v} vs world size 1 {one['losses'][k]}")
    # The matrix counts each pixel's argmax: equal but for ties.
    ties = _ties_only(np, one["logits"], r0["logits"], "space f32 step vs world size 1")
    cm_moved = int(np.abs(r0["cm"] - one["cm"]).sum())
    check(cm_moved <= 2 * ties["moved_pixels"],
          f"space confusion matrix {r0['cm'].tolist()} vs {one['cm'].tolist()}")
    halo_mb = r0["halo"]["bytes"] / 1e6
    res["ksdd"] = {"update_err": e[0], "stat_err": e[1], "cm_moved": cm_moved, **ties,
                   "losses": r0["losses"], "halo_exchanges": r0["halo"]["exchanges"],
                   "halo_mb_per_rank_step": halo_mb, "launch_s": launch_s,
                   "bf16_ms": [p["bf16_ms"] for p in r0["per_rank"]],
                   "peak_gb": [p["peak_gb"] for p in r0["per_rank"]],
                   "one_bf16_ms": one["bf16_ms"], "one_peak_gb": one["peak_gb"]}
    print(f"[space] train_kolektorsdd's step (SegmentationUNet base 64, 1024 x 512, b8, class "
          f"weights 1/50/50, dropout dropped {r0['dropped']:.3f}) on a (1, 2, 1) mesh of two "
          f"gloo ranks sharing cuda:0, one f32 SGD step against world size 1 on the same batch "
          f"and draws: the update {e[0]:.2e} (rel L2, tol {DP_UPDATE_TOL}), BN statistics "
          f"{e[1]:.2e} (tol {DP_STAT_TOL}), losses within 1e-5, {_tie_note(ties)} of "
          f"{int(one['cm'].sum())} (confusion matrix {'equal' if cm_moved == 0 else 'moved by '
          'those pixels only'}); halo {r0['halo']['exchanges']} "
          f"exchanges, {halo_mb:.2f} MB sent per rank per step (f32)", flush=True)
    print(f"[space] bf16 Adam, {SPACE_STEPS} steps: "
          + ", ".join(f"rank {i} {p['bf16_ms']:.1f} ms per step, peak {p['peak_gb']:.2f} GB"
                      for i, p in enumerate(r0["per_rank"]))
          + f"; one process {one['bf16_ms']:.1f} ms, peak {one['peak_gb']:.2f} GB; {label}",
          flush=True)
    for i, p in enumerate(r0["per_rank"]):
        legs[f"space_int8_eval_rank{i}"] = p["launches"]
        check(p["launches"] == {"normalize_u8": 1, "conv3x3_int8": 18},
              f"space int8 eval on rank {i} launched {p['launches']}")
    q = r0["int8"]
    check(np.array_equal(q["preds"], one_int8["preds"]) and
          np.array_equal(q["cm"], one_int8["cm"]),
          f"space int8 eval differs from one process: "
          f"{int((q['preds'] != one_int8['preds']).sum())} pixels")
    res["int8"] = {"bit_for_bit": True, "launches_per_rank": [p["launches"]
                                                             for p in r0["per_rank"]]}
    print(f"[space] int8 seg eval (SegmentationUNet base 64, 1024 x 512, b8) on (1, 2, 1): "
          f"predictions and matrix bit for bit one process's; per rank K1 1x and K2 18x (on "
          f"514-row halo'd inputs at the top level); launch and run of 15.1-15.2 "
          f"{launch_s:.1f} s", flush=True)
    del one, r0
    torch.cuda.empty_cache()

    # --- 15.3: train_kolektorsdd --n_space 2, then its test -----------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_space_", dir=tmp)
    data_root = os.path.join(tmp, "ksdd")
    common = ["--data_root", data_root, "--debug", "--debug_samples", str(SPACE_CLI_SAMPLES),
              "--num_workers", "4", "--device", "cuda"]
    train_flags = common + ["--epochs", "1", "--val_freq", "1", "--progress_every", "0",
                            "--n_space", "2", "--save_dir", work]
    test_flags = common + ["--precision", "f32", "--batch_size", "8",
                           "--output_dir", os.path.join(work, "test")]
    cli = launch(_space_cli_rank, (data_root, work, train_flags,
                                   test_flags + ["--n_space", "2"]), devices=two, backend="gloo")
    blob = torch.load(cli["ckpt"], map_location="cpu", weights_only=True)
    build_model("seg_unet", n_classes=3, base_features=64).load_state_dict(
        blob["model_state_dict"], strict=True)
    from tpu_unet_torch.cli import test_kolektorsdd
    whole = _seg_test(torch, test_kolektorsdd.parse_args(test_flags + ["--checkpoint",
                                                                       cli["ckpt"]]))
    t = cli["test"]
    legs["space_cli_test_f32"] = t["launches"]
    check(t["launches"] == {"normalize_u8": t["batches"], "conv3x3_int8": 0},
          f"test_kolektorsdd --n_space 2 launched {t['launches']} for {t['batches']} batches")
    worst = max(abs(t["metrics"][k] - v) for k, v in whole["metrics"].items())
    check(worst <= 1e-5, f"test_kolektorsdd --n_space 2 metrics differ from one process's by "
                         f"{worst:.2e}: {t['metrics']} vs {whole['metrics']}")
    r = cli["results"]
    res["cli"] = {"train_s": cli["train_s"], "train_losses": r["train_losses"],
                  "val_losses": r["val_losses"], "metric_max_diff": worst,
                  "cm_equal": bool(np.array_equal(t["cm"], whole["cm"])),
                  "test_s": t["seconds"], "mean_iou": t["metrics"]["mean_iou"]}
    print(f"[space] train_kolektorsdd --n_space 2 (two gloo ranks on cuda:0, defaults: base 64, "
          f"bf16, 1024 x 512, b8) one epoch of --debug_samples {SPACE_CLI_SAMPLES}: "
          f"{cli['train_s']:.1f} s (train loss {r['train_losses'][0]:.4f}, val loss "
          f"{r['val_losses'][0]:.4f}); its .pth loads strict at world size 1; test_kolektorsdd "
          f"--n_space 2 --precision f32 on it ({t['batches']} batches, K1 once per batch per "
          f"rank): metrics within {worst:.1e} of one process's, confusion matrix "
          f"{'equal' if res['cli']['cm_equal'] else 'within the metrics'}, mIoU "
          f"{t['metrics']['mean_iou']:.6f}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # --- 15.4: SegmentationPredictor with n_space=2 in one process ----------------
    images = synth_hw(torch, 8, SPACE_HW, 172)
    kw = dict(num_classes=3, image_size_hw=SPACE_HW, batch_size=8, base_features=64)
    pred = {}
    for prec, extra, k2 in (("int8", {"quantize": "int8", "qparams": qparams}, 18),
                            ("f32", {"precision": "f32"}, 0),
                            ("bf16", {"precision": "bf16"}, 0)):
        single = SegmentationPredictor.from_state_dict(sd, device="cuda", **kw, **extra)
        rows = SegmentationPredictor.from_state_dict(sd, devices=two, n_space=2, **kw, **extra)
        with _keeping_logits(serve, "sliced_pred_confidence") as logits:
            m1, c1 = single.predict_array(images)
            _zero_launches()
            t0 = time.perf_counter()
            m2, c2 = rows.predict_array(images)
            p_s = time.perf_counter() - t0
        legs[f"space_predictor_{prec}"] = _launches()
        want = {"normalize_u8": 2, "conv3x3_int8": 2 * k2}
        check(legs[f"space_predictor_{prec}"] == want,
              f"{prec} predictor n_space=2 launched {legs[f'space_predictor_{prec}']} "
              f"(want {want}: each of the two threads K1 1x, K2 {k2}x)")
        share = float((m1 != m2).mean())
        conf_err = float((np.abs(c2 - c1) / np.abs(c1)).max())
        pred[prec] = {"disagree": share, "conf_rel_err": conf_err, "predict_s": p_s}
        print(f"[space] predictor n_space=2 {prec}: {share:.2e} of pixels differ from one "
              f"device, mean confidences {conf_err:.2e} apart (relative)", flush=True)
        if prec == "int8":
            check(np.array_equal(m1, m2) and np.array_equal(c1, c2),
                  f"int8 predictor n_space=2 differs from one device: {share:.2e} of pixels")
        elif prec == "f32":  # masks equal but for ties at f32 rounding
            pred[prec].update(_ties_only(np, *logits, "f32 predictor n_space=2 vs one device"))
            check(int((m1 != m2).sum()) == pred[prec]["moved_pixels"]
                  and conf_err <= SPACE_CONF_RTOL,
                  f"f32 predictor n_space=2 differs from one device: {share:.2e} of pixels, "
                  f"confidences {conf_err:.2e} (rtol {SPACE_CONF_RTOL})")
        else:
            check(share <= SPACE_MAX_DISAGREE,
                  f"bf16 predictor n_space=2: {share:.2e} of pixels differ from one device "
                  f"(limit {SPACE_MAX_DISAGREE})")
        del single, rows, logits
        torch.cuda.empty_cache()
    res["predictor"] = pred
    print(f"[space] SegmentationPredictor(n_space=2, devices=[cuda:0, cuda:0]) at 1024 x 512 "
          f"b8, base 64, 3 classes: int8 masks and confidences bit for bit one device's (K1 1x "
          f"and K2 18x per thread); f32 (TF32 off): {_tie_note(pred['f32'])}, "
          f"confidences within {pred['f32']['conf_rel_err']:.2e} (rtol {SPACE_CONF_RTOL}); "
          f"bf16 masks differ on "
          f"{pred['bf16']['disagree']:.2e} of pixels (limit {SPACE_MAX_DISAGREE})", flush=True)

    # --- 15.5: the attention UNet on (1, 2, 1), SegmentationUNet on (1, 2, 2) -------
    comp = {}
    for name, n_model, devs in (("attn_unet", 1, two), ("seg_unet", 2, four)):
        ref = _tp_seg(name, TP_SEG_BASE, 1)
        t0 = time.perf_counter()
        got = launch(_tp_seg, (name, TP_SEG_BASE, n_model, 2), devices=devs,
                     backend="gloo")
        c_s = time.perf_counter() - t0
        e = (_update_err(got["sd"], ref["sd"], ref["before"]),
             _state_dict_errs(got["sd"], ref["sd"])[1])
        check(e[0] <= DP_UPDATE_TOL and e[1] <= DP_STAT_TOL,
              f"space {name} (1, 2, {n_model}) vs world size 1: the update {e[0]:.2e}, BN "
              f"statistics {e[1]:.2e}")
        for k, v in got["losses"].items():
            check(abs(v - ref["losses"][k]) <= 1e-5 * abs(ref["losses"][k]) + 1e-7,
                  f"space {name} loss {k} {v} vs world size 1 {ref['losses'][k]}")
        ties = _ties_only(np, ref["logits"], got["logits"], f"space {name} vs world size 1")
        eq = bool(np.array_equal(got["cm"], ref["cm"]))
        check(np.abs(got["cm"] - ref["cm"]).sum() <= 2 * ties["moved_pixels"],
              f"space {name} confusion matrix {got['cm'].tolist()} vs {ref['cm'].tolist()}")
        comp[f"{name}_1x2x{n_model}"] = {"update_err": e[0], "stat_err": e[1], "cm_equal": eq,
                                        "launch_s": c_s, **ties}
        print(f"[space] {name} base {TP_SEG_BASE}, Gear 512² b8, one f32 SGD step on a (1, 2, "
              f"{n_model}) mesh ({len(devs)} gloo ranks on cuda:0) against world size 1: the "
              f"update {e[0]:.2e}, BN statistics {e[1]:.2e}, losses within 1e-5, "
              f"{_tie_note(ties)} (confusion matrix {'equal' if eq else 'moved by those only'});"
              f" launch and run {c_s:.1f} s", flush=True)
    res["compose"] = comp
    out["space"] = res


def phase_space(torch, np, report, tmp):
    """Phase 15: the 'space' axis on the one card (gloo ranks sharing it;
    correctness and memory figures, not scaling). Returns the launch
    counts."""
    out, legs = {}, {}
    label = f"one card ({nvidia_smi_line()}); ranks share it: not a scaling figure"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _space_legs(torch, np, out, legs, tmp, label)
    out["space"]["phase_seconds"] = time.perf_counter() - t0
    report["main_path"]["space"] = out["space"]
    return legs


def _halo_probe_rank(op, dtype_name):
    """One exchange of edge rows (``op`` 'p2p': ``batch_isend_irecv``;
    'all_gather') between two gloo ranks sharing cuda:0 in ``dtype_name``:
    whether the rows arrived."""
    import torch
    import torch.distributed as dist

    r, other = dist.get_rank(), 1 - dist.get_rank()
    dtype = getattr(torch, dtype_name)
    edge = torch.full((2, 64, 1, 512), r + 1, device="cuda").to(dtype)
    if op == "p2p":
        got = torch.empty_like(edge)
        ops = [dist.P2POp(dist.isend, edge, other), dist.P2POp(dist.irecv, got, other)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return bool((got.float() == other + 1).all())
    parts = [torch.empty_like(edge) for _ in range(2)]
    dist.all_gather(parts, edge)
    return all(bool((p.float() == i + 1).all()) for i, p in enumerate(parts))


HALO_PROBES = [(op, dt) for op in ("p2p", "all_gather")
               for dt in ("float32", "bfloat16", "int8")]


def halo_probe():
    """``python3 chip_smoke.py halo_probe``: each of HALO_PROBES in a child
    process with a time limit (a crash in gloo does not take this process
    with it): its exit code and the end of its output."""
    for probe in HALO_PROBES:
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "halo_probe_run",
                                *probe], capture_output=True, text=True, timeout=120)
            rc, tail = r.returncode, " ".join((r.stdout + r.stderr).split())[-240:]
        except subprocess.TimeoutExpired:
            rc, tail = "timeout", ""
        print(f"[halo-probe] {probe}: rc {rc} in {time.perf_counter() - t0:.1f} s: {tail}",
              flush=True)
    return 0


def halo_probe_run(op, dtype_name):
    from tpu_unet_torch.parallel.mesh import launch
    ok = launch(_halo_probe_rank, (op, dtype_name), devices=["cuda:0", "cuda:0"],
                backend="gloo")
    print(f"{op} of {dtype_name} edge rows over gloo on cuda:0: rows arrived {ok}", flush=True)
    return 0


# FSDP widths (``python3 chip_smoke.py fsdp_widths``): does FSDP2 over two
# gloo ranks run at the flagship's geometry? (device, base_features, rows
# per rank, image size), each in a process of its own with a time limit.
FSDP_PROBES = [("cuda", 64, 8, 256), ("cuda", 32, 8, 256), ("cuda", 16, 8, 256),
               ("cuda", 8, 8, 256), ("cuda", 64, 2, 64), ("cpu", 64, 2, 64)]


def _fsdp_width_rank(device_type, base, per_rank, size):
    """One f32 SGD step and one Adam step (fused on CUDA) of AnomalyUNet at
    ``base`` under FSDP2 on this rank; the losses."""
    import torch
    import torch.distributed as dist

    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.parallel.fsdp import shard_state
    from tpu_unet_torch.parallel.mesh import group_of, make_mesh, shard_batch
    from tpu_unet_torch.train.state import create_train_state
    from tpu_unet_torch.train.steps import AugmentConfig, make_anomaly_train_step

    dev = "cuda" if device_type == "cuda" else "cpu"
    n = per_rank * dist.get_world_size()
    images = torch.from_numpy(synth_images(torch, n, size, 130, dev)).to(dev)
    masks = synth_masks(torch, n, size, 131, dev)
    mesh = make_mesh(dist.get_world_size(), device_type=dev)
    local = shard_batch((images, masks))
    out = {}
    for opt, lr in (("sgd", 1e-2), ("adam", 1e-3)):
        torch.manual_seed(3)
        model = build_model("anomaly_unet", base_features=base)
        state = shard_state(mesh, create_train_state(model, opt, lr, 1e-4, device=dev),
                            fsdp=True)
        step = make_anomaly_train_step(aug_cfg=AugmentConfig(), group=group_of(mesh))
        out[opt] = float(step(state, *local, torch.Generator(device=dev).manual_seed(0))
                         ["total_loss"])
    return out


def fsdp_widths():
    """Each of FSDP_PROBES in a child process: its exit code and the end of
    its output."""
    for probe in FSDP_PROBES:
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "fsdp_width",
                                *map(str, probe)], capture_output=True, text=True,
                               timeout=240)
            rc, tail = r.returncode, " ".join((r.stdout + r.stderr).split())[-300:]
        except subprocess.TimeoutExpired:
            rc, tail = "timeout", ""
        print(f"[fsdp-width] {probe}: rc {rc} in {time.perf_counter() - t0:.1f} s: {tail}",
              flush=True)
    return 0


def fsdp_width(device_type, base, per_rank, size):
    from tpu_unet_torch.parallel.mesh import launch
    dev = "cuda:0" if device_type == "cuda" else "cpu"
    res = launch(_fsdp_width_rank, (device_type, int(base), int(per_rank), int(size)),
                 devices=[dev, dev], backend="gloo")
    print(f"FSDP ran: losses {res}", flush=True)
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cudnn.allow_tf32 = False  # f32 means f32 in every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    warm_clocks(torch)
    report = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    seconds = report["phase_seconds"] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0
            print(f"[time] {name}: {seconds[name]:.1f} s", flush=True)

    timed("1 build", phase_build, report)
    timed("2 K1", phase_k1, torch, report)
    timed("3 K2", phase_k2, torch, report)
    launches = timed("4-5 serving", phase_main_path, torch, np, report)
    path_launches = {"serve": launches, **timed("6 train", phase_train, torch, np, report)}
    timed("7 train cpu vs card", phase_train_cpu_vs_card, torch, np, report)
    # Phases 8-10 decode without a pack (their cold epochs measure decoding);
    # phase 12 sets its own pack directory under TMPDIR. Nothing is written
    # under the user's cache.
    os.environ["TPU_UNET_DATA_CACHE"] = ""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seg_")
    keep = os.path.join(tmp, "keep")  # phases 8-10's trees and checkpoints for phase 12
    os.makedirs(keep)
    try:
        path_launches.update(timed("8 mvtec", phase_mvtec, torch, np, report, keep))
        path_launches.update(timed("9 seg", phase_seg, torch, np, report, tmp, keep))
        path_launches.update(timed("10 extensions", phase_extensions, torch, np, report, tmp,
                                   keep))
        path_launches.update(timed("11 serving surface", phase_serving, torch, np, report,
                                   tmp))
        path_launches.update(timed("12 host data", phase_host_data, torch, np, report, tmp,
                                   keep))
        dp_legs, dp_ref = timed("13 dp", phase_dp, torch, np, report, keep)
        path_launches.update(dp_legs)
        path_launches.update(timed("14 tp, artifacts", phase_tp, torch, np, report, tmp, keep,
                                   dp_ref))
        path_launches.update(timed("15 space", phase_space, torch, np, report, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    k1, k2 = report["k1"], report["k2"]
    path_rows = [r for r in k2 if r["relu"]]
    kernels = [
        {"name": "normalize_u8", "route": "cuda",
         "source": "tpu_unet_torch/csrc/normalize_u8.cu",
         "replaces": "tpu_unet/ops/pallas/preprocess.py:61",
         "launches": launches["normalize_u8"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
         "ms_bf16": k1["kernel_ms_bf16"], "bound_ms_bf16": k1["bound_ms_bf16"],
         "kernel_record_ms": k1["kernel_record_ms"],
         "kernel_record_ms_bf16": k1["kernel_record_ms_bf16"],
         "launches_by_path": {p: c["normalize_u8"] for p, c in path_launches.items()},
         "shape": "(128,256,256,3) u8 -> f32",
         "seg": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                    "kernel_ms_bf16", "kernel_record_ms",
                                    "kernel_record_ms_bf16")} for r in k1["seg"]]},
        {"name": "conv3x3_int8", "route": "cuda",
         "source": "tpu_unet_torch/csrc/conv3x3_int8.cu",
         "replaces": "tpu_unet/ops/pallas/int8_conv.py:157",
         "launches": launches["conv3x3_int8"],
         "launches_by_path": {p: c["conv3x3_int8"] for p, c in path_launches.items()},
         "max_abs_err": max(max(r["max_abs_err"], r.get("max_abs_err_b128", 0))
                            for r in k2),
         "ms": sum(r["kernel_ms_b128"] for r in path_rows),
         "plain_ms": sum(r["plain_ms_b128"] for r in path_rows),
         "bound_ms": sum(r["bound_ms_b128"] for r in path_rows),
         "bound_by": _dominant_bound([{"bound_ms": r["bound_ms_b128"],
                                       "bound_by": r["bound_by_b128"]} for r in path_rows]),
         "library_ms": None,
         "bf16_cudnn_ms": sum(r["bf16_cudnn_ms_b128"] for r in path_rows),
         "kernel_record_ms": sum(r["kernel_record_ms_b128"] for r in path_rows),
         "ms_b8": sum(r["kernel_ms"] for r in path_rows),
         "bound_ms_b8": sum(r["bound_ms"] for r in path_rows),
         "shape": "the 18 score-path convs at batch 128, summed",
         "seg": {name: {k: v for k, v in t.items() if k != "rows"} | {
             "shape": f"the {len(t['rows'])} "
                      f"{'UNet++' if name.startswith('unetpp') else 'SegmentationUNet'} convs "
                      f"at b{SEG_BATCH}, {t['rows'][0]['h']}x{t['rows'][0]['w']}, summed"}
             for name, t in report["k2_seg"].items()}},
    ]
    report["kernels"] = kernels
    smi = nvidia_smi_line()
    report["nvidia_smi"] = smi
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["fsdp_widths"]:
        sys.exit(fsdp_widths())
    if sys.argv[1:2] == ["fsdp_width"]:
        sys.exit(fsdp_width(*sys.argv[2:6]))
    if sys.argv[1:2] == ["halo_probe"]:
        sys.exit(halo_probe())
    if sys.argv[1:2] == ["halo_probe_run"]:
        sys.exit(halo_probe_run(*sys.argv[2:4]))
    sys.exit(main())
