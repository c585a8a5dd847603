#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tpu_unet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from tpu_unet_torch/csrc (one nvcc each, in
   parallel) and prints the build time, ptxas's register and spill report and
   a count of the tensor-core and TMA instructions in the built code.
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
   exercise the tiling's edges are held bit for bit too.
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
   kos folders, 52 with a thin defect streak of class 1 or 2): 3 epochs of
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

Prints a ``{"kernels": [...]}`` line, the card's name and power limit
(nvidia-smi), and as the last line ``{"ok": true, "device": {...}}``; the
details go to chiprun_out/chip_smoke.json. Any failed check raises and exits
non-zero. Without a CUDA GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
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
# K1 there: KolektorSDD at 1024 x 512, Gear at 512 x 512.
SEG_BATCH = 8
SEG_K1_SHAPES = [(SEG_BATCH, 1024, 512, 3), (SEG_BATCH, 512, 512, 3)]
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
    print(f"[K1] (128,256,256,3) u8->f32: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / k_ms:.1f}% of bound; u8->bf16: "
          f"kernel {k16_ms:.4f} ms, bound {b16_ms:.4f} ms, {100 * b16_ms / k16_ms:.1f}% of "
          f"bound; bit-exact f32 and bf16 against the plain version on the card and the "
          f"CPU", flush=True)
    report["k1"] = {"shape": [128, 256, 256, 3], "kernel_ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                    "kernel_ms_bf16": k16_ms, "bound_ms_bf16": b16_ms, "seg": []}
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
        report["k1"]["seg"].append({"shape": list(shape), "kernel_ms": k_ms, "plain_ms": p_ms,
                                    "bound_ms": sb_ms, "bound_by": sb_by,
                                    "kernel_ms_bf16": k16_ms, "max_abs_err": 0.0})
        print(f"[K1] seg {shape} u8->f32: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{sb_ms:.4f} ms ({sb_by}), {100 * sb_ms / k_ms:.1f}% of bound; bf16 {k16_ms:.4f} "
              f"ms; bit-exact f32 and bf16", flush=True)
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
    total, bound = sum(r["kernel_ms_b128"] for r in path), sum(r["bound_ms_b128"] for r in path)
    print(f"[K2] b128, the 18 score-path convs: kernel {total:.3f} ms, bound {bound:.3f} ms, "
          f"{100 * bound / total:.1f}% of bound; bf16 cuDNN yardstick "
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
    total = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "bound_ms",
                                                  "bf16_cudnn_ms")}
    print(f"[K2] seg {name} b{SEG_BATCH}, the {len(rows)} convs: kernel "
          f"{total['kernel_ms']:.3f} ms, "
          f"bound {total['bound_ms']:.3f} ms, {100 * total['bound_ms'] / total['kernel_ms']:.1f}% "
          f"of bound; plain {total['plain_ms']:.1f} ms; bf16 cuDNN yardstick "
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


def phase_mvtec(torch, np, report):
    """Phase 8: the MVTec main path at full width through the train and test
    CLIs' own functions (``train_mvtec.train``; ``test_mvtec``'s
    ``make_test_loader``, ``load_model``, ``test_model``, ``evaluate_results``,
    ``save_results``) on a synthetic category written as PNG files and read
    by ``MVTecDataset``. Only the CLIs' ``main``s are not called: their plots
    need matplotlib, which the card's machine does not have. Returns the
    launch counts of each leg."""
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
        shutil.rmtree(os.path.join(tmp, "runs"))  # 3.6 GB of checkpoints
        torch.cuda.empty_cache()

        out["cpu_vs_card"] = _mvtec_cpu_vs_card(torch, np, data_root, tmp)
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


def phase_seg(torch, np, report, tmp):
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
        ksdd_root, tmp, epochs=3, test_modes=modes, profile_epoch=1, loss_must_fall=True)
    _seg_resume(torch, np, out, legs, exp, train_kolektorsdd, common, data, tmp)
    shutil.rmtree(os.path.join(tmp, "runs"))
    out["kolektorsdd"]["cpu_vs_card"] = _seg_cpu_vs_card(torch, np, ksdd_root, tmp)

    _seg_dataset(torch, np, out, legs, "gear", train_gear, test_gear, gear_root, tmp,
                 epochs=1, test_modes=(modes[0], modes[2]))
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


def phase_extensions(torch, np, report, tmp):
    """Phase 10: the model extensions at full width. (a) UNet++ with deep
    supervision on phase 9's synthetic Gear tree through the seg CLIs'
    functions (train_gear's defaults: base 64, bf16, 512², b8, Adam 1e-3):
    3 epochs (epoch 0 decodes cold, epoch 1 profiled, epoch 2 clean), then
    the test path on best_model.pth in bf16, f32 --fold_bn and int8, at
    --heads 4 and --heads 1 (K2 30 and 6 times per int8 batch). (b) The
    attention UNet on the synthetic KolektorSDD tree at its defaults
    (1024 x 512, b8), 3 epochs, tested in bf16, f32 --fold_bn and int8 (K2
    18 times per batch, the gates in float). (c) Bilinear AnomalyUNet
    serving. (d) The CPU against the card. Returns the launch counts of each
    leg."""
    from tpu_unet_torch.cli import test_gear, test_kolektorsdd, train_gear, train_kolektorsdd

    shutil.rmtree(os.path.join(tmp, "runs"), ignore_errors=True)
    legs, out = {}, {}
    unetpp_modes = (seg_test_modes(30, limits=EXT_MAX_DISAGREE["gear_unetpp"])
                    + seg_test_modes(6, extra=["--heads", "1"], suffix="_heads1",
                                     limits=EXT_MAX_DISAGREE["gear_unetpp_heads1"]))
    _seg_dataset(torch, np, out, legs, "gear_unetpp", train_gear, test_gear,
                 os.path.join(tmp, "gear"), tmp, epochs=3, test_modes=unetpp_modes,
                 model_flags=["--model", "unetpp", "--deep_supervision"], profile_epoch=1,
                 flops_fn=unetpp_forward_flops, checkpoint="best_model.pth")
    shutil.rmtree(os.path.join(tmp, "runs"))
    _seg_dataset(torch, np, out, legs, "kolektorsdd_attn", train_kolektorsdd, test_kolektorsdd,
                 os.path.join(tmp, "ksdd"), tmp, epochs=3,
                 test_modes=seg_test_modes(18, limits=EXT_MAX_DISAGREE["kolektorsdd_attn"]),
                 model_flags=["--model", "attn_unet"], profile_epoch=1,
                 flops_fn=attn_forward_flops)
    shutil.rmtree(os.path.join(tmp, "runs"))
    _ext_bilinear_serving(torch, np, out, legs)
    out["cpu_vs_card"] = _ext_cpu_vs_card(torch, np)
    report["main_path"]["extensions"] = out
    return legs


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
    phase_build(report)
    phase_k1(torch, report)
    phase_k2(torch, report)
    launches = phase_main_path(torch, np, report)
    path_launches = {"serve": launches, **phase_train(torch, np, report)}
    phase_train_cpu_vs_card(torch, np, report)
    path_launches.update(phase_mvtec(torch, np, report))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_seg_")
    try:
        path_launches.update(phase_seg(torch, np, report, tmp))
        path_launches.update(phase_extensions(torch, np, report, tmp))
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
         "launches_by_path": {p: c["normalize_u8"] for p, c in path_launches.items()},
         "shape": "(128,256,256,3) u8 -> f32",
         "seg": [{k: r[k] for k in ("shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                    "kernel_ms_bf16")} for r in k1["seg"]]},
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
    sys.exit(main())
