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

Prints a ``{"kernels": [...]}`` line, the card's name and power limit
(nvidia-smi), and as the last line ``{"ok": true, "device": {...}}``; the
details go to chiprun_out/chip_smoke.json. Any failed check raises and exits
non-zero. Without a CUDA GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
# (N, H, W, Cin, Cout) off the main path, checked bit for bit.
ODD_CONVS = [(1, 10, 20, 32, 16), (2, 70, 70, 64, 64), (1, 5, 3, 3, 16),
             (1, 9, 130, 3, 80), (1, 3, 3, 32, 128), (2, 17, 33, 96, 144),
             (1, 6, 7, 2, 32)]
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
                    "kernel_ms_bf16": k16_ms, "bound_ms_bf16": b16_ms}


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


def phase_main_path(torch, np, report):
    from tpu_unet_torch.metrics.anomaly import anomaly_score
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.ops import quantize as tq
    from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8, conv3x3_int8_plain
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8, normalize_u8_plain
    from tpu_unet_torch.serve import AnomalyScorer

    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = build_model("anomaly_unet", base_features=64).to(
        "cuda", memory_format=torch.channels_last)
    for m in model.modules():  # warm BN statistics: the cumulative mean of 3 batches
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    model.train()
    with torch.no_grad():
        for seed in range(3):
            imgs = torch.from_numpy(synth_images(torch, 8, 256, 10 + seed, "cuda")).cuda()
            model(normalize_u8(imgs).permute(0, 3, 1, 2))
    state_dict = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
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
    class PlainK2Exec(tq._QuantExec):
        conv3x3 = staticmethod(conv3x3_int8_plain)

    batch = torch.from_numpy(images[:128]).cuda()
    with torch.inference_mode():
        img = normalize_u8_plain(batch)
        recon = tq._run(PlainK2Exec(int8.qparams), img,
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


def forward_flops(base, size, n_channels=3):
    """Model FLOPs of one AnomalyUNet forward on one image (2 per multiply-add)
    over its convolutions, transposed convolutions and heads."""
    def conv(cin, cout, hw, k=3):
        return 2 * cin * cout * k * k * hw * hw
    chans = [base * 2 ** i for i in range(5)]
    total = conv(n_channels, base, size) + conv(base, base, size)
    for i in range(1, 5):
        total += conv(chans[i - 1], chans[i], size >> i) + conv(chans[i], chans[i], size >> i)
    for head in (n_channels, 1):  # the reconstruction and segmentation decoders
        for i in range(4):
            cin, cout, hw = chans[4 - i], chans[3 - i], size >> (3 - i)
            total += 2 * cin * (cin // 2) * hw * hw + conv(cin, cout, hw) + conv(cout, cout, hw)
        total += 2 * base * head * size * size
    return total


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
    sd_cpu, sd_gpu = cpu.model.state_dict(), gpu.model.state_dict()
    param_err = stat_err = 0.0
    for k, v in sd_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((sd_gpu[k].cpu() - v).abs().max() / v.abs().max().clamp(min=1e-12))
        if k.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, err)
        else:
            param_err = max(param_err, err)
    print(f"[train-cpu] base {base}, {size}², b{b}, f32, SGD, one step, same weights and "
          f"draws: losses max rel diff {loss_rel:.3g}; parameters max |diff| / leaf max "
          f"{param_err:.3g}; BN running stats {stat_err:.3g}", flush=True)
    check(loss_rel <= 1e-5, f"CPU and card losses differ by {loss_rel:.3g} (rel)")
    check(param_err <= TRAIN_PARAM_TOL, f"CPU and card parameters differ by {param_err:.3g}")
    check(stat_err <= TRAIN_STAT_TOL, f"CPU and card BN statistics differ by {stat_err:.3g}")
    report["train_cpu_vs_card"] = {"loss_max_rel": loss_rel, "param_max_rel_to_leaf": param_err,
                                   "bn_stat_max_rel_to_leaf": stat_err,
                                   "param_tol": TRAIN_PARAM_TOL, "stat_tol": TRAIN_STAT_TOL}


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
         "shape": "(128,256,256,3) u8 -> f32"},
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
         "shape": "the 18 score-path convs at batch 128, summed"},
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
