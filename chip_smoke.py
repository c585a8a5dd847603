#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (tpu_unet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from tpu_unet_torch/csrc (one nvcc each, in
   parallel) and prints the build time and ptxas's register and spill report.
2. K1 (normalize_u8) at the serving batch (128, 256, 256, 3): kernel against
   its plain PyTorch version on the card, bit for bit, in float32 and
   bfloat16; both timed.
3. K2 (conv3x3_int8) at the 18 conv shapes of the int8 score path at batch 8,
   plus one relu=False case: kernel against its plain version (float64
   accumulation, exact) on the card, bit for bit; both timed. Again at the
   main path's batch 128, bit for bit, the kernel timed.
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

# (H = W, Cin, Cout) of the 18 3x3 convs of the int8 score path, in order:
# encoder inc, down1..down4, then the reconstruction decoder up1..up4.
SCORE_PATH_CONVS = [
    (256, 3, 64), (256, 64, 64), (128, 64, 128), (128, 128, 128),
    (64, 128, 256), (64, 256, 256), (32, 256, 512), (32, 512, 512),
    (16, 512, 1024), (16, 1024, 1024),
    (32, 1024, 512), (32, 512, 512), (64, 512, 256), (64, 256, 256),
    (128, 256, 128), (128, 128, 128), (256, 128, 64), (256, 64, 64),
]
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
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


def device_breakdown(torch, fn, n_calls=5, top=6):
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
        cats[_category(k)] = cats.get(_category(k), 0.0) + ms
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
    for name, r in res.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    report["build"] = {"wall_s": wall, **{k: {"seconds": v["seconds"], "log": v["log"]}
                                          for k, v in res.items()}}


def phase_k1(torch, report):
    from tpu_unet_torch.ops.kernels.preprocess import normalize_u8, normalize_u8_plain
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, 256, (128, 256, 256, 3), generator=g, device="cuda",
                      dtype=torch.uint8)
    k_ms, out = cuda_ms(torch, lambda: normalize_u8(x), iters=20, warmup=5)
    p_ms, ref = cuda_ms(torch, lambda: normalize_u8_plain(x), iters=5, warmup=2)
    check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
          "K1 f32 differs from its plain version")
    out16 = normalize_u8(x, out_dtype=torch.bfloat16)
    ref16 = normalize_u8_plain(x, out_dtype=torch.bfloat16)
    check(torch.equal(out16.view(torch.int16), ref16.view(torch.int16)),
          "K1 bf16 differs from its plain version")
    torch.cuda.synchronize()
    n = x.numel()
    b_ms, b_by = bound_ms(n * (1 + 4), 3 * n, PEAK_F32_FLOPS)
    err = float((out - ref).abs().max())
    print(f"[K1] (128,256,256,3) u8->f32: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), bit-exact f32 and bf16", flush=True)
    report["k1"] = {"shape": [128, 256, 256, 3], "kernel_ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def _k2_case(torch, n, hw, cin, cout, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = -127 if cin == 3 else 0  # the quantized input vs post-ReLU activations
    x = torch.randint(lo, 128, (n, hw, hw, cin), generator=g, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, 3, 3, cin), generator=g, device="cuda",
                      dtype=torch.int8)
    s_out = torch.full((), 0.05, device="cuda")
    sigma = (9 * cin) ** 0.5 * 127 ** 2 / 3  # rough std of the accumulator
    scale = (0.05 * 40 / sigma) * (0.5 + torch.rand(cout, generator=g, device="cuda"))
    bias = torch.randn(cout, generator=g, device="cuda") * 0.5
    return x, w, scale.float(), bias.float(), s_out


def phase_k2(torch, report):
    from tpu_unet_torch.ops.kernels.int8_conv import (conv3x3_int8, conv3x3_int8_plain,
                                                      pad_channels)
    rows = []
    cases = [(hw, cin, cout, True) for hw, cin, cout in SCORE_PATH_CONVS]
    cases.append((64, 256, 256, False))
    for i, (hw, cin, cout, relu) in enumerate(cases):
        n = 8
        x, w, scale, bias, s_out = _k2_case(torch, n, hw, cin, cout, seed=100 + i)
        k_ms, out = cuda_ms(torch, lambda: conv3x3_int8(x, w, scale, bias, s_out, relu),
                            iters=10)
        p_ms, ref = cuda_ms(torch, lambda: conv3x3_int8_plain(x, w, scale, bias, s_out,
                                                              relu), iters=1)
        diff = int((out.int() - ref.int()).abs().max())
        check(diff == 0, f"K2 differs from its plain version at {(n, hw, cin, cout, relu)}"
                         f" (max |diff| {diff}, {int((out != ref).sum())} values)")
        hist = torch.bincount((out.int() + 128).flatten(), minlength=256)
        levels = int((hist > 0).sum())
        n_pix = n * hw * hw
        b_ms, b_by = bound_ms(n_pix * cin + 9 * cin * cout + n_pix * cout + 8 * cout,
                              2 * n_pix * 9 * cin * cout, PEAK_INT8_OPS)
        row = {"n": n, "hw": hw, "cin": cin, "cout": cout, "relu": relu,
               "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": diff, "int8_levels_hit": levels}
        if relu:  # the main path's batch, weights padded ahead as _QuantExec keeps them
            xb, wb, sb, bb, so = _k2_case(torch, 128, hw, cin, cout, seed=200 + i)
            wb = pad_channels(wb)
            row["kernel_ms_b128"], out = cuda_ms(
                torch, lambda: conv3x3_int8(xb, wb, sb, bb, so, True), iters=5)
            ref = conv3x3_int8_plain(xb, wb, sb, bb, so, True)
            diff_b128 = int((out.int() - ref.int()).abs().max())
            check(diff_b128 == 0, f"K2 differs from its plain version at "
                                  f"{(128, hw, cin, cout, relu)} (max |diff| {diff_b128}, "
                                  f"{int((out != ref).sum())} values)")
            row["max_abs_err_b128"] = diff_b128
            del out, ref
            row["bound_ms_b128"], _ = bound_ms(
                128 * hw * hw * (cin + cout) + 9 * cin * cout + 8 * cout,
                2 * 128 * hw * hw * 9 * cin * cout, PEAK_INT8_OPS)
            if cin % 32:  # the wrapper's zero pad of the channels (inside kernel_ms)
                row["pad_ms_b128"], _ = cuda_ms(
                    torch, lambda: torch.nn.functional.pad(xb, (0, -cin % 32)), iters=5)
            del xb, wb, sb, bb, so
        rows.append(row)
        print(f"[K2] b{n} {hw}x{hw} {cin:4d}->{cout:4d} relu={relu!s:5}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / k_ms:.1f}% of bound, {levels} int8 levels, bit-exact"
              + (f"; b128 {row['kernel_ms_b128']:.3f} ms, bit-exact" if relu else "")
              + (f" (of which channel pad {row['pad_ms_b128']:.3f} ms)"
                 if "pad_ms_b128" in row else ""), flush=True)
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

    k1, k2 = report["k1"], report["k2"]
    path_rows = [r for r in k2 if r["relu"]]
    kernels = [
        {"name": "normalize_u8", "route": "cuda",
         "source": "tpu_unet_torch/csrc/normalize_u8.cu",
         "replaces": "tpu_unet/ops/pallas/preprocess.py:61",
         "launches": launches["normalize_u8"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["kernel_ms"], "kernel_ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
         "shape": "(128,256,256,3) u8 -> f32"},
        {"name": "conv3x3_int8", "route": "cuda",
         "source": "tpu_unet_torch/csrc/conv3x3_int8.cu",
         "replaces": "tpu_unet/ops/pallas/int8_conv.py:157",
         "launches": launches["conv3x3_int8"],
         "max_abs_err": max(max(r["max_abs_err"], r.get("max_abs_err_b128", 0))
                            for r in k2),
         "ms": sum(r["kernel_ms"] for r in path_rows),
         "kernel_ms": sum(r["kernel_ms"] for r in path_rows),
         "plain_ms": sum(r["plain_ms"] for r in path_rows),
         "bound_ms": sum(r["bound_ms"] for r in path_rows),
         "bound_by": _dominant_bound(path_rows),
         "library_ms": None,
         "ms_b128": sum(r["kernel_ms_b128"] for r in path_rows),
         "bound_ms_b128": sum(r["bound_ms_b128"] for r in path_rows),
         "shape": "the 18 score-path convs at batch 8, summed"},
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
