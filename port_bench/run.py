"""Run one cell of ``BENCHMARK.json`` once, on the card this process is
started on:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the ``setup_s`` metric: imports, inputs and weights from the seed,
the program's own set-up, its first checked steps or warm-up requests)
warms every shape the window uses. Then the window runs the cell's traffic
for ``--seconds``. With ``--trace 1`` a further window of the traffic's
``trace_seconds`` runs under ``torch.profiler`` and the per-layer metrics
are read from it (and from the first window); with ``--trace 0`` the line
carries the end-to-end metrics. Then the program is released, the
reference recomputes what the window's first steps or a seeded sample of
its answers should have been, and ``correct`` says whether every compared
number is within its limit. Progress goes to standard error, whose last
lines are the compared numbers with their limits; the last line of
standard output is the result.

The run exits with a code other than 0 and prints no result where there is
no CUDA device or fewer than the cell asks for, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``tpu_unet`` was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

# Every build and kernel cache a run may fill lies in the checkout, at a
# fixed path (the port's nvcc libraries already go to build/tpu_unet_torch).
_ROOT = Path(__file__).resolve().parents[1]
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(_ROOT / "build" / "port_bench" / _sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import cells, compare, spec  # noqa: E402
from port_bench.trace import Trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_unet")

END_TO_END = {
    "train_img_per_s": lambda r: r.images / r.seconds,
    "serve_img_per_s": lambda r: r.images / r.seconds,
    "latency_p95_ms": lambda r: float(np.percentile(r.latencies_ms, 95)),
}


@dataclass
class Context:
    """What a per-layer metric's reader reads: the cell's configuration and
    traffic, the measured window, and the traced window with its trace."""
    config: Dict
    traffic: Dict
    window: cells.Record
    traced: Optional[cells.Record]
    trace: Optional[Trace]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``tpu_unet_torch`` is not ``tpu_unet``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def say(msg: str) -> None:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)


def traced_window(cell, seconds: float, device):
    """The traffic for ``seconds`` under ``torch.profiler``, which wraps the
    window alone. On a card it records the device's activity (kernels,
    copies, sets and the CUDA runtime calls that issue them) and no CPU
    operators, whose recording slows the host enough to idle the device by
    itself."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        record = cell.run(seconds)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return record, Trace.from_file(path)


def device_info(device, chips: int, peak: int, trace: Optional[Trace]) -> Dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if trace is not None:
        info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return info


def run(args, device, root=spec.ROOT, t0: float = _T0, out=None) -> int:
    """One run of the cell on ``device``; prints the result line to ``out``
    (standard output) and returns the exit code."""
    out = out or sys.stdout
    cell = spec.load_cell(args.workload, root)
    say(f"{cell.name}: {cell.config['model']} {cell.config['image_height']}x"
        f"{cell.config['image_width']}, {cell.traffic['kind']} b{cell.traffic['batch']}, "
        f"seed {args.seed}, on {device}")
    # the program's own prints (e.g. a kernel build's log) must not reach stdout
    with contextlib.redirect_stdout(sys.stderr):
        say(f"imports {time.perf_counter() - t0:.3f} s")
        c = cells.make(cell.config, cell.traffic, args.seed, device)
        say(f"inputs and weights {time.perf_counter() - t0:.3f} s")
        c.start_program()
        setup_s = time.perf_counter() - t0
        say(f"set-up {setup_s:.3f} s; window of {args.seconds} s")
        record = c.run(args.seconds)
        metrics, traced, trace = {}, None, None
        if args.trace:
            traced, trace = traced_window(c, cell.traffic["trace_seconds"], device)
            say(f"traced window {trace.window_s:.3f} s, device busy {trace.busy_s:.3f} s, "
                f"{len(trace.device)} device and {len(trace.host)} host events")
            ctx = Context(cell.config, cell.traffic, record, traced, trace)
            for m in cell.per_layer:
                value = spec.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in cell.end_to_end:
                value = setup_s if m["name"] == "setup_s" else END_TO_END[m["name"]](record)
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        c.stop_program()
        say(f"window: {record.seconds:.3f} s, {record.images} images; checking")
        t_check = time.perf_counter()
        numbers = c.check()
        say(f"check took {time.perf_counter() - t_check:.3f} s")
    ok, rows = compare.verdict(numbers, cell.traffic["limits"])
    failed = record.failed + (traced.failed if traced else 0)
    bad = forbidden_modules()
    if bad:
        say(f"refusing to report: these modules were loaded: {bad}")
        return 3
    line = {"correct": bool(ok and failed == 0),
            "attempted": record.steps or record.requests,
            "failed": failed, "metrics": metrics,
            "device": device_info(device, cell.chips, peak, trace)}
    if trace is not None and trace.device:
        line["breakdown"] = trace.breakdown()
    line["check"] = rows
    for k, r in rows.items():
        print(f"check {k}: {r['value']!r} (limit {r['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    return run(args, torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
