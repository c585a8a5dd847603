"""The readings that the limits of ``correct`` are set from, several seeds in
one process (the benchmark's own runs do not run this):

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3 --variant <v>

``--variant``:

- ``program``: the program as a run drives it (its set-up with the first
  checked steps, and for serving a window of ``--seconds``), checked as a
  run checks it: the lower readings;
- ``control``: the reference in the program's place, one precision below
  the configuration's (float8 for bfloat16, int4 for int8), against the
  reference: the upper readings;
- ``half`` and ``frozen`` (training): the reference in the program's
  place taking each step on the first half of its batch, the mean over
  that half, or leaving its state unchanged (planted faults).

Each seed prints one JSON line ``{"workload", "variant", "seed", "numbers"}``
on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict

import torch

from port_bench import cells, compare, spec


def readings(cell: spec.Cell, seed: int, variant: str, device, seconds: float = 2.0
             ) -> Dict[str, float]:
    c = cells.make(cell.config, cell.traffic, seed, device)
    train = cell.traffic["kind"] == "train"
    if variant == "program":
        c.start_program()
        if not train:
            c.run(seconds)
        c.stop_program()
        if not train:
            return c.check()
        prog, ref = c.program_outputs(), c.reference_outputs("f32")
        print(json.dumps({"seed": seed, "detail": compare.train_detail(prog, ref)}),
              file=sys.stderr)
        return c.numbers(prog, ref)
    if train:
        if variant not in ("control", "half", "frozen"):
            raise ValueError(f"no variant {variant!r} for a training cell")
        reference = c.reference_outputs("f32")
        return c.numbers(c.reference_outputs("fp8" if variant == "control" else variant),
                         reference)
    if variant != "control":
        raise ValueError(f"no variant {variant!r} for a serving cell")
    samples = c.pool_samples()
    return c.numbers(c.control(samples), c.truth(samples))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Readings for the limits of correct.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma separated")
    p.add_argument("--variant", default="control", choices=("program", "control", "half", "frozen"))
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        with contextlib.redirect_stdout(sys.stderr):
            numbers = readings(cell, seed, args.variant, device, args.seconds)
        print(json.dumps({"workload": cell.name, "variant": args.variant, "seed": seed,
                          "numbers": numbers}), flush=True)
        cells.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
