"""The control, the reference one precision below the configuration's in
the program's place, comes out not correct under each cell's limits (here
at a size a CPU test holds; PERF.md has its readings on the card at the
cells' sizes); so does the reference taking half of each batch."""

import pytest
import torch

from port_bench import compare, control, spec

CASES = [("anomaly_train_bf16_b16", "control"), ("anomaly_train_bf16_b16", "half"),
         ("kolektorsdd_train_bf16_b8", "control"), ("kolektorsdd_train_bf16_b8", "half"),
         ("anomaly_serve_int8_b128", "control"), ("kolektorsdd_serve_bf16_b1", "control")]


@pytest.mark.parametrize("workload,variant", CASES, ids=[f"{w}-{v}" for w, v in CASES])
def test_the_control_is_not_correct(tiny_f32, workload, variant):
    cell = spec.load_cell(workload, tiny_f32)
    numbers = control.readings(cell, 31337, variant, torch.device("cpu"))
    ok, _ = compare.verdict(numbers, cell.traffic["limits"])
    assert not ok, numbers
