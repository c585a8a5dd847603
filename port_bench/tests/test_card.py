"""On the card: every cell runs once, briefly, and comes out correct."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", workload,
                          "--seed", "20240613", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
