"""A run at a tiny size prints one last line with the contract's keys, and a
run is refused without a card."""

import io
import json
import time

import pytest
import torch

from port_bench import run

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["anomaly_train_bf16_b16", "kolektorsdd_serve_bf16_b1"])
def test_the_last_line(tiny_f32, workload, trace):
    out = io.StringIO()
    args = run.parse(["--workload", workload, "--seed", str(2 ** 31 + 11), "--seconds", "0.3",
                      "--trace", str(trace)])
    assert run.run(args, torch.device("cpu"), root=tiny_f32, t0=time.perf_counter(),
                   out=out) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert CONTRACT <= set(line) <= CONTRACT | {"breakdown", "check"}
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = set(line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert names and "setup_s" not in names
    else:
        assert "setup_s" in names and len(names) == 2
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "anomaly_train_bf16_b16", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
