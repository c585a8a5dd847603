"""BENCHMARK.json keeps to the contract's shape, names and units, and every
file it names is there."""

import json
import re

import pytest

from port_bench import spec
from port_bench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(PATH.match(p) and (REPO / p).is_dir() for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024


def _entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            yield key, e


@pytest.mark.parametrize("key,entry", list(_entries()),
                         ids=[f"{k}:{e['name']}" for k, e in _entries()])
def test_names_units_and_keys(key, entry):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[key]
    assert set(entry) <= allowed and set(entry) >= allowed - {"workloads"}
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "configs":
        assert all(NAME.match(r) for r in entry["reduced"]) and len(entry["reduced"]) <= 16
        assert (REPO / entry["file"]).is_file()


def test_names_are_unique_and_cells_resolve():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        assert all(m["moves"] in names for m in cell.per_layer)
        assert set(cell.traffic["limits"])
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))
