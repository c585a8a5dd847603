"""The benchmark's own tests: ``python -m pytest port_bench/tests -q``.
Tests that need a CUDA card carry the ``card`` marker and decide inside
the test whether there is one."""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def make_tiny_bench(root: Path, precision: str = "float32") -> Path:
    """A copy of the benchmark's cells at a size a CPU test holds (base 4,
    32x32 and 64x32 images, batches of at most 4, short traced windows),
    under ``root``; ``precision`` 'f32' runs the program in float32, where
    it agrees with the reference to rounding."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "port_bench" / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "cfg").mkdir(exist_ok=True)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["base_features"] = 4
        cfg["image_height"], cfg["image_width"] = ((32, 32) if cfg["model"] == "anomaly_unet"
                                                   else (64, 32))
        cfg["precision"] = precision
        c["file"] = f"cfg/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = json.loads((REPO / "port_bench" / "traffic" / f"{w['traffic']}.json").read_text())
        t["batch"] = min(t["batch"], 4)
        t["trace_seconds"] = 0.3
        t["warmup_requests"] = min(t.get("warmup_requests", 0), 2)
        if t.get("precision"):
            t["precision"] = precision
        (root / "port_bench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_f32(tmp_path_factory):
    return make_tiny_bench(tmp_path_factory.mktemp("tiny_f32"), "f32")
