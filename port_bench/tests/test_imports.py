"""Nothing a run imports is JAX, flax or the JAX package, compared by whole
top-level names; the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from port_bench import run
from port_bench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_unet"}


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_unet_torch_lookalike", sys)
    assert "tpu_unet" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_unet.sub", sys)
    assert run.forbidden_modules() == ["tpu_unet"]


_WALK = """
import json, sys, time, torch
sys.path.insert(0, {repo!r})
from port_bench import run
from port_bench.tests.conftest import make_tiny_bench
from pathlib import Path
root = make_tiny_bench(Path({tmp!r}), "f32")
for w in ("anomaly_train_bf16_b16", "kolektorsdd_train_bf16_b8", "anomaly_serve_int8_b128",
          "kolektorsdd_serve_bf16_b1"):
    args = run.parse(["--workload", w, "--seed", "7", "--seconds", "0.2", "--trace", "1"])
    assert run.run(args, torch.device("cpu"), root=root, t0=time.perf_counter()) == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_of_every_cell_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _WALK.format(repo=str(REPO), tmp=str(tmp_path))],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tpu_unet_torch" in names and "port_bench" in names
    assert not names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((REPO / "port_bench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN | {"tpu_unet_torch"}, f"{path.name} imports {name}"
                if top == "port_bench":
                    assert name.startswith("port_bench.reference"), f"{path.name}: {name}"
    code = ("import sys; sys.path.insert(0, %r); import torch; "
            "from port_bench.reference import adam, augment, int8, ladder, losses, lowp; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('tpu_unet_torch', 'jax', 'flax', 'tpu_unet')))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path("/"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
