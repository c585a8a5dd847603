"""The port (tpu_unet_torch/ and chip_smoke.py) stands alone: it imports
neither JAX nor anything of the JAX package."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_unet_torch")


def _modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "tpu_unet_torch.serve" in mods and len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpu_unet'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b|\btpu_unet\.|"
    r"^\s*(import|from)\s+tpu_unet\b(?!_torch)", re.M)


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    + [os.path.join(ROOT, "chip_smoke.py")]))
def test_source_names_no_jax(path):
    with open(path) as f:
        src = f.read()
    hits = [m.group(0) for m in _FORBIDDEN.finditer(src)]
    assert not hits, f"{os.path.relpath(path, ROOT)}: {hits}"
