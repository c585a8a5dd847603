"""Build the CUDA kernels of ``tpu_unet_torch/csrc`` and load them with ctypes.

Each ``.cu`` file is compiled on its own by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a`` (Hopper). Libraries go to ``build/tpu_unet_torch/`` beside the
package, named by a hash of their source and flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built at import time: the
first launch of a kernel builds it, and :func:`build` builds several at once,
one ``nvcc`` process each, all started together.

Every library exports ``tpu_unet_error_string(int)`` beside its kernels; each
kernel entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_unet_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# library name -> (source file, {C function: argtypes}); every function
# returns an int error code.
KERNELS = {
    "normalize_u8": ("normalize_u8.cu", {
        "tpu_unet_normalize_u8": [_P, _P, _LL, _I] + [_F] * 6 + [_P],
    }),
    "conv3x3_int8": ("conv3x3_int8.cu", {
        "tpu_unet_conv3x3_int8": [_P] * 6 + [_I] * 6 + [_P],
        "tpu_unet_conv3x3_int8_c3": [_P] * 6 + [_I] * 6 + [_P],
    }),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The path of nvcc: on PATH, else under PyTorch's CUDA_HOME."""
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME/bin); "
                           "the CUDA kernels of tpu_unet_torch cannot be built")
    return path


def library_path(name: str) -> Path:
    source = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process each, in parallel. Returns ``{name: {"path", "seconds",
    "log"}}`` (seconds 0 and an empty log for a library already built).
    Raises RuntimeError naming the kernel and nvcc's output if one fails."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result: Dict[str, dict] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            result[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        result[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return result


# Serving threads (one per 'space' device) call the kernels at once: the
# first load and the launch counters are taken under this lock.
LOCK = threading.RLock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with LOCK:
        return _load(name)


def _load(name: str) -> ctypes.CDLL:
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]["path"]
        lib = ctypes.CDLL(path)
        for fn, argtypes in KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.tpu_unet_error_string.argtypes = [ctypes.c_int]
        lib.tpu_unet_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.tpu_unet_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def current_stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the integer handle
    the C entry points take."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
