"""The host data-loader core, ``tpu_unet_torch/csrc/loader_core.cpp``,
through ctypes (counterpart of ``tpu_unet/data/native.py``): uint8 resize
across a thread pool without the GIL, and a scanline polygon fill.

g++ builds the library at first use, with the JAX package's flags, into
``build/tpu_unet_torch/`` beside the package, named by a hash of the source,
the compiler and the flags. The build writes a temporary file and moves it
into place with ``os.replace``, so processes that build at once each load a
whole library.

Nothing falls back to PIL here: a library that cannot be built or loaded
raises ``RuntimeError`` with the compiler's output. ``TPU_UNET_NATIVE_RESIZE=0``
makes ``data/transforms.py`` resize with PIL instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from tpu_unet_torch.ops.kernels.build import BUILD_DIR, CSRC

EXPECTED_VERSION = 2  # tu_version() of csrc/loader_core.cpp
SOURCE = CSRC / "loader_core.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-lpthread",)
MODES = {"nearest": 0, "bilinear": 1, "area": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "tu_resize_u8": [_P, _I, _I, _I, _P, _I, _I, _I, _I],
    "tu_resize_u8_batch": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _I],
    "tu_fill_polygon": [_P, _I, _I, _P, _I, ctypes.c_ubyte],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(build_dir: Optional[Path] = None) -> Path:
    """The library's file in ``build_dir`` (default: ``BUILD_DIR``)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    return Path(build_dir or BUILD_DIR) / f"libloader_core-{digest.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Dict[str, object]:
    """Compile the library into ``build_dir`` (default: ``BUILD_DIR``)
    unless it is there already. Returns ``{"path", "seconds", "log"}``
    (seconds 0 for a library already built). Raises RuntimeError with the
    compiler's output on failure."""
    out = library_path(build_dir)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        log, code = proc.stdout + proc.stderr, proc.returncode
    except (OSError, subprocess.TimeoutExpired) as e:
        log, code = f"{type(e).__name__}: {e}", None
    if code != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the native loader core ({SOURCE.name}) did not build: "
            f"{' '.join(cmd)} exited {code}:\n{log}\n"
            "Set TPU_UNET_NATIVE_RESIZE=0 to resize images with PIL instead.")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "log": log}


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises RuntimeError when
    it cannot be built or loaded, or reports another version."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()["path"]
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"the native loader core {path} did not load ({e}); "
                                   "set TPU_UNET_NATIVE_RESIZE=0 to resize images with "
                                   "PIL instead") from e
            for fn, argtypes in _ARGTYPES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = None
            lib.tu_version.restype = ctypes.c_int
            if lib.tu_version() != EXPECTED_VERSION:
                raise RuntimeError(f"{path} reports tu_version {lib.tu_version()}, "
                                   f"expected {EXPECTED_VERSION}")
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads (without raising)."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(8, os.cpu_count() or 1)


def resize_u8(src: np.ndarray, out_hw, mode: str = "area",
              n_threads: int = 0) -> np.ndarray:
    """Resize an (H, W, C) or (H, W) uint8 array to ``out_hw``.

    Modes: 'area' (the triangle filter widened by the downscale factor, as
    PIL's BILINEAR; classic bilinear on upscale), 'bilinear' (4-tap, half-pixel
    centers), 'nearest' (label maps). ``n_threads`` 0 uses up to 8."""
    lib = get_lib()
    dh, dw = out_hw
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    sh, sw, c = src.shape
    if (sh, sw) == (dh, dw):
        out = src.copy()
    else:
        src = np.ascontiguousarray(src, dtype=np.uint8)
        out = np.empty((dh, dw, c), np.uint8)
        lib.tu_resize_u8(src.ctypes.data, sh, sw, c, out.ctypes.data, dh, dw, MODES[mode],
                         _threads(n_threads))
    return out[..., 0] if squeeze else out


def resize_u8_batch(src: np.ndarray, out_hw, mode: str = "area",
                    n_threads: int = 0) -> np.ndarray:
    """Resize N images of one size, (N, H, W, C) or (N, H, W) uint8, one
    image per thread (``tu_resize_u8_batch``); each image's result equals
    :func:`resize_u8`'s."""
    lib = get_lib()
    dh, dw = out_hw
    squeeze = src.ndim == 3
    if squeeze:
        src = src[..., None]
    n, sh, sw, c = src.shape
    if (sh, sw) == (dh, dw):
        out = src.copy()
        return out[..., 0] if squeeze else out
    src = np.ascontiguousarray(src, dtype=np.uint8)
    out = np.empty((n, dh, dw, c), np.uint8)
    if n:
        lib.tu_resize_u8_batch(src.ctypes.data, n, sh, sw, c, out.ctypes.data, dh, dw,
                               MODES[mode], _threads(n_threads))
    return out[..., 0] if squeeze else out


def fill_polygon(mask: np.ndarray, points_xy, value: int = 1) -> None:
    """Even-odd scanline fill of a polygon, given as (x, y) points, into an
    (H, W) C-contiguous uint8 mask, in place. Close to PIL's fill (the Gear
    dataset rasterizes with PIL, the reference's)."""
    lib = get_lib()
    if mask.dtype != np.uint8 or not mask.flags["C_CONTIGUOUS"]:
        raise ValueError("fill_polygon needs a C-contiguous uint8 mask")
    h, w = mask.shape
    pts = np.ascontiguousarray(np.asarray(points_xy, np.float32).reshape(-1))
    lib.tu_fill_polygon(mask.ctypes.data, h, w, pts.ctypes.data, len(pts) // 2, value)
