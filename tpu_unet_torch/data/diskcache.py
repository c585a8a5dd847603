"""A persistent pack of decoded samples: decode and resize once, then read
them as memory maps (counterpart of ``tpu_unet/data/diskcache.py``, the same
on-disk format and fingerprints, so a pack holds the same bytes whichever
package wrote it).

A 900² MVTec PNG takes tens of ms to inflate on one core, and the RAM cache
(``data/cache.py``) only serves the epochs after the first in one process.
Each CLI of the train, test and visualize workflow would decode the dataset
again. Datasets therefore keep a content-addressed pack on disk:

- the fingerprint is a SHA-1 over a tag of the dataset's configuration (the
  resampler's name included) and each source file's name, size and mtime, so
  an edited dataset or another size builds a new pack;
- arrays are ``.npy`` files (images and masks at the training shape, one row
  per sample), scalars one vector each, strings in ``meta.json``;
- the build decodes in threads into a temporary directory that is renamed
  into place, so concurrent or killed builds leave no partial pack;
- a fresh process reads at page-cache speed.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil
import tempfile
from typing import Callable, Dict, Iterable, Optional

import numpy as np

_FORMAT_VERSION = 1


def fingerprint(tag: str, paths: Iterable[str]) -> str:
    """Content fingerprint: the configuration tag and each file's
    (basename, size, mtime_ns), in sorted path order."""
    h = hashlib.sha1()
    h.update(f"v{_FORMAT_VERSION}|{tag}".encode())
    for p in sorted(paths):
        try:
            st = os.stat(p)
            h.update(f"|{os.path.basename(p)}:{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            h.update(f"|{os.path.basename(p)}:missing".encode())
    return h.hexdigest()[:20]


class PackedStore:
    """Samples of one dataset (dicts of the same keys, shapes and dtypes),
    read from a pack directory as memory maps."""

    def __init__(self, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.n = self.meta["n"]
        self._arrays: Dict[str, np.ndarray] = {
            name: np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")
            for name, spec in self.meta["fields"].items() if spec["kind"] != "str"}

    def load(self, idx: int) -> Dict:
        """Sample ``idx``: arrays as read-only memory-map rows, scalars as
        numpy scalars, strings as str."""
        return {name: (self.meta["strings"][name][idx] if spec["kind"] == "str"
                       else self._arrays[name][idx])
                for name, spec in self.meta["fields"].items()}

    @classmethod
    def open_or_build(cls, cache_root: str, fp: str, n: int,
                      loader_fn: Callable[[int], Dict],
                      log: Optional[Callable[[str], None]] = None
                      ) -> Optional["PackedStore"]:
        """The pack of fingerprint ``fp`` under ``cache_root``, built from
        ``loader_fn(0..n-1)`` when missing; a pack that does not open is
        removed and built again. Returns None when ``n`` is 0 or the build
        fails (logged): the dataset then decodes directly."""
        if n == 0:
            return None
        path = os.path.join(cache_root, fp)
        if os.path.isdir(path):
            try:
                return cls(path)
            except Exception:
                shutil.rmtree(path, ignore_errors=True)  # corrupt: build again
        tmp = None
        try:
            os.makedirs(cache_root, exist_ok=True)
            tmp = tempfile.mkdtemp(prefix=f".{fp}.", dir=cache_root)
            cls._build(tmp, n, loader_fn, log)
            try:
                os.rename(tmp, path)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)  # another process built it first
            return cls(path)
        except Exception as e:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
            if log:
                log(f"disk cache build failed ({type(e).__name__}: {e}); "
                    "continuing without it")
            return None

    @staticmethod
    def _build(path: str, n: int, loader_fn: Callable[[int], Dict],
               log: Optional[Callable[[str], None]]) -> None:
        first = loader_fn(0)
        fields: Dict[str, Dict] = {}
        strings: Dict[str, list] = {}
        mmaps: Dict[str, np.ndarray] = {}
        for name, v in first.items():
            if isinstance(v, np.ndarray) and v.ndim > 0:
                fields[name] = {"kind": "array", "shape": list(v.shape),
                                "dtype": str(v.dtype)}
                shape = (n, *v.shape)
            elif isinstance(v, str):
                fields[name] = {"kind": "str"}
                strings[name] = [None] * n
                continue
            else:
                v = np.asarray(v)
                fields[name] = {"kind": "scalar", "dtype": str(v.dtype)}
                shape = (n,)
            mmaps[name] = np.lib.format.open_memmap(
                os.path.join(path, f"{name}.npy"), mode="w+", dtype=v.dtype, shape=shape)

        def write(i: int, sample: Dict) -> None:
            for name, spec in fields.items():
                if spec["kind"] == "str":
                    strings[name][i] = sample[name]
                else:
                    mmaps[name][i] = sample[name]

        write(0, first)
        # Decode in threads (PIL and the native resampler release the GIL);
        # each sample goes to its own rows.
        workers = min(8, os.cpu_count() or 1)
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
            for i, sample in enumerate(pool.map(loader_fn, range(1, n)), start=1):
                write(i, sample)
                if log and (i + 1) % 64 == 0:
                    log(f"disk cache: packed {i + 1}/{n} samples")
        for m in mmaps.values():
            m.flush()
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": n, "fields": fields, "strings": strings,
                       "format_version": _FORMAT_VERSION}, f)


def cache_root(disk_cache_dir: Optional[str]) -> Optional[str]:
    """A dataset's ``disk_cache_dir``: 'auto' is :func:`default_cache_root`;
    None or '' means no pack."""
    if disk_cache_dir == "auto":
        return default_cache_root()
    return disk_cache_dir or None


def default_cache_root() -> Optional[str]:
    """The datasets' default pack directory: ``TPU_UNET_DATA_CACHE``, else
    ``~/.cache/tpu_unet_data``; None (no pack) when the variable is '', '0'
    or 'off'."""
    v = os.environ.get("TPU_UNET_DATA_CACHE",
                       os.path.expanduser("~/.cache/tpu_unet_data"))
    return v if v not in ("", "0", "off") else None

