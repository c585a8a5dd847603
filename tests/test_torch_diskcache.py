"""The port's packed sample store (tpu_unet_torch/data/diskcache.py) and the
datasets that read it, on the CPU: a pack round-trips each dataset's samples
[exact], a reopened pack decodes nothing, a source change or another
configuration builds a new pack, ``TPU_UNET_DATA_CACHE=""`` turns the default
off, a failed build falls back to decoding, and a pack that either package
built serves the other [exact]: the format, the fingerprints and the
resampler are the JAX package's."""

import os

import numpy as np
import pytest

import tpu_unet.data.transforms as jax_transforms
from test_data import make_gear, make_kolektorsdd, make_mvtec
from tpu_unet.data import diskcache as jax_diskcache
from tpu_unet.data.gear import GearDataset as JaxGear
from tpu_unet.data.kolektorsdd import KolektorSDDDataset as JaxKSDD
from tpu_unet.data.mvtec import MVTecDataset as JaxMVTec
from tpu_unet_torch.data import diskcache, transforms
from tpu_unet_torch.data.gear import GearDataset
from tpu_unet_torch.data.kolektorsdd import KolektorSDDDataset
from tpu_unet_torch.data.mvtec import MVTecDataset


@pytest.fixture(autouse=True)
def _native_resize(monkeypatch):
    """Both packages on their default resampler, the native one."""
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", True)
    monkeypatch.setattr(transforms, "_USE_NATIVE", True)


@pytest.fixture()
def mvtec_root(tmp_path):
    return make_mvtec(str(tmp_path / "mv"), n_train=5, n_test_good=2, n_broken=2, size=48)


def _same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _datasets(kind, root, pkg, cache):
    """(port or JAX) dataset of ``kind`` over ``root`` with ``cache``."""
    if kind == "mvtec":
        cls = MVTecDataset if pkg == "port" else JaxMVTec
        return cls(root, "bottle", "test", 32, is_train=False, disk_cache_dir=cache)
    if kind == "gear":
        cls = GearDataset if pkg == "port" else JaxGear
        return cls(root, "train", (32, 32), disk_cache_dir=cache)
    cls = KolektorSDDDataset if pkg == "port" else JaxKSDD
    return cls(root, "train", (32, 16), disk_cache_dir=cache)


@pytest.fixture()
def roots(tmp_path):
    return {"mvtec": make_mvtec(str(tmp_path / "mv"), n_train=3, n_test_good=2, n_broken=2,
                                size=48),
            "gear": make_gear(str(tmp_path / "gear"), n_per_split=3, size=48),
            "ksdd": make_kolektorsdd(str(tmp_path / "ksdd"), n_folders=3, per_folder=3)}


@pytest.mark.parametrize("kind", ["mvtec", "gear", "ksdd"])
def test_pack_round_trip_equals_the_direct_load(roots, tmp_path, kind):
    plain = _datasets(kind, roots[kind], "port", None)
    packed = _datasets(kind, roots[kind], "port", str(tmp_path / "cache"))
    assert plain._pack is None and packed._pack is not None and len(plain) == len(packed)
    for i in range(len(plain)):
        _same_sample(plain.load(i), packed.load(i))
    if kind != "mvtec":  # label maps ship as uint8
        assert packed.load(0)["mask"].dtype == np.uint8


def test_reopen_does_not_decode(mvtec_root, tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    first = MVTecDataset(mvtec_root, "bottle", "train", 32, disk_cache_dir=cache)
    ref = [first.load(i) for i in range(len(first))]

    def no_decode(self, idx):
        raise AssertionError("a reopened pack decoded a sample")

    monkeypatch.setattr(MVTecDataset, "_load_uncached", no_decode)
    again = MVTecDataset(mvtec_root, "bottle", "train", 32, disk_cache_dir=cache)
    for i, r in enumerate(ref):
        _same_sample(r, again.load(i))


def test_a_source_change_builds_a_new_pack(mvtec_root, tmp_path):
    cache = str(tmp_path / "cache")
    first = MVTecDataset(mvtec_root, "bottle", "train", 32, disk_cache_dir=cache)
    before = set(os.listdir(cache))
    os.utime(first.samples[0].image_path, (1234567890, 1234567890))
    second = MVTecDataset(mvtec_root, "bottle", "train", 32, disk_cache_dir=cache)
    assert second._pack is not None and set(os.listdir(cache)) > before
    MVTecDataset(mvtec_root, "bottle", "train", 24, disk_cache_dir=cache)  # another size
    assert len(os.listdir(cache)) == len(before) + 2


def test_fingerprint_sensitivity_and_parity(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello")
    fp = diskcache.fingerprint("tag", [str(p)])
    assert fp == jax_diskcache.fingerprint("tag", [str(p)])
    assert diskcache.fingerprint("tag2", [str(p)]) != fp
    assert diskcache.fingerprint("tag", [str(tmp_path / "missing")]) != fp
    p.write_bytes(b"hello!")
    assert diskcache.fingerprint("tag", [str(p)]) != fp


def test_empty_env_disables_the_default(mvtec_root, tmp_path, monkeypatch):
    # The suite runs with TPU_UNET_DATA_CACHE="" (tests/conftest.py).
    assert os.environ["TPU_UNET_DATA_CACHE"] == ""
    assert diskcache.default_cache_root() is None
    assert MVTecDataset(mvtec_root, "bottle", "train", 32)._pack is None
    monkeypatch.setenv("TPU_UNET_DATA_CACHE", str(tmp_path / "env"))
    assert diskcache.default_cache_root() == str(tmp_path / "env")
    assert MVTecDataset(mvtec_root, "bottle", "train", 32)._pack is not None
    assert len(os.listdir(tmp_path / "env")) == 1
    for off in ("0", "off"):
        monkeypatch.setenv("TPU_UNET_DATA_CACHE", off)
        assert diskcache.default_cache_root() is None


def test_a_failed_build_falls_back_to_decoding(mvtec_root, tmp_path, monkeypatch):
    logs = []

    def broken(i):
        raise OSError("unreadable")

    assert diskcache.PackedStore.open_or_build(str(tmp_path / "c"), "deadbeef", 3, broken,
                                               log=logs.append) is None
    assert logs and "continuing without it" in logs[0]
    assert os.listdir(tmp_path / "c") == []  # no partial build left
    # A dataset whose build fails decodes directly.
    monkeypatch.setattr(diskcache.PackedStore, "_build",
                        staticmethod(lambda *a: (_ for _ in ()).throw(OSError("disk full"))))
    ds = MVTecDataset(mvtec_root, "bottle", "train", 32, disk_cache_dir=str(tmp_path / "d"))
    assert ds._pack is None and ds.load(0)["image"].shape == (32, 32, 3)


def test_a_corrupt_pack_is_built_again(mvtec_root, tmp_path):
    cache = tmp_path / "cache"
    ds = MVTecDataset(mvtec_root, "bottle", "train", 32, disk_cache_dir=str(cache))
    ref = ds.load(1)
    (pack,) = cache.iterdir()
    (pack / "meta.json").write_text("{not json")
    again = MVTecDataset(mvtec_root, "bottle", "train", 32, disk_cache_dir=str(cache))
    _same_sample(ref, again.load(1))


@pytest.mark.parametrize("kind", ["mvtec", "gear", "ksdd"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_pack_serves_the_other_package(roots, tmp_path, monkeypatch, kind, writer):
    cache = str(tmp_path / "cache")
    reader = "port" if writer == "jax" else "jax"
    built = _datasets(kind, roots[kind], writer, cache)
    assert built._pack is not None
    (name,) = os.listdir(cache)
    files = {f: (tmp_path / "cache" / name / f).read_bytes()
             for f in os.listdir(os.path.join(cache, name))}
    reader_cls = type(_datasets(kind, roots[kind], reader, None))

    def no_decode(self, idx):
        raise AssertionError("the other package's pack was not used")

    monkeypatch.setattr(reader_cls, "_load_uncached", no_decode)
    opened = _datasets(kind, roots[kind], reader, cache)
    assert os.listdir(cache) == [name] and opened._pack is not None
    monkeypatch.undo()
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", True)
    monkeypatch.setattr(transforms, "_USE_NATIVE", True)
    direct = _datasets(kind, roots[kind], "port", None)
    for i in range(len(direct)):
        _same_sample(opened.load(i), direct.load(i))
    # Both packages write the same bytes.
    other = str(tmp_path / "other")
    _datasets(kind, roots[kind], reader, other)
    assert os.listdir(other) == [name]
    for f, data in files.items():
        assert (tmp_path / "other" / name / f).read_bytes() == data, f
