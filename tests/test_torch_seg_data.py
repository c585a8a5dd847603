"""The port's Gear and KolektorSDD datasets (tpu_unet_torch/data/gear.py,
kolektorsdd.py) against the JAX package's, on synthetic trees: the index
order, the rasterized label maps with priority overlap resolution, the
KolektorSDD split membership and every sample's bytes [exact]."""

import os

import numpy as np
import pytest

import tpu_unet.data.transforms as jax_transforms
import tpu_unet_torch.data.transforms as port_transforms
from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_data import make_gear, make_kolektorsdd
from tpu_unet.data import gear as jgear
from tpu_unet.data import kolektorsdd as jksdd
from tpu_unet_torch.data import gear as tgear
from tpu_unet_torch.data import kolektorsdd as tksdd
from tpu_unet_torch.data.loader import DataLoader


@pytest.fixture(autouse=True)
def _pil_resize(monkeypatch):
    """Both packages on PIL's resampler, like against like
    (tests/test_torch_native.py holds the native resamplers together)."""
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", False)
    monkeypatch.setattr(port_transforms, "_USE_NATIVE", False)


@pytest.fixture(scope="module")
def gear_root(tmp_path_factory):
    return make_gear(str(tmp_path_factory.mktemp("gear")), n_per_split=3, size=48)


@pytest.fixture(scope="module")
def ksdd_root(tmp_path_factory):
    root = make_kolektorsdd(str(tmp_path_factory.mktemp("ksdd")), n_folders=5, per_folder=4)
    # A mask value above 2 (the real set's 255) is clipped to class 2.
    from PIL import Image
    path = os.path.join(root, "kos00", "Part0_label.bmp")
    mask = np.asarray(Image.open(path)).copy()
    mask[30:34, 2:6] = 255
    Image.fromarray(mask).save(path)
    return root


def _same_samples(port, jax_ds):
    assert len(port) == len(jax_ds) > 0
    for i in range(len(port)):
        a, b = port.load(i), jax_ds.load(i)
        assert set(a) == set(b) == {"image", "mask", "image_path"}
        assert a["image_path"] == b["image_path"]
        for k in ("image", "mask"):
            assert a[k].dtype == b[k].dtype == np.uint8, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {i}")


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("size", [(48, 48), (32, 40)])
def test_gear_matches_jax(gear_root, split, size):
    port = tgear.GearDataset(gear_root, split, size)
    ref = jgear.GearDataset(gear_root, split, size, disk_cache_dir=None)
    assert port.image_paths == ref.image_paths and port.label_paths == ref.label_paths
    assert port.class_names == ref.class_names == ["pitting", "spalling", "scrape"]
    assert port.num_classes == ref.num_classes == 4
    _same_samples(port, ref)
    assert port.load(0)["mask"].shape == size


def test_rasterize_resolves_overlaps_by_priority(gear_root, tmp_path):
    """scrape < pitting < spalling: spalling's square wins where it overlaps
    pitting's; the same bytes and statistics as JAX's."""
    label = os.path.join(gear_root, "labels", "train", "0.txt")
    stats = {"files_processed": 0, "files_with_overlaps": 0,
             "pixels_resolved": {"spalling_over_pitting": 0, "spalling_over_scrape": 0,
                                 "pitting_over_scrape": 0}}
    jstats = {**stats, "pixels_resolved": dict(stats["pixels_resolved"])}
    got = tgear.rasterize_labelme(label, 50, 40, stats)
    want = jgear.rasterize_labelme(label, 50, 40, jstats)
    np.testing.assert_array_equal(got, want)
    assert stats == jstats and stats["pixels_resolved"]["spalling_over_pitting"] > 0
    assert got[int(0.4 * 40), int(0.4 * 50)] == 2  # the overlap is spalling's
    assert set(np.unique(got)) == {0, 1, 2, 3}
    bad = tmp_path / "bad.txt"
    bad.write_text("x 0.1 0.1 0.2\n0 0.1 0.1 0.5 0.5\n1 bad coords 0.1 0.2\n")
    assert tgear.parse_label_file(str(bad)) == jgear.parse_label_file(str(bad))


def test_gear_class_count_covers_the_highest_id(tmp_path):
    """A split with scrape but no spalling still has 4 classes (ids are fixed)."""
    root = make_gear(str(tmp_path / "g"), n_per_split=1, size=32)
    for split in ("train", "val", "test"):
        with open(os.path.join(root, "labels", split, "0.txt"), "w") as f:
            f.write("2 0.1 0.1 0.5 0.1 0.5 0.5\n")
    ds = tgear.GearDataset(root, "train", (32, 32))
    assert ds.num_classes == jgear.GearDataset(root, "train", (32, 32),
                                               disk_cache_dir=None).num_classes == 4
    assert ds.class_names == ["scrape"]


def test_gear_priority_logging_and_mask_memo(gear_root, capsys):
    ds = tgear.GearDataset(gear_root, "val", (48, 48), enable_priority_logging=True,
                           cache_samples=False)
    ds.load(0)
    ds.load(0)  # the memoized mask: rasterized once
    assert ds.priority_stats["files_processed"] == 1
    ds.print_priority_stats()
    assert "overlaps resolved: 1/1" in capsys.readouterr().out
    train, val, test, n = tgear.get_datasets(gear_root, (48, 48))
    assert (len(train), len(val), len(test), n) == (3, 3, 3, 4)
    with pytest.raises(ValueError):
        tgear.GearDataset(gear_root, "missing")


@pytest.mark.parametrize("fractions", [(0.7, 0.15), (0.5, 0.25)])
def test_kolektorsdd_split_membership_matches_jax(ksdd_root, fractions):
    for split in ("train", "val", "test"):
        assert (tksdd.build_split(ksdd_root, split, *fractions)
                == jksdd.build_split(ksdd_root, split, *fractions))
    splits = [set(tksdd.build_split(ksdd_root, s, *fractions)) for s in ("train", "val", "test")]
    assert sum(map(len, splits)) == 20 and not (splits[0] & splits[1] or splits[1] & splits[2])
    with pytest.raises(ValueError):
        tksdd.build_split(ksdd_root, "holdout")
    with pytest.raises(ValueError):
        tksdd.build_split(os.path.join(ksdd_root, "nope"), "train")


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_kolektorsdd_samples_match_jax(ksdd_root, split):
    port = tksdd.KolektorSDDDataset(ksdd_root, split, (64, 32))
    ref = jksdd.KolektorSDDDataset(ksdd_root, split, (64, 32), disk_cache_dir=None)
    assert port.class_names == ref.class_names and port.num_classes == 3
    _same_samples(port, ref)


def test_kolektorsdd_masks_are_clipped_and_resized(ksdd_root):
    train, val, test, n = tksdd.get_datasets(ksdd_root, (32, 16))
    assert n == 3 and len(train) + len(val) + len(test) == 20
    masks = [ds.load(i)["mask"] for ds in (train, val, test) for i in range(len(ds))]
    assert all(m.shape == (32, 16) for m in masks)
    assert set(np.unique(np.concatenate([m.ravel() for m in masks]))) == {0, 1, 2}


@pytest.mark.parametrize("make", ["gear", "ksdd"])
def test_disk_cache_is_ported(gear_root, ksdd_root, make, tmp_path):
    """The packed store is ported: a pack of each dataset serves the JAX
    package's direct decode, sample for sample."""
    cache = str(tmp_path / "packs")
    if make == "gear":
        port = tgear.GearDataset(gear_root, "train", (32, 32), disk_cache_dir=cache)
        ref = jgear.GearDataset(gear_root, "train", (32, 32), disk_cache_dir=None)
    else:
        port = tksdd.KolektorSDDDataset(ksdd_root, "train", (32, 16), disk_cache_dir=cache)
        ref = jksdd.KolektorSDDDataset(ksdd_root, "train", (32, 16), disk_cache_dir=None)
    assert port._pack is not None and len(os.listdir(cache)) == 1
    _same_samples(port, ref)


def test_loader_batches_uint8_labels(ksdd_root):
    ds = tksdd.KolektorSDDDataset(ksdd_root, "val", (64, 32))
    batch = next(iter(DataLoader(ds, batch_size=2, pad_last=True, num_workers=1)))
    assert batch["mask"].dtype == np.uint8 and batch["mask"].shape == (2, 64, 32)
    assert batch["image"].shape == (2, 64, 32, 3) and len(batch["image_path"]) == 2
