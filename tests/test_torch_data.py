"""The port's host input pipeline (tpu_unet_torch/data/) against the JAX
package's, on the CPU: MVTecDataset's index and samples, the loader's batch
order, drop_last, pad_last and valid rows [all exact], and ``to_device``."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import tpu_unet.data.transforms as jax_transforms
from test_data import make_mvtec
from tpu_unet.data.loader import DataLoader as JaxDataLoader
from tpu_unet.data.mvtec import MVTecDataset as JaxMVTec
from tpu_unet.data.mvtec import get_available_categories as jax_categories
from tpu_unet_torch.data.cache import SampleCache, cached_load
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.data.mvtec import MVTecDataset, get_available_categories, get_datasets
from tpu_unet_torch.data.transforms import load_mask, resize_mask_array


@pytest.fixture()
def mvtec_root(tmp_path, monkeypatch):
    # The JAX package resizes with its native resampler when it is built; the
    # port has PIL's path only, the JAX package's own under this switch.
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", False)
    root = make_mvtec(str(tmp_path), n_train=5, n_test_good=2, n_broken=3, size=40)
    # A second defect type, with an odd-shaped mask and one image lacking a mask.
    base = os.path.join(root, "bottle")
    rng = np.random.default_rng(9)
    os.makedirs(os.path.join(base, "test", "crack"))
    os.makedirs(os.path.join(base, "ground_truth", "crack"))
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
            os.path.join(base, "test", "crack", f"{i:03d}.png"))
    mask = np.zeros((40, 40), np.uint8)
    mask[5:23, 11:17] = 200
    Image.fromarray(mask).save(os.path.join(base, "ground_truth", "crack", "000_mask.png"))
    return root


def _same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("mask_resize", ["nearest", "bilinear"])
def test_mvtec_dataset_matches_jax(mvtec_root, split, mask_resize):
    ds = MVTecDataset(mvtec_root, "bottle", split, image_size=24,
                      is_train=split == "train", mask_resize=mask_resize)
    ref = JaxMVTec(mvtec_root, "bottle", split, image_size=24, is_train=split == "train",
                   disk_cache_dir=None, mask_resize=mask_resize)
    assert len(ds) == len(ref) == (5 if split == "train" else 7)
    assert [vars(s) for s in ds.samples] == [vars(r) for r in ref.samples]
    for i in range(len(ds)):
        _same_sample(ds.load(i), ref.load(i))
        assert ds.load(i) is ds.load(i)  # the second load is a cache hit


def test_masks_binarized_and_resized(mvtec_root):
    ds = MVTecDataset(mvtec_root, "bottle", "test", image_size=24, is_train=False)
    crack = [i for i, s in enumerate(ds.samples) if s.anomaly_type == "crack"]
    assert [ds.samples[i].mask_path is None for i in crack] == [False, True]
    m = ds.load(crack[0])["mask"]
    assert m.shape == (24, 24, 1) and m.dtype == np.float32 and set(np.unique(m)) == {0.0, 1.0}
    assert ds.load(crack[1])["mask"].max() == 0.0  # no mask file: a zero mask


def test_available_categories_match_jax(mvtec_root):
    os.makedirs(os.path.join(mvtec_root, "not_a_category"))
    os.makedirs(os.path.join(mvtec_root, ".hidden", "train"))
    assert get_available_categories(mvtec_root) == jax_categories(mvtec_root) == ["bottle"]
    assert get_available_categories(os.path.join(mvtec_root, "missing")) == []
    train, test = get_datasets(mvtec_root, "bottle", image_size=16)
    assert (len(train), len(test)) == (5, 7)


def test_disk_cache_and_bad_arguments_raise(mvtec_root):
    with pytest.raises(NotImplementedError):
        MVTecDataset(mvtec_root, "bottle", disk_cache_dir="auto")
    with pytest.raises(ValueError):
        MVTecDataset(mvtec_root, "bottle", "val")
    with pytest.raises(ValueError):
        MVTecDataset(mvtec_root, "bottle", mask_resize="area")


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("binarize", [True, False])
def test_load_mask_matches_jax(mvtec_root, method, binarize):
    path = os.path.join(mvtec_root, "bottle", "ground_truth", "crack", "000_mask.png")
    for size in ((24, 24), (40, 40), (17, 29)):
        np.testing.assert_array_equal(
            load_mask(path, size, binarize=binarize, method=method),
            jax_transforms.load_mask(path, size, binarize=binarize, method=method))


def test_resize_mask_array_matches_jax():
    m = np.random.default_rng(0).integers(0, 4, (13, 21), dtype=np.uint8)
    for size in ((13, 21), (8, 8), (30, 17)):
        np.testing.assert_array_equal(resize_mask_array(m, size),
                                      jax_transforms.resize_mask_array(m, size))


class _Toy:
    """An in-memory dataset: each sample's fields encode its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def load(self, i):
        return {"image": np.full((2, 3, 3), i, np.uint8),
                "mask": np.full((2, 3, 1), i % 3, np.float32),
                "label": np.int32(i % 2), "anomaly_type": f"t{i % 3}",
                "image_path": f"img_{i}.png"}


def _batches(loader, epochs=2):
    out = []
    for _ in range(epochs):
        out.append(list(loader))
    return out


LOADER_MODES = {
    "train": dict(shuffle=True, drop_last=True),
    "eval": dict(pad_last=True),
    "eval_shuffled": dict(shuffle=True, pad_last=True),
}


@pytest.mark.parametrize("mode", sorted(LOADER_MODES))
@pytest.mark.parametrize("seed", [0, 42])
def test_loader_batches_match_jax(mode, seed):
    """2 seeds x 2 epochs: the same batches in the same order, the same
    padded rows and valid masks."""
    ds = _Toy(23)
    kw = dict(batch_size=5, seed=seed, num_workers=3, **LOADER_MODES[mode])
    ours = _batches(DataLoader(ds, **kw))
    ref = _batches(JaxDataLoader(ds, process_count=1, process_index=0, **kw))
    assert len(ours[0]) == len(ref[0]) == (4 if mode == "train" else 5)
    for epoch_ours, epoch_ref in zip(ours, ref):
        for a, b in zip(epoch_ours, epoch_ref):
            _same_sample(a, b)
    if "pad_last" in LOADER_MODES[mode]:
        assert ours[0][-1]["valid"].tolist() == [True, True, True, False, False]
        assert ours[0][-1]["image_path"][-2:] == ["", ""]
    if LOADER_MODES[mode].get("shuffle"):  # a new order each epoch
        assert not np.array_equal(ours[0][0]["image"], ours[1][0]["image"])


def test_loader_epoch_counter_resumes_the_order():
    ds = _Toy(12)
    a = DataLoader(ds, 4, shuffle=True, seed=3, drop_last=True)
    list(a)
    second = [b["label"].tolist() + b["image"][:, 0, 0, 0].tolist() for b in a]
    b = DataLoader(ds, 4, shuffle=True, seed=3, drop_last=True)
    b.epoch = 1
    assert [x["label"].tolist() + x["image"][:, 0, 0, 0].tolist() for x in b] == second
    assert len(a) == 3 and a.epoch == 2


def test_loader_ragged_warns_and_rejects_both_flags():
    with pytest.raises(ValueError):
        DataLoader(_Toy(4), 3, drop_last=True, pad_last=True)
    with pytest.warns(UserWarning, match="final batch"):
        sizes = [len(b["image"]) for b in DataLoader(_Toy(7), 3)]
    assert sizes == [3, 3, 1]


def test_loader_transform_runs_per_batch():
    seen = []
    loader = DataLoader(_Toy(6), 2, transform=lambda b: seen.append(1) or b)
    assert len(list(loader)) == 3 and len(seen) == 3


def test_to_device_on_cpu_keeps_dtypes_and_shapes():
    batch = next(iter(DataLoader(_Toy(5), 4, pad_last=True)))
    out = to_device(batch, "cpu")
    for k in ("image", "mask", "label", "valid"):
        assert isinstance(out[k], torch.Tensor) and out[k].device.type == "cpu", k
        assert tuple(out[k].shape) == batch[k].shape, k
        np.testing.assert_array_equal(out[k].numpy(), batch[k], err_msg=k)
    assert out["image"].dtype == torch.uint8 and out["mask"].dtype == torch.float32
    assert out["label"].dtype == torch.int32 and out["valid"].dtype == torch.bool
    assert out["image_path"] == batch["image_path"]  # strings stay host lists
    u8 = to_device(batch, "cpu", mask_dtype=np.uint8)
    assert u8["mask"].dtype == torch.uint8 and u8["image"].dtype == torch.uint8
    again = to_device(out, "cpu")  # tensors pass through
    assert again["image"] is out["image"]


def test_sample_cache_budget():
    cache = SampleCache(max_bytes=100)
    small = {"a": np.zeros(60, np.uint8), "name": "x"}
    cache.put(0, small)
    cache.put(1, {"a": np.zeros(60, np.uint8)})  # over the budget: not kept
    cache.put(0, {"a": np.ones(10, np.uint8)})  # insert-once
    assert len(cache) == 1 and cache.nbytes == 60 and cache.get(0) is small
    calls = []
    assert cached_load(cache, 0, lambda: calls.append(1)) is small and not calls
    assert cached_load(None, 5, lambda: "fresh") == "fresh"
