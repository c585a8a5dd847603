"""The port's native loader core (tpu_unet_torch/data/native.py over
tpu_unet_torch/csrc/loader_core.cpp) against the JAX package's
(tpu_unet/data/native.py), on the CPU: both are built from the same code
with the same flags on this host, so their resizes agree bit for bit; the
area mode stays within 1 LSB of PIL's BILINEAR. Also the port's
``load_image_rgb`` and ``resize_backend_tag`` against the JAX module's, and
a failed build, which raises instead of falling back to PIL."""

import re

import numpy as np
import pytest
from PIL import Image, ImageDraw

import tpu_unet.data.transforms as jax_transforms
from tpu_unet.data import native as jax_native
from tpu_unet_torch.data import native
from tpu_unet_torch.data import transforms

_REPO = native.SOURCE.parents[2]

SHAPES = [  # (src H, W), (dst H, W)
    ((900, 900), (256, 256)),  # MVTec's downscale
    ((20, 30), (64, 64)),  # upscale
    ((131, 57), (48, 33)),  # odd sizes
    ((64, 64), (64, 32)),  # one axis only
]


def _code(path):
    """A C++ source without its comments and blank lines."""
    src = re.sub(r"//[^\n]*", "", path.read_text())
    return [line.rstrip() for line in src.splitlines() if line.strip()]


def test_the_copy_has_the_jax_package_code():
    assert _code(native.SOURCE) == _code(_REPO / "native" / "loader_core.cpp")
    assert native.get_lib().tu_version() == native.EXPECTED_VERSION == 2


@pytest.mark.parametrize("mode", ["area", "bilinear", "nearest"])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_the_jax_package(mode, channels):
    assert jax_native.available(), "the JAX package's loader core did not build"
    rng = np.random.default_rng(channels)
    for (sh, sw), out_hw in SHAPES:
        shape = (sh, sw) if channels == 1 else (sh, sw, channels)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = native.resize_u8(img, out_hw, mode)
        assert got.shape == out_hw + shape[2:] and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_native.resize_u8(img, out_hw, mode),
                                      err_msg=f"{shape} -> {out_hw}")


@pytest.mark.parametrize("n_threads", [1, 3])
def test_batch_entry_equals_per_image_calls(n_threads):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (5, 90, 70, 3), dtype=np.uint8)
    batch = native.resize_u8_batch(imgs, (32, 24), "area", n_threads=n_threads)
    for i in range(len(imgs)):
        np.testing.assert_array_equal(batch[i], native.resize_u8(imgs[i], (32, 24)))
    gray = native.resize_u8_batch(imgs[..., 0], (32, 24), "nearest")
    assert gray.shape == (5, 32, 24)
    np.testing.assert_array_equal(gray[2], native.resize_u8(imgs[2, ..., 0], (32, 24),
                                                            "nearest"))
    np.testing.assert_array_equal(native.resize_u8_batch(imgs, (90, 70)), imgs)


def test_area_is_within_one_lsb_of_pil_bilinear():
    rng = np.random.default_rng(3)
    for (sh, sw), (dh, dw) in SHAPES:
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        pil = np.asarray(Image.fromarray(img).resize((dw, dh), Image.BILINEAR), np.uint8)
        d = np.abs(native.resize_u8(img, (dh, dw)).astype(np.int16) - pil.astype(np.int16))
        assert d.max() <= 1, ((sh, sw), (dh, dw), d.max())


def test_nearest_keeps_label_values():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 4, (10, 13), dtype=np.uint8)
    for out_hw in ((20, 26), (7, 5)):
        out = native.resize_u8(labels, out_hw, "nearest")
        assert out.shape == out_hw and set(np.unique(out)) <= set(np.unique(labels))
    np.testing.assert_array_equal(native.resize_u8(labels, (10, 13)), labels)


def test_fill_polygon_equals_the_jax_package_and_pil_inside():
    for pts in ([(5.0, 5.0), (30.0, 8.0), (20.0, 35.0)],
                [(2.5, 3.0), (37.0, 3.0), (37.0, 30.5), (20.0, 12.0), (2.5, 30.5)]):
        ours, theirs = np.zeros((40, 40), np.uint8), np.zeros((40, 40), np.uint8)
        native.fill_polygon(ours, pts, value=3)
        jax_native.fill_polygon(theirs, pts, value=3)
        np.testing.assert_array_equal(ours, theirs)
        im = Image.new("L", (40, 40), 0)
        ImageDraw.Draw(im).polygon(pts, fill=3)
        pil = np.asarray(im)
        core = pil[1:-1, 1:-1] & pil[:-2, 1:-1] & pil[2:, 1:-1] & pil[1:-1, :-2] & pil[1:-1, 2:]
        assert np.all(ours[1:-1, 1:-1][core.astype(bool)] == 3)
    with pytest.raises(ValueError):
        native.fill_polygon(np.zeros((4, 4), np.int32), [(0, 0), (3, 0), (3, 3)])


@pytest.mark.parametrize("size_hw", [(32, 32), (24, 40), (90, 70)])
def test_load_image_rgb_equals_the_jax_package_natively(tmp_path, monkeypatch, size_hw):
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", True)
    monkeypatch.setattr(transforms, "_USE_NATIVE", True)
    img = np.random.default_rng(4).integers(0, 256, (90, 70, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(img).save(path)
    got = transforms.load_image_rgb(path, size_hw)
    np.testing.assert_array_equal(got, jax_transforms.load_image_rgb(path, size_hw))
    pil = np.asarray(Image.open(path).convert("RGB").resize(size_hw[::-1], Image.BILINEAR))
    assert np.abs(got.astype(np.int16) - pil.astype(np.int16)).max() <= 1
    monkeypatch.setattr(transforms, "_USE_NATIVE", False)
    np.testing.assert_array_equal(transforms.load_image_rgb(path, size_hw), pil)


@pytest.mark.parametrize("use_native", [True, False])
def test_resize_backend_tag_names_the_jax_strings(monkeypatch, use_native):
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", use_native)
    monkeypatch.setattr(transforms, "_USE_NATIVE", use_native)
    assert transforms.resize_backend_tag() == jax_transforms.resize_backend_tag()
    assert transforms.resize_backend_tag() == ("native-area-v2" if use_native
                                               else "pil-bilinear")


def test_a_failed_build_raises_and_names_the_switch(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="TPU_UNET_NATIVE_RESIZE=0") as err:
        native.resize_u8(np.zeros((8, 8, 3), np.uint8), (4, 4))
    assert "no-such-compiler" in str(err.value)
    assert not native.available()
    monkeypatch.setattr(transforms, "_USE_NATIVE", True)
    with pytest.raises(RuntimeError, match="TPU_UNET_NATIVE_RESIZE"):
        transforms.resize_backend_tag()
    assert not list((tmp_path / "build").glob("*.so"))  # no partial library left


def test_build_goes_to_a_file_named_by_the_source_and_flags(tmp_path):
    first = native.build(tmp_path)
    assert first["seconds"] > 0 and first["path"] == str(native.library_path(tmp_path))
    again = native.build(tmp_path)
    assert again["seconds"] == 0.0 and again["path"] == first["path"]
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path(tmp_path).name]
