"""The train augment's one-pass kernel (ops/kernels/augment.py, the operator
``torch.ops.tpu_unet_torch.augment_u8``, ``csrc/augment_u8.cu``) and its
routing in ``ops/augment.py::train_transform``.

On the CPU: the kernel's algorithm in plain PyTorch (``augment_u8_plain``)
against the composed ``train_transform`` over both shear modes, 0, 5 and 20
degrees, flips all, none and mixed, jitter on and every strength 0, a uint8,
a float32 and no mask, at odd sizes whose every stage crops; against the JAX
package's ``train_transform`` under the same draws (each JAX case compiles
its transform, 2-3 s); torch.library.opcheck and the fake shapes; the
routes ``COUNTERS`` counts; the wrapper's refusals. Masks compare exactly.
Images: under 'per_sample_shear' both paths rotate by the gathers of
``ops/rotate_shear.py`` and the geometry agrees bit for bit; under
'per_batch_shear' the composed path's shear matmuls round the two products
otherwise, and the geometry alone stays under 1e-6 (8.3e-7). The contrast
mean's float32 rounding differs by an ulp between the two paths, and the HSV
round trip turns an ulp of its input into up to 3.7e-6 of normalized output
(measured over these cases), so jitter-on cases hold 5e-6.
Against the JAX package the same two tolerances hold: over its cases the
largest gaps read 9.5e-7 with jitter off and 3.7e-6 with it on (the
composed path's gaps to JAX are the same).

On a CUDA card (``-m card``; skipped without one): the kernel against the
composed path at the three train cells' shapes, masks bit for bit; against
its plain version bit for bit where contrast is off (the contrast mean's
summation order is the kernel's own); the same output twice; the route
taken and counted. The JAX package is imported inside the tests that use
it, so on the card this file runs without the suite's conftest:

    python -m pytest --noconftest -m card tests/test_torch_augment_fused.py
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import tpu_unet_torch.ops.augment as ta
from tpu_unet_torch.ops.kernels import augment as ka
from tpu_unet_torch.train.steps import AugmentConfig
from tpu_unet_torch.utils import spans

MODES = ["per_batch_shear", "per_sample_shear"]
SHAPES = [(2, 37, 53), (2, 64, 48)]
JITTER = {"on": {}, "off": dict(brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)}
ATOL = {"on": 5e-6, "off": 1e-6}


def _cfg(mode, degrees, jitter, p_flip=0.5):
    return AugmentConfig(rotation_mode=mode, degrees=degrees, p_flip=p_flip, **JITTER[jitter])


def _kwargs(cfg):
    kw = cfg.transform_kwargs()
    del kw["color_jitter_random_order"]
    return kw


def _batch(seed, n, h, w, mask, device="cpu"):
    """uint8 images and a mask of ``mask`` kind: 'u8' class ids 0-2 in blocks,
    'f32' a binary float32 mask, 'none'."""
    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8)
    ids = torch.randint(0, 3, (n, -(-h // 4), -(-w // 4), 1), generator=g, dtype=torch.uint8)
    ids = ids.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :h, :w]
    m = {"u8": ids, "f32": (ids > 0).to(torch.float32), "none": None}[mask]
    return img.to(device), None if m is None else m.to(device)


def _draws(n, cfg, flip, seed, device="cpu"):
    d = ta.sample_augment_draws(n, cfg, torch.Generator().manual_seed(seed))
    flips = {"all": torch.ones(n, dtype=torch.bool), "none": torch.zeros(n, dtype=torch.bool),
             "mixed": torch.arange(n) % 2 == 0}[flip]
    return dataclasses.replace(d, flip=flips).to(device)


def _assert_images_close(got, want, atol):
    err = float((got - want).abs().max())
    assert err <= atol, f"images differ by {err:.3g} (atol {atol:.1g})"


CASES = list(itertools.product(MODES, [0.0, 5.0, 20.0], ["all", "none", "mixed"],
                               ["on", "off"], ["u8", "f32", "none"]))


@pytest.mark.parametrize("mode,degrees,flip,jitter,mask", CASES)
def test_plain_version_matches_the_composed_transform(mode, degrees, flip, jitter, mask):
    shape = SHAPES[CASES.index((mode, degrees, flip, jitter, mask)) % 2]
    img, m = _batch(int(degrees) + len(flip), *shape, mask)
    cfg = _cfg(mode, degrees, jitter)
    draws = _draws(shape[0], cfg, flip, seed=int(degrees))
    want_img, want_mask = ta.train_transform_composed(img, m, draws, **cfg.transform_kwargs())
    got_img, got_mask = ka.augment_u8_plain(img, m, draws, **_kwargs(cfg))
    assert got_img.dtype == torch.float32 and got_img.shape == img.shape
    _assert_images_close(got_img, want_img, ATOL[jitter])
    if m is None:
        assert got_mask is None and want_mask is None
    else:
        assert got_mask.dtype == m.dtype
        assert torch.equal(got_mask, want_mask)
        if degrees > 0:  # every stage crops: pixels come in from outside
            assert (got_mask == 0).any() and not torch.equal(got_mask, m)


JAX_CASES = [("per_batch_shear", 0.0, "on", "u8", 0), ("per_batch_shear", 5.0, "on", "f32", 1),
             ("per_batch_shear", 20.0, "off", "u8", 0), ("per_sample_shear", 5.0, "off", "f32", 1),
             ("per_sample_shear", 20.0, "on", "u8", 0), ("per_sample_shear", 20.0, "on", "none", 1)]


@pytest.mark.parametrize("mode,degrees,jitter,mask,shape", JAX_CASES)
def test_plain_version_matches_the_jax_transform(mode, degrees, jitter, mask, shape):
    import jax
    import jax.numpy as jnp

    import tpu_unet.ops.augment as ja
    from _torch_parity import jax_draws

    n, h, w = SHAPES[shape]
    img, m = _batch(7 + shape, n, h, w, mask)
    cfg = _cfg(mode, degrees, jitter)
    key = next(k for k in map(jax.random.key, range(100))  # one image flipped, one not
               if 0 < int(jax_draws(k, n, cfg).flip.sum()) < n)
    jm = None if m is None else jnp.asarray(m.to(torch.float32).numpy())
    run = jax.jit(lambda i, mm, k: ja.train_transform(i, mm, k, **cfg.kwargs()))
    ref_img, ref_mask = run(jnp.asarray(img.numpy()), jm, key)
    got_img, got_mask = ka.augment_u8_plain(img, m, jax_draws(key, n, cfg), **_kwargs(cfg))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(ref_img), rtol=0,
                               atol=ATOL[jitter])
    if m is not None:
        np.testing.assert_array_equal(got_mask.to(torch.float32).numpy(), np.asarray(ref_mask))


def test_contrast_mean_is_the_block_partials_sum():
    """The plain version's contrast mean is the sum of per-block partial sums
    (an image of 3 blocks, the last one ragged) and agrees with the composed
    path's mean to float32 rounding."""
    n, h, w = 2, 40, 60  # 2400 pixels: blocks of 1024, 1024 and 352
    img, _ = _batch(3, n, h, w, "none")
    cfg = AugmentConfig(rotation_mode="per_batch_shear", degrees=0.0, brightness=0.0,
                        contrast=0.5, saturation=0.0, hue=0.0)
    draws = _draws(n, cfg, "none", seed=2)
    got, _ = ka.augment_u8_plain(img, None, draws, **_kwargs(cfg))
    want, _ = ta.train_transform_composed(img, None, draws, **cfg.transform_kwargs())
    _assert_images_close(got, want, 1e-6)
    assert -(-h * w // ka.BLOCK_PIXELS) == 3


@pytest.mark.parametrize("mode", MODES)
def test_opcheck(mode):
    img, m = _batch(1, 2, 9, 13, "u8")
    d = _draws(2, _cfg(mode, 10.0, "on"), "mixed", seed=1)
    for masks in (m, None):
        torch.library.opcheck(ka._augment_u8_op, (img, masks, d.flip, d.angle, d.fb, d.fc, d.fs,
                                                  d.fh, 10.0, 0.1, 0.1, 0.1, 0.05,
                                                  mode == "per_sample_shear"))


def test_fake_shapes_equal_the_real_outputs():
    img, m = _batch(2, 2, 12, 10, "f32")
    d = _draws(2, _cfg("per_batch_shear", 5.0, "on"), "mixed", seed=3)
    real = ka.augment_u8(img, m, d, **_kwargs(_cfg("per_batch_shear", 5.0, "on")))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = ka.augment_u8(mode.from_tensor(img), mode.from_tensor(m), d,
                             **_kwargs(_cfg("per_batch_shear", 5.0, "on")))
    for f, r in zip(fake, real):
        assert f.shape == r.shape and f.dtype == r.dtype


def test_the_wrapper_runs_the_plain_version_on_cpu_counts_no_launch_and_records_a_span():
    img, m = _batch(4, 2, 16, 24, "u8")
    cfg = _cfg("per_sample_shear", 20.0, "on")
    d = _draws(2, cfg, "mixed", seed=4)
    before = ka.augment_u8.launches
    spans.clear()
    with spans.recording():
        got = ka.augment_u8(img, m, d, **_kwargs(cfg))
    want = ka.augment_u8_plain(img, m, d, **_kwargs(cfg))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ka.augment_u8.launches == before
    assert [s.name for s in spans.recorded()] == ["kernel.augment"]
    spans.clear()


def test_the_wrapper_refuses_what_it_cannot_take():
    img, m = _batch(5, 2, 8, 8, "u8")
    cfg = _cfg("per_batch_shear", 10.0, "on")
    kw = _kwargs(cfg)
    d = _draws(2, cfg, "mixed", seed=5)
    with pytest.raises(TypeError, match="uint8 images"):
        ka.augment_u8(img.to(torch.float32), m, d, **kw)
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\) images"):
        ka.augment_u8(img[..., :2], m, d, **kw)
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\) images"):
        ka.augment_u8(img[0], m, d, **kw)
    with pytest.raises(TypeError, match="uint8 or float32 mask"):
        ka.augment_u8(img, m.to(torch.int64), d, **kw)
    with pytest.raises(ValueError, match="mask"):
        ka.augment_u8(img, m[:, :7], d, **kw)
    with pytest.raises(ValueError, match="mask"):
        ka.augment_u8(img, m[..., 0], d, **kw)
    with pytest.raises(ValueError, match="rotation_mode"):
        ka.augment_u8(img, m, d, **{**kw, "rotation_mode": "per_sample"})
    with pytest.raises(ValueError, match="angle of shape"):
        ka.augment_u8(img, m, dataclasses.replace(d, angle=torch.zeros(2)), **kw)
    with pytest.raises(ValueError, match="angle of shape"):
        ka.augment_u8(img, m, d, **{**kw, "rotation_mode": "per_sample_shear"})
    with pytest.raises(ValueError, match="flip"):
        ka.augment_u8(img, m, dataclasses.replace(d, flip=d.flip.to(torch.uint8)), **kw)
    with pytest.raises(ValueError, match="fc"):
        ka.augment_u8(img, m, dataclasses.replace(d, fc=d.fc[:1]), **kw)


def _fake_cuda(img, m):
    mode = FakeTensorMode()
    with mode:
        fi = torch.empty(img.shape, dtype=img.dtype, device="cuda")
        fm = None if m is None else torch.empty(m.shape, dtype=m.dtype, device="cuda")
    return fi, fm


@pytest.mark.parametrize("mode,random_order,mask,want", [
    ("per_batch_shear", False, "u8", True), ("per_sample_shear", False, "f32", True),
    ("per_batch_shear", False, "none", True), ("per_sample", False, "u8", False),
    ("per_batch_shear", True, "u8", False), ("per_sample_shear", True, "none", False)])
def test_the_route_on_cuda_tensors(mode, random_order, mask, want):
    """The kernel takes CUDA uint8 images under the shear modes and the fixed
    jitter order; 'per_sample' and random order keep the composed ops."""
    assert ka.takes(*_fake_cuda(*_batch(0, 2, 8, 8, mask)), mode, random_order) is want


def test_the_route_refuses_other_inputs_on_cuda():
    img, m = _batch(0, 2, 8, 8, "u8")
    assert ka.takes(*_fake_cuda(img, m), "per_batch_shear", False)
    for other in ((img.to(torch.float32), m), (img[..., :1], m), (img[0], m),
                  (img, m.to(torch.int64)), (img, m[:, :4]), (img, m[..., 0])):
        assert not ka.takes(*_fake_cuda(*other), "per_batch_shear", False)
    fake_img, _ = _fake_cuda(img, m)
    assert not ka.takes(fake_img, m, "per_batch_shear", False)  # the mask on the CPU
    assert not ka.takes(img, m, "per_batch_shear", False)  # CPU images


@pytest.mark.parametrize("mode,random_order", [("per_batch_shear", False),
                                               ("per_sample_shear", False),
                                               ("per_sample", False), ("per_batch_shear", True)])
def test_cpu_calls_take_the_composed_route_and_count_it(mode, random_order):
    img, m = _batch(6, 2, 16, 16, "u8")
    cfg = AugmentConfig(rotation_mode=mode, color_jitter_random_order=random_order)
    d = _draws(2, cfg, "mixed", seed=6)
    ta.COUNTERS.update(fused=0, composed=0)
    got = ta.train_transform(img, m, d, **cfg.transform_kwargs())
    want = ta.train_transform_composed(img, m, d, **cfg.transform_kwargs())
    assert ta.COUNTERS == {"fused": 0, "composed": 1}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_a_fused_route_runs_the_operator_and_counts_it(monkeypatch):
    """train_transform hands a call the route takes to the operator (here its
    CPU body) with every keyword, and counts it."""
    img, m = _batch(8, 2, 20, 12, "f32")
    cfg = _cfg("per_sample_shear", 15.0, "on")
    d = _draws(2, cfg, "mixed", seed=8)
    monkeypatch.setattr(ka, "takes", lambda *a: True)
    ta.COUNTERS.update(fused=0, composed=0)
    got = ta.train_transform(img, m, d, **cfg.transform_kwargs())
    want = ka.augment_u8_plain(img, m, d, **_kwargs(cfg))
    assert ta.COUNTERS == {"fused": 1, "composed": 0}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# The train cells' shapes and augments: seg b8 1024x512 at 5 degrees, TransUNet
# b16 1024x512 at 20 degrees without jitter, anomaly b16 256x256 at 10 degrees.
# Under 'per_batch_shear' the composed path's shear matmuls (cuBLAS) round the
# two products otherwise: the geometry alone reads 1.19e-6 at TransUNet's
# shape. Under 'per_sample_shear' it rotates by the gathers the kernel computes.
CARD_ATOL = {"on": 5e-6, "off": 2e-6}
CARD_CASES = [((8, 1024, 512), 5.0, "on", "u8"), ((16, 1024, 512), 20.0, "off", "u8"),
              ((16, 256, 256), 10.0, "on", "u8"), ((16, 256, 256), 10.0, "on", "f32"),
              ((3, 37, 53), 20.0, "on", "none"), ((2, 64, 48), 0.0, "on", "u8")]


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,degrees,jitter,mask", CARD_CASES)
def test_the_kernel_matches_the_composed_path_on_the_card(shape, degrees, jitter, mask, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img, m = _batch(shape[1] + int(degrees), *shape, mask, device="cuda")
    cfg = _cfg(mode, degrees, jitter)
    d = _draws(shape[0], cfg, "mixed", seed=shape[0], device="cuda")
    ta.COUNTERS.update(fused=0, composed=0)
    before = ka.augment_u8.launches
    got_img, got_mask = ta.train_transform(img, m, d, **cfg.transform_kwargs())
    again = ta.train_transform(img, m, d, **cfg.transform_kwargs())
    torch.cuda.synchronize()
    assert ta.COUNTERS == {"fused": 2, "composed": 0}
    assert ka.augment_u8.launches == before + 2 * (1 + (cfg.contrast > 0))  # geometry, jitter
    assert torch.equal(got_img, again[0]), "two runs differ"
    plain_img, plain_mask = ka.augment_u8_plain(img, m, d, **_kwargs(cfg))
    if not cfg.contrast > 0:
        diff = int((got_img != plain_img).sum())
        assert diff == 0, f"{diff} values differ from the plain version"
    want_img, want_mask = ta.train_transform_composed(img, m, d, **cfg.transform_kwargs())
    _assert_images_close(got_img, want_img, CARD_ATOL[jitter])
    if m is not None:
        assert got_mask.dtype == m.dtype
        assert torch.equal(got_mask, want_mask) and torch.equal(got_mask, plain_mask)
        assert torch.equal(got_mask, again[1])
