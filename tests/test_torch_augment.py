"""The port's train-time augment (tpu_unet_torch/ops/augment.py,
ops/rotate_shear.py) against the JAX package's, on the CPU.

The JAX transforms draw from keys; ``_torch_parity.jax_draws`` rebuilds
those draws so that both packages see the same ones. Tolerances: images
atol 1e-5 (float32 ops in another order), masks exact (nearest sampling
only permutes values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.ops.augment as ja
import tpu_unet.ops.rotate_shear as jrs
import tpu_unet_torch.ops.augment as ta
import tpu_unet_torch.ops.rotate_shear as trs
from _torch_parity import jax_draws, u8_batch
from tpu_unet_torch.train.steps import AugmentConfig

MODES = ["per_batch_shear", "per_sample_shear", "per_sample"]


def _cfg(mode, random_order=False, **kw):
    return AugmentConfig(rotation_mode=mode, color_jitter_random_order=random_order, **kw)


@pytest.mark.parametrize("random_order", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_train_transform_matches_jax(mode, random_order):
    img, mask = u8_batch(seed=MODES.index(mode) + 10 * random_order)
    cfg = _cfg(mode, random_order)
    key = jax.random.key(5 + MODES.index(mode))
    ref_img, ref_mask = ja.train_transform(jnp.asarray(img), jnp.asarray(mask), key,
                                           **cfg.kwargs())
    draws = jax_draws(key, len(img), cfg)
    out_img, out_mask = ta.train_transform(torch.from_numpy(img), torch.from_numpy(mask),
                                           draws, **cfg.transform_kwargs())
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    assert out_mask.dtype == torch.float32
    assert 0 < float(out_mask.sum()) < out_mask.numel()  # masks moved, not emptied


def test_random_order_changes_the_result():
    """The random-order draw is used: two orders give different images."""
    img, _ = u8_batch(seed=3)
    x = ta.to_float(torch.from_numpy(img))
    draws = jax_draws(jax.random.key(0), len(img), _cfg("per_sample", True))
    outs = [ta.color_jitter(x, dataclasses.replace(draws, perm=p), random_order=True)
            for p in (0, 23)]
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("random_order", [False, True])
def test_color_jitter_matches_jax(random_order):
    img, _ = u8_batch(seed=7)
    x = np.array(ja.to_float(jnp.asarray(img)))
    key = jax.random.key(11)
    k_geo, k_col = jax.random.split(key)
    ref = ja.color_jitter(jnp.asarray(x), k_col, random_order=random_order)
    draws = jax_draws(key, len(img), _cfg("per_sample", random_order))
    out = ta.color_jitter(torch.from_numpy(x), draws, random_order=random_order)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_hsv_matches_jax_and_round_trips():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    x[0, 0, :4] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 0, 0], [0.2, 0.9, 0.9]]  # grey, black, ties
    h, s, v = ta._rgb_to_hsv(torch.from_numpy(x))
    jh, js, jv = ja._rgb_to_hsv(jnp.asarray(x))
    for a, b in ((h, jh), (s, js), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    back = ta._hsv_to_rgb(h, s, v)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), np.asarray(ja._hsv_to_rgb(jh, js, jv)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_uint8_masks_keep_their_dtype(mode):
    img, mask = u8_batch(seed=4, mask_dtype=np.uint8)
    cfg = _cfg(mode)
    draws = jax_draws(jax.random.key(2), len(img), cfg)
    _, m8 = ta.train_transform(torch.from_numpy(img), torch.from_numpy(mask), draws,
                               **cfg.transform_kwargs())
    _, m32 = ta.train_transform(torch.from_numpy(img),
                                torch.from_numpy(mask.astype(np.float32)), draws,
                                **cfg.transform_kwargs())
    assert m8.dtype == torch.uint8
    np.testing.assert_array_equal(m8.numpy().astype(np.float32), m32.numpy())


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shape", [(2, 24, 40, 3), (3, 70, 33, 1)])
def test_rotations_match_jax(shape, order):
    """The three rotations on their own, non-square shapes, both
    interpolation orders."""
    rng = np.random.default_rng(order)
    x = rng.uniform(size=shape).astype(np.float32)
    if order == 0:
        x = (x > 0.5).astype(np.float32)
    angles = rng.uniform(-10, 10, size=shape[0]).astype(np.float32)
    tx, ang = torch.from_numpy(x), torch.from_numpy(angles)
    jit = jax.jit  # one program each: faster on the CPU than op by op
    pairs = [
        (trs.rotate_batch_shear(tx, ang[0], 10.0, order),
         jit(jrs.rotate_batch_shear, static_argnums=(2, 3))(x, angles[0], 10.0, order)),
        (trs.rotate_batch_shear_per_sample(tx, ang, order),
         jit(jrs.rotate_batch_shear_per_sample, static_argnums=(2, 3))(x, angles, 10.0, order)),
        (ta.rotate_batch(tx, ang, order),
         jit(ja.rotate_batch, static_argnums=(2,))(x, angles, order)),
    ]
    for out, ref in pairs:
        if order == 0:
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        else:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("order", [0, 1])
def test_one_rotation_takes_a_shared_or_per_image_angle(order):
    """The gather rotation: an (N,) angle holding one value for every image
    rotates as the 0-dim angle does, bit for bit, a float image and a uint8
    mask alike."""
    rng = np.random.default_rng(11 + order)
    img = torch.from_numpy(rng.uniform(size=(3, 29, 41, 3)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(3, 29, 41, 1)) > 0.5).astype(np.uint8))
    shared = torch.tensor(-7.3)
    per_image = shared.expand(3).clone()
    for x in (img, mask):
        one = trs.rotate_batch_shear_per_sample(x, shared, order)
        each = trs.rotate_batch_shear_per_sample(x, per_image, order)
        assert torch.equal(one, each)
    if order == 0:
        assert trs.rotate_batch_shear_per_sample(mask, shared, order).dtype == torch.uint8


@pytest.mark.parametrize("mode,angle_shape", [("per_batch_shear", ()),
                                              ("per_sample", (6,))])
def test_sample_augment_draws(mode, angle_shape):
    cfg = _cfg(mode, random_order=True)
    draws = ta.sample_augment_draws(6, cfg, torch.Generator().manual_seed(0))
    again = ta.sample_augment_draws(6, cfg, torch.Generator().manual_seed(0))
    assert draws.flip.shape == (6,) and draws.flip.dtype == torch.bool
    assert draws.angle.shape == angle_shape
    assert float(draws.angle.abs().max()) <= cfg.degrees
    for f, x, shape in ((draws.fb, cfg.brightness, (6, 1, 1, 1)),
                        (draws.fc, cfg.contrast, (6, 1, 1, 1)),
                        (draws.fs, cfg.saturation, (6, 1, 1, 1))):
        assert f.shape == shape and float((f - 1).abs().max()) <= x
    assert draws.fh.shape == (6, 1, 1) and float(draws.fh.abs().max()) <= cfg.hue
    assert 0 <= draws.perm < 24
    for f in dataclasses.fields(draws):
        a, b = getattr(draws, f.name), getattr(again, f.name)
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_jax_draws_rebuild_the_keys_draws():
    """The helper's flip mask and angles are the ones the JAX augment uses:
    with jitter off, the JAX geometric augment of the batch equals the port's
    under the helper's draws, image and mask."""
    img, mask = u8_batch(seed=6)
    cfg = _cfg("per_sample", brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0)
    key = jax.random.key(21)
    ref_img, ref_mask = ja.train_transform(jnp.asarray(img), jnp.asarray(mask), key,
                                           **cfg.kwargs())
    draws = jax_draws(key, len(img), cfg)
    assert 0 < int(draws.flip.sum()) < len(img)
    out_img, out_mask = ta.train_transform(torch.from_numpy(img), torch.from_numpy(mask),
                                           draws, **cfg.transform_kwargs())
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
