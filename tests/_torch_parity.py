"""Helpers shared by the port's training parity tests: rebuild the draws that
the JAX package's ``train_transform`` takes from a key, so that the same
draws go through both packages, and make seeded batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_unet_torch.ops.augment import AugmentDraws


def jax_draws(key, n, cfg):
    """The draws of ``tpu_unet.ops.augment.train_transform(..., key)`` under
    ``cfg`` (an AugmentConfig of either package), split by split:
    train_transform -> (k_geo, k_col); paired_geometric_augment ->
    (k_flip, k_rot); color_jitter -> (kb, kc, ks, kh, kperm)."""
    k_geo, k_col = jax.random.split(key)
    k_flip, k_rot = jax.random.split(k_geo)
    flip = jax.random.uniform(k_flip, (n,)) < cfg.p_flip
    shape = () if cfg.rotation_mode == "per_batch_shear" else (n,)
    d = cfg.degrees
    angle = (jax.random.uniform(k_rot, shape, minval=-d, maxval=d) if d > 0
             else jnp.zeros(shape))
    kb, kc, ks, kh, kperm = jax.random.split(k_col, 5)

    def u(k, shape, lo, hi):
        return torch.from_numpy(np.array(jax.random.uniform(k, shape, minval=lo, maxval=hi)))

    return AugmentDraws(
        flip=torch.from_numpy(np.array(flip)),
        angle=torch.from_numpy(np.array(angle, np.float32)),
        fb=u(kb, (n, 1, 1, 1), 1 - cfg.brightness, 1 + cfg.brightness),
        fc=u(kc, (n, 1, 1, 1), 1 - cfg.contrast, 1 + cfg.contrast),
        fs=u(ks, (n, 1, 1, 1), 1 - cfg.saturation, 1 + cfg.saturation),
        fh=u(kh, (n, 1, 1), -cfg.hue, cfg.hue),
        perm=int(jax.random.randint(kperm, (), 0, 24)))


def jax_accum_draws(key, n, cfg, grad_accum):
    """The draws of the JAX step's ``grad_accum`` scan: one key per microbatch."""
    return [jax_draws(k, n // grad_accum, cfg)
            for k in jax.random.split(key, grad_accum)]


def u8_batch(seed, n=4, hw=32, mask_dtype=np.float32):
    """Seeded uint8 images and binary (N, H, W, 1) masks."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(n, hw, hw, 1)) > 0.8).astype(mask_dtype)
    return img, mask



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests with one torch CPU thread, then restore the
    count. The suite runs in several worker processes at once, and PyTorch's
    thread pool, sized to every core in each of them, spends more time
    waiting on oversubscribed cores than computing these small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
