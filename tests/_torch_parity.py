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


def seg_batch(seed, n=4, h=64, w=32, num_classes=3):
    """Seeded uint8 images and uint8 (N, H, W) class-id labels: a background
    with a rectangle of each defect class per image, overlapping."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    labels = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        for c in range(1, num_classes):
            y, x = rng.integers(0, h - h // 3), rng.integers(0, w - w // 3)
            labels[i, y:y + h // 3, x:x + w // 3] = c
    return img, labels


def jax_dropout_keep(apply_fn, variables, shape, k_drop):
    """The bottleneck dropout's (N, C5) keep mask that a JAX train-mode apply
    of SegmentationUNet, AttentionUNet or UNetPlusPlus draws from dropout key
    ``k_drop`` for an input of ``shape`` (N, H, W, 3), as a bool tensor.

    flax derives the mask from the key, the module path and the shape, not
    from the values, so it is read from one apply (``capture_intermediates``)
    instead of drawn again: on zeros, with the bias of the bottleneck's last
    BatchNorm (``encoder/down4/conv/bn2``, UNet++'s ``x4_0/bn2``) raised so
    that every bottleneck value is positive, a channel is kept exactly where
    ``bottleneck_dropout``'s output is nonzero."""
    params = jax.tree_util.tree_map(lambda x: x, variables["params"])
    node = params["x4_0"] if "x4_0" in params else params["encoder"]["down4"]["conv"]
    node["bn2"] = {**node["bn2"], "bias": node["bn2"]["bias"] + 1e3}
    _, mut = apply_fn({**variables, "params": params}, jnp.zeros(shape), train=True,
                      rngs={"dropout": k_drop}, mutable=["batch_stats", "intermediates"],
                      capture_intermediates=True)
    dropped = np.asarray(mut["intermediates"]["bottleneck_dropout"]["__call__"][0])
    return torch.from_numpy((dropped != 0).any(axis=(1, 2)))



def run_recording(exc, x, plan):
    """Drive an int8 executor of either package (``_QuantExec`` or
    ``_CalibExec``) through a plan as its ``_run`` does, keeping every op's
    output by name."""
    env = {}
    for op in plan:
        kind = op[0]
        if kind == "input":
            env[op[1]] = exc.input(x)
        elif kind == "double_conv":
            env[op[1]] = exc.double_conv(env[op[2]], op[3])
        elif kind == "maxpool":
            env[op[1]] = exc.maxpool(env[op[2]])
        elif kind == "up_block":
            env[op[1]] = exc.up_block(env[op[2]], env[op[3]], op[4], gated=op[5])
        elif kind == "fuse":
            env[op[1]] = exc.fuse(env[op[2]], [env[r] for r in op[3]], op[4])
        elif kind == "head":
            env[op[1]] = exc.head(env[op[2]], op[3], op[4])
        elif kind == "average":
            outs = [env[r] for r in op[2]]
            env[op[1]] = sum(outs) / len(outs)
    return env


def assert_int8_envs_equal(port_env, jax_env):
    """Every int8 activation (and its scale) of two recorded runs bit for
    bit, the float32 head outputs within 1e-5; returns the int8 count."""
    n = 0
    for key, want in jax_env.items():
        if not isinstance(want, tuple):
            np.testing.assert_allclose(port_env[key].numpy(), np.asarray(want), atol=1e-5,
                                       err_msg=key)
            continue
        np.testing.assert_array_equal(port_env[key][0].numpy(), np.asarray(want[0]),
                                      err_msg=key)
        assert port_env[key][1].item() == float(want[1]), key
        n += 1
    return n


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


def seeded_state_dict(name, seed=0, **kw):
    """A port model's state_dict from a torch seed, with the BN running
    statistics drawn too (so folding them is not the identity), on the CPU.
    ``kw`` goes to ``build_model`` (n_classes, base_features, ...)."""
    from tpu_unet_torch.models import build_model
    torch.manual_seed(seed)
    sd = build_model(name, **kw).state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
    return sd


def jax_variables(state_dict, name):
    """The JAX variables ({"params", "batch_stats"}) of a port state_dict."""
    from tpu_unet_torch.utils.weights import jax_trees_from_state_dict
    params, stats = jax_trees_from_state_dict(state_dict, name)
    return {"params": params, "batch_stats": stats}
