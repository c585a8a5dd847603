"""The port's tiled native-resolution inference (tpu_unet_torch/ops/tiling.py)
against tpu_unet/ops/tiling.py on the CPU: the grid and the window equal,
the blend of the same tile logits within 1 float32 ulp, and the tiled seg
forward (base 4) against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, one_torch_thread, seeded_state_dict  # noqa: F401
from tpu_unet.ops import tiling as jt
from tpu_unet_torch.ops import tiling as tt


@pytest.mark.parametrize("extent,tile,stride", [(10, 4, 2), (11, 4, 3), (8, 8, 3), (1024, 512, 448),
                                                (50, 32, 24), (33, 32, 24)])
def test_tile_offsets_equal_jax(extent, tile, stride):
    assert tt.tile_offsets(extent, tile, stride) == jt.tile_offsets(extent, tile, stride)


@pytest.mark.parametrize("args,match", [((6, 8, 2), "larger than image"), ((10, 4, 0), "stride")])
def test_tile_offsets_errors(args, match):
    with pytest.raises(ValueError, match=match):
        tt.tile_offsets(*args)


@pytest.mark.parametrize("hw", [(8, 6), (32, 32), (512, 512)])
def test_tile_weight_equals_jax(hw):
    np.testing.assert_array_equal(tt.tile_weight(*hw), jt.tile_weight(*hw))


def _pointwise(x, np_like):
    """Tile 'logits' from each pixel alone, in float32, on either package:
    every overlapping tile agrees at a pixel, and both sides get the same bits."""
    s = x[..., 0] * 0.37 + x[..., 1] * 1.9 - x[..., 2] * 0.61
    return np_like.stack([s, 3.0 - s * 0.5, s * s * 1e-3], axis=-1)


@pytest.mark.parametrize("hw,tile,ov", [
    ((48, 64), (32, 32), 16),   # 2x3 grid
    ((50, 33), (32, 32), 8),    # extents not a multiple of the stride
    ((64, 64), (32, 32), 0),    # no overlap
    ((40, 40), (32, 32), 24),
])
def test_blend_matches_jax_to_one_ulp(hw, tile, ov):
    imgs = np.random.default_rng(0).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    want = np.asarray(jt.make_tiled_logits_fn(
        lambda _, t: _pointwise(t.astype(jnp.float32), jnp), hw, tile, ov)(None, jnp.asarray(imgs)))
    got = tt.make_tiled_logits_fn(lambda t: _pointwise(t.to(torch.float32), torch),
                                  hw, tile, ov)(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (3, *hw, 3) and got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # the blend of a pointwise forward is that forward, within float32 rounding
    direct = _pointwise(torch.from_numpy(imgs).to(torch.float32), torch).numpy()
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-3)


def test_tiles_are_stacked_tile_major_and_images_not_mixed():
    hw, tile = (40, 40), (32, 32)
    imgs = np.zeros((2, *hw, 3), np.uint8)
    imgs[1] += 200
    seen = []

    def apply(t):
        seen.append(t.shape)
        return _pointwise(t.to(torch.float32), torch)

    out = tt.make_tiled_logits_fn(apply, hw, tile, 24)(torch.from_numpy(imgs)).numpy()
    assert seen == [(2 * 4, 32, 32, 3)]  # one call, 4 tiles of each of 2 images
    np.testing.assert_allclose(out[0, ..., 1], 3.0, rtol=1e-6)
    np.testing.assert_allclose(out[1, ..., 0], 200 * (0.37 + 1.9 - 0.61), rtol=1e-5)


def test_one_tile_is_the_forward_itself():
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3),
                                                              dtype=np.uint8))
    fn = tt.make_tiled_logits_fn(lambda t: _pointwise(t.to(torch.float32), torch),
                                 (32, 32), (32, 32), 16)
    assert torch.equal(fn(imgs), _pointwise(imgs.to(torch.float32), torch))
    with pytest.raises(ValueError, match="overlap"):
        tt.make_tiled_logits_fn(lambda t: t, (64, 64), (32, 32), -1)


def test_tiled_seg_forward_matches_jax():
    """SegmentationUNet (base 4, 3 classes, f32) at 32x32 tiles over 48x64
    images with overlap 16: the port's tiled logits against JAX's within the
    f32 model tolerance of tests/test_torch_models.py (1e-3 absolute: the
    two packages' convs sum in different orders; the blend adds none)."""
    from tpu_unet.models import build_model as jax_build
    from tpu_unet.ops.augment import eval_transform as jax_eval
    from tpu_unet_torch.models import build_model
    from tpu_unet_torch.ops.augment import eval_transform

    sd = seeded_state_dict("seg_unet", 3, n_classes=3, base_features=4)
    v = jax_variables(sd, "seg_unet")
    jmodel = jax_build("seg_unet", n_classes=3, base_features=4)
    model = build_model("seg_unet", n_classes=3, base_features=4)
    model.load_state_dict(sd)
    model.eval()
    imgs = np.random.default_rng(2).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    want = jax.jit(jt.make_tiled_logits_fn(
        lambda vv, t: jmodel.apply(vv, jax_eval(t), train=False), (48, 64), (32, 32), 16))(
            v, jnp.asarray(imgs))

    def apply(t):
        return model(eval_transform(t).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    with torch.inference_mode():
        got = tt.make_tiled_logits_fn(apply, (48, 64), (32, 32), 16)(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
