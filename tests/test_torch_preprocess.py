"""K1 (tpu_unet_torch/ops/kernels/preprocess.py) on the CPU: its plain version
against the JAX package's eval_transform and the Pallas kernel in interpret
mode, and the wrapper's CPU contract. The CUDA kernel is held to the plain
version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_unet.ops.augment import eval_transform as jax_eval_transform
from tpu_unet_torch.ops.augment import eval_transform, normalize, to_float
from tpu_unet_torch.ops.kernels.preprocess import normalize_u8, normalize_u8_plain


def _images(seed, shape=(2, 16, 16, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_plain_equals_eval_transform_bit_for_bit():
    """Every uint8 value in every channel, plus a random batch: the plain
    version is eval_transform's float32 result bit for bit (not merely within
    1e-6), because it does the same IEEE operations in the same order."""
    every = np.arange(256, dtype=np.uint8).repeat(3).reshape(1, 16, 16, 3)
    for img in (every, _images(0)):
        ref = np.asarray(jax_eval_transform(jnp.asarray(img)))
        got = normalize_u8_plain(torch.from_numpy(img)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_plain_matches_pallas_kernel_in_interpret_mode():
    """The Pallas kernel run as tests/test_pallas_preprocess.py runs it."""
    from jax.experimental import pallas as pl

    from tpu_unet.ops.pallas import preprocess as pp

    img = jnp.asarray(_images(2, (2, 8, 128, 3)))
    scale_np, bias_np = pp._scale_bias(pp.IMAGENET_MEAN, pp.IMAGENET_STD)
    n, h, w, c = img.shape
    wc = w * c
    scale = jnp.asarray(np.tile(scale_np, w)).reshape(1, 1, wc)
    bias = jnp.asarray(np.tile(bias_np, w)).reshape(1, 1, wc)
    out = pl.pallas_call(
        pp._normalize_kernel,
        out_shape=jax.ShapeDtypeStruct((n, h, wc), jnp.float32),
        grid=(n, 1),
        in_specs=[
            pl.BlockSpec((1, h, wc), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, 1, wc), lambda i, j: (0, 0, 0)),
            pl.BlockSpec((1, 1, wc), lambda i, j: (0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, h, wc), lambda i, j: (i, j, 0)),
        interpret=True,
    )(img.reshape(n, h, wc), scale, bias).reshape(n, h, w, c)
    got = normalize_u8_plain(torch.from_numpy(np.array(img))).numpy()
    # The Pallas kernel computes x * scale + bias, not eval_transform's order.
    np.testing.assert_allclose(got, np.asarray(out), atol=1e-5)


def test_bf16_output_is_the_f32_result_rounded():
    img = torch.from_numpy(_images(3))
    f32 = normalize_u8(img)
    bf16 = normalize_u8(img, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and bf16.shape == img.shape
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    from tpu_unet.ops.pallas.preprocess import normalize_u8_reference
    ref = np.asarray(normalize_u8_reference(jnp.asarray(img.numpy()),
                                            out_dtype=jnp.bfloat16), np.float32)
    np.testing.assert_allclose(bf16.float().numpy(), ref, atol=2e-2)  # bf16 ulp at |x| < 2.7


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    before = normalize_u8.launches
    img = torch.from_numpy(_images(4))
    assert torch.equal(eval_transform(img), normalize_u8_plain(img))
    assert normalize_u8.launches == before


def test_to_float_and_normalize_match_jax():
    from tpu_unet.ops.augment import normalize as jax_normalize, to_float as jax_to_float

    img = _images(5)
    f = to_float(torch.from_numpy(img))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jax_to_float(jnp.asarray(img))))
    np.testing.assert_array_equal(normalize(f).numpy(),
                                  np.asarray(jax_normalize(jax_to_float(jnp.asarray(img)))))


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 8, 8, 3, dtype=torch.float32), TypeError),
    (torch.zeros(2, 8, 8, 4, dtype=torch.uint8), ValueError),
    (torch.zeros(2, 3, 8, 8, dtype=torch.uint8).permute(0, 2, 3, 1), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        normalize_u8(bad)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_lookup_table_holds_every_result(out_dtype):
    """The kernel's 768-entry table, computed as each of its blocks computes
    it (v / 255, - mean[c], / std[c], each step rounded to float32, then the
    output type), here in numpy: entry v * 3 + c is normalize_u8_plain's
    result for value v in channel c, for all 768 pairs, and gathering from it
    reproduces the plain version on a random batch."""
    from tpu_unet_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD
    v = np.arange(768, dtype=np.uint32) // 3
    c = np.arange(768) % 3
    x = v.astype(np.float32) / np.float32(255)
    mean, std = np.float32(IMAGENET_MEAN)[c], np.float32(IMAGENET_STD)[c]
    table = torch.from_numpy((x - mean) / std).to(out_dtype)
    bits = torch.int32 if out_dtype == torch.float32 else torch.int16
    ramp = torch.arange(256, dtype=torch.uint8).view(1, 1, 256, 1).expand(1, 1, 256, 3)
    want = normalize_u8(ramp.contiguous(), out_dtype=out_dtype).reshape(-1)
    assert torch.equal(table.view(bits), want.view(bits))
    img = torch.from_numpy(_images(6, (2, 8, 16, 3)))
    gathered = table[img.long() * 3 + torch.arange(3)]
    assert torch.equal(gathered.view(bits),
                       normalize_u8_plain(img, out_dtype=out_dtype).view(bits))
