"""Port resize (tpu_unet_torch/ops/resize.py) against the JAX package's
ops/resize.py on the CPU: the align-corners interpolation matrix exactly,
the resize in float32 to 1e-6 and in bfloat16 to one bf16 ulp (the weights
bf16-rounded as JAX rounds them), at odd, equal and 1-sized extents."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from tpu_unet.ops import resize as jr
from tpu_unet_torch.ops import resize as tr

# (N, H, W, C) in, (out_h, out_w): 2x up, odd to odd, equal H, 1-sized in
# and out, and a downsize.
CASES = [((2, 16, 8, 5), (32, 16)), ((1, 31, 17, 3), (62, 34)), ((2, 5, 7, 4), (5, 13)),
         ((1, 1, 6, 2), (4, 12)), ((1, 6, 4, 2), (1, 4)), ((2, 9, 12, 3), (4, 5))]


@pytest.mark.parametrize("n_in,n_out", [(8, 16), (31, 62), (1, 5), (5, 1), (7, 7), (12, 5)])
def test_interp_matrix_is_jaxs(n_in, n_out):
    want = jr._interp_matrix(n_in, n_out)
    np.testing.assert_array_equal(tr._interp_matrix(n_in, n_out), want)
    m = tr.interp_matrix(n_in, n_out, torch.bfloat16, torch.device("cpu"))
    np.testing.assert_array_equal(
        m.float().numpy(),
        np.asarray(jnp.asarray(want.astype(np.float32), jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("shape,out", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_matches_jax(shape, out, dtype):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(jr.resize_bilinear_align_corners(jnp.asarray(x, dtype), *out)
                      .astype(jnp.float32))
    t = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = tr.resize_bilinear_align_corners(t, *out)
    assert got.dtype == t.dtype and tuple(got.shape) == (shape[0], shape[3], *out)
    got = got.permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":  # two products and a sum: FMA order moves an ulp
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:  # one bf16 ulp of the value (2^-7 relative)
        np.testing.assert_array_less(np.abs(got - want), np.abs(want) * 2.0 ** -7 + 1e-30)


def test_upsample2x_and_identity():
    x = torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(0))
    up = tr.upsample2x_bilinear_align_corners(x)
    want = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear",
                                           align_corners=True)
    np.testing.assert_allclose(up.numpy(), want.numpy(), atol=1e-6)
    assert tr.resize_bilinear_align_corners(x, 5, 7) is x  # equal sizes: unchanged
    # one matrix per (in, out, dtype, device), made once
    assert tr.interp_matrix(5, 10, torch.float32, "cpu") is tr.interp_matrix(
        5, 10, torch.float32, torch.device("cpu"))
