"""The port's sliced prediction heads (tpu_unet_torch/ops/seg_head.py)
against the JAX package's, on the CPU: argmax with first-max ties and the
first NaN winning [exact], and the softmax confidence, at C = 3, 4 (the
sliced path) and 9 (the path above SMALL_C_MAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from tpu_unet.ops import seg_head as jhead
from tpu_unet_torch.ops import seg_head as thead


def _logits(seed, c, ties=True, nans=0, shape=(2, 9, 7)):
    rng = np.random.default_rng(seed)
    if ties:  # few distinct values: many pixels have two or more maxima
        x = rng.integers(-2, 3, shape + (c,)).astype(np.float32)
    else:
        x = rng.standard_normal(shape + (c,)).astype(np.float32) * 4
    if nans:
        flat = x.reshape(-1)
        flat[rng.choice(flat.size, nans, replace=False)] = np.nan
    return x


def test_cutoff_is_jax_s():
    assert thead.SMALL_C_MAX == jhead.SMALL_C_MAX == 8


@pytest.mark.parametrize("c", [3, 4, 9])
@pytest.mark.parametrize("nans", [0, 20])
def test_argmax_ties_and_nan_match_jax(c, nans):
    x = _logits(c + nans, c, nans=nans)
    want = np.asarray(jhead.sliced_argmax(jnp.asarray(x)))
    got = thead.sliced_argmax(torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if not nans:  # first-max ties, as numpy's argmax
        np.testing.assert_array_equal(got.numpy(), np.argmax(x, axis=-1))
    else:  # a NaN pixel takes its first NaN's index
        has = np.isnan(x).any(-1)
        assert has.sum() > 0
        np.testing.assert_array_equal(got.numpy()[has], np.argmax(np.isnan(x), -1)[has])


@pytest.mark.parametrize("c", [3, 4, 9])
def test_pred_confidence_matches_jax(c):
    """Predictions exact; the confidence, computed in float32 by both with
    their own exp, within 2 ulps [rtol 3e-7]."""
    x = _logits(40 + c, c, ties=False, nans=3)
    jp, jc = jhead.sliced_pred_confidence(jnp.asarray(x))
    tp, tc = thead.sliced_pred_confidence(torch.from_numpy(x))
    assert tp.dtype == torch.uint8 and tc.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=3e-7, equal_nan=True)
    assert np.isnan(tc.numpy()).sum() == np.isnan(np.asarray(jc)).sum() > 0


def test_confidence_is_the_largest_softmax_probability():
    x = _logits(5, 4, ties=False)
    _, conf = thead.sliced_pred_confidence(torch.from_numpy(x))
    ref = torch.softmax(torch.from_numpy(x), -1).amax(-1)
    np.testing.assert_allclose(conf.numpy(), ref.numpy(), rtol=1e-6)


def test_bf16_logits_and_other_dtypes():
    x = torch.from_numpy(_logits(6, 3)).to(torch.bfloat16)
    want = np.asarray(jhead.sliced_argmax(jnp.asarray(x.float().numpy(), jnp.bfloat16)))
    np.testing.assert_array_equal(thead.sliced_argmax(x).numpy(), want)
    assert thead.sliced_argmax(x, dtype=torch.int32).dtype == torch.int32
