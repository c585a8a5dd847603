"""The port's segmentation losses (tpu_unet_torch/losses/segmentation.py)
against the JAX package's, on the CPU: each term and the combined loss,
sliced (C <= 8) and unsliced, at KolektorSDD's class weights 1:50:50, with
ignore_index, sample_weight and out-of-range labels [rtol 1e-5], their
gradients with respect to the logits, and bf16 logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from tpu_unet.losses import segmentation as jseg
from tpu_unet_torch.losses import segmentation as tseg

KSDD_WEIGHTS = (1.0, 50.0, 50.0)


def _batch(seed, c, n=3, hw=(12, 10), extra_labels=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, *hw, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c + extra_labels, (n, *hw)).astype(np.int64)
    return logits, labels


def _jax(fn, logits, labels, sample_weight=None, **kw):
    sw = None if sample_weight is None else jnp.asarray(sample_weight)
    return fn(jnp.asarray(logits), jnp.asarray(labels, jnp.int32), sample_weight=sw, **kw)


def _port(fn, logits, labels, sample_weight=None, **kw):
    sw = None if sample_weight is None else torch.from_numpy(sample_weight)
    return fn(torch.from_numpy(logits), torch.from_numpy(labels), sample_weight=sw, **kw)


CASES = [  # (C, class weights, ignore_index, sample weight)
    (3, KSDD_WEIGHTS, None, None),
    (3, KSDD_WEIGHTS, 2, np.asarray([1.0, 0.0, 1.0], np.float32)),
    (3, None, None, np.asarray([1.0, 1.0, 0.0], np.float32)),
    (4, (1.0, 2.0, 3.0, 0.5), 255, None),
    (4, None, 0, np.asarray([0.0, 1.0, 1.0], np.float32)),
    (9, None, None, None),
    (9, tuple(float(i + 1) for i in range(9)), 4, np.asarray([1.0, 0.0, 1.0], np.float32)),
]


@pytest.mark.parametrize("c,weights,ignore,sw", CASES)
def test_combined_loss_matches_jax(c, weights, ignore, sw):
    logits, labels = _batch(c, c)
    if ignore == 255:
        labels[0, :3] = 255  # out of range: CE clips, Dice one-hot-encodes a zero row
    kw = dict(ce_weight=1.0, dice_weight=1.0, focal_weight=0.5, class_weights=weights,
              ignore_index=ignore)
    want = _jax(jseg.combined_segmentation_loss, logits, labels, sw, **kw)
    got = _port(tseg.combined_segmentation_loss, logits, labels, sw, **kw)
    assert set(got) == set(want) == {"ce_loss", "dice_loss", "focal_loss", "total_loss"}
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    # The two port paths agree with each other too.
    plain = _port(tseg._combined_unsliced, logits, labels, sw, **kw)
    for k in want:
        np.testing.assert_allclose(float(plain[k]), float(got[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("fn", ["cross_entropy_loss", "focal_loss"])
@pytest.mark.parametrize("ignore", [None, 1])
def test_per_term_losses_match_jax(fn, ignore):
    logits, labels = _batch(11, 3, extra_labels=1)  # label 3 is out of range: clipped
    sw = np.asarray([1.0, 0.0, 1.0], np.float32)
    kw = {"ignore_index": ignore}
    if fn == "cross_entropy_loss":
        kw["class_weights"] = KSDD_WEIGHTS
    want = _jax(getattr(jseg, fn), logits, labels, sw, **kw)
    got = _port(getattr(tseg, fn), logits, labels, sw, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_dice_loss_matches_jax():
    logits, labels = _batch(12, 4, extra_labels=1)
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    want = jseg.dice_loss(probs, jnp.asarray(labels, jnp.int32))
    got = tseg.dice_loss(torch.from_numpy(np.array(probs)), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_weighted_ce_is_torchs_weighted_mean():
    """Class weights take F.cross_entropy's weighted mean, sum(w_y ce) / sum(w_y)."""
    logits, labels = _batch(13, 3)
    got = tseg.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                  class_weights=KSDD_WEIGHTS)
    ref = torch.nn.functional.cross_entropy(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                            torch.from_numpy(labels),
                                            weight=torch.tensor(KSDD_WEIGHTS))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("c,weights", [(3, KSDD_WEIGHTS), (9, None)])
def test_gradients_match_jax(c, weights):
    logits, labels = _batch(14 + c, c)
    sw = np.asarray([1.0, 1.0, 0.0], np.float32)
    kw = dict(class_weights=weights, focal_weight=0.5)

    def jloss(x):
        return jseg.combined_segmentation_loss(x, jnp.asarray(labels, jnp.int32),
                                               sample_weight=jnp.asarray(sw), **kw)["total_loss"]

    want = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    tseg.combined_segmentation_loss(x, torch.from_numpy(labels), sample_weight=torch.from_numpy(sw),
                                    **kw)["total_loss"].backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-4, atol=1e-7 * np.abs(want).max())
    assert np.all(x.grad.numpy()[2] == 0)  # the zero-weight row gets no gradient


def test_bf16_logits_are_computed_in_float32():
    logits, labels = _batch(15, 3)
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    want = jseg.combined_segmentation_loss(jnp.asarray(lb.float().numpy(), jnp.bfloat16),
                                           jnp.asarray(labels, jnp.int32),
                                           class_weights=KSDD_WEIGHTS)
    got = tseg.combined_segmentation_loss(lb, torch.from_numpy(labels), class_weights=KSDD_WEIGHTS)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_terms_are_gated_on_their_weights():
    logits, labels = _batch(16, 3)
    got = tseg.combined_segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                          ce_weight=0.0, dice_weight=2.0)
    assert set(got) == {"dice_loss", "total_loss"}
    np.testing.assert_allclose(float(got["total_loss"]), 2 * float(got["dice_loss"]), rtol=1e-7)
    none = tseg.combined_segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                           ce_weight=0.0, dice_weight=0.0)
    assert float(none["total_loss"]) == 0.0
