"""The port's losses, SSIM and SSIM scoring (tpu_unet_torch/losses,
ops/ssim.py, metrics/anomaly.py) against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.losses.anomaly as jl
import tpu_unet.metrics.anomaly as jm
import tpu_unet.ops.ssim as jssim
import tpu_unet_torch.losses.anomaly as tl
import tpu_unet_torch.metrics.anomaly as tm
import tpu_unet_torch.ops.ssim as tssim
from tpu_unet.losses.reduction import weighted_mean as jax_weighted_mean
from tpu_unet_torch.losses.reduction import weighted_mean


def _batch(seed, n=4, hw=24):
    rng = np.random.default_rng(seed)
    recon = rng.uniform(size=(n, hw, hw, 3)).astype(np.float32)
    image = rng.normal(size=(n, hw, hw, 3)).astype(np.float32)  # normalized image
    amap = rng.uniform(size=(n, hw, hw, 1)).astype(np.float32)
    mask = (rng.uniform(size=(n, hw, hw, 1)) > 0.8).astype(np.float32)
    return recon, amap, image, mask


@pytest.mark.parametrize("weights", [None, [1, 1, 0, 1], [0.5, 2.0, 1.0, 0.0]])
def test_weighted_mean(weights):
    x = np.random.default_rng(0).normal(size=(4, 5, 6)).astype(np.float32)
    w = None if weights is None else np.asarray(weights, np.float32)
    out = weighted_mean(torch.from_numpy(x), None if w is None else torch.from_numpy(w))
    ref = jax_weighted_mean(jnp.asarray(x), None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    assert out.dtype == torch.float32
    if weights == [1, 1, 0, 1]:  # binary weights: the mean over the valid rows
        np.testing.assert_allclose(out.numpy(), x[[0, 1, 3]].astype(np.float64).mean(),
                                   rtol=1e-6)


def test_weighted_mean_of_per_sample_values():
    x = torch.tensor([1.0, 2.0, 4.0])
    assert float(weighted_mean(x, torch.tensor([1.0, 0.0, 1.0]))) == 2.5
    assert float(weighted_mean(x, torch.zeros(3))) == 0.0  # no valid row: 0, not NaN


def test_focal_loss_at_saturated_probabilities():
    """p of exactly 0 and 1 (a saturated sigmoid): finite loss, the JAX
    package's value, and a zero gradient (the clip, not a log clamp)."""
    probs = torch.tensor([0.0, 1.0, 1.0, 0.0, 0.3]).reshape(1, 5, 1, 1).requires_grad_()
    targets = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0]).reshape(1, 5, 1, 1)
    loss = tl.binary_focal_loss(probs, targets)
    assert torch.isfinite(loss)
    ref = jl.binary_focal_loss(jnp.asarray(probs.detach().numpy()), jnp.asarray(targets.numpy()))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    loss.backward()
    g = probs.grad.flatten()
    assert torch.isfinite(g).all() and torch.equal(g[:4], torch.zeros(4))
    assert g[4] != 0


@pytest.mark.parametrize("recon_loss_type", ["mse", "ssim"])
@pytest.mark.parametrize("weighted", [False, True])
def test_combined_anomaly_loss_matches_jax(recon_loss_type, weighted):
    recon, amap, image, mask = _batch(1)
    valid = np.asarray([1, 1, 1, 0], np.float32) if weighted else None
    kw = dict(recon_weight=0.7, seg_weight=1.3, focal_alpha=0.3, focal_gamma=2.0,
              recon_loss_type=recon_loss_type)
    out = tl.combined_anomaly_loss(*map(torch.from_numpy, (recon, amap, image, mask)),
                                   sample_weight=None if valid is None else torch.from_numpy(valid),
                                   **kw)
    ref = jl.combined_anomaly_loss(*map(jnp.asarray, (recon, amap, image, mask)),
                                   sample_weight=None if valid is None else jnp.asarray(valid),
                                   **kw)
    assert set(out) == set(ref) == {"total_loss", "recon_loss", "seg_loss"}
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, err_msg=k)


def test_unknown_recon_loss_raises():
    recon, amap, image, mask = map(torch.from_numpy, _batch(2))
    with pytest.raises(ValueError):
        tl.combined_anomaly_loss(recon, amap, image, mask, recon_loss_type="l2")


@pytest.mark.parametrize("shape", [(2, 24, 24, 3), (1, 17, 40, 1), (2, 4, 5, 3)])
def test_ssim_matches_jax_and_the_depthwise_oracle(shape):
    """The banded-matmul SSIM against the JAX package's banded SSIM and its 2-D
    depthwise-convolution oracle, including sides shorter than the window."""
    rng = np.random.default_rng(3)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    smap = tssim.ssim_map(torch.from_numpy(a), torch.from_numpy(b))
    oracle = jssim._ssim_map_depthwise(jnp.asarray(a), jnp.asarray(b), 11, 1.5)
    np.testing.assert_allclose(smap.permute(0, 2, 3, 1).numpy(), np.asarray(oracle),
                               rtol=0, atol=1e-5)
    for size_average in (True, False):
        out = tssim.ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=size_average)
        ref = jssim.ssim(jnp.asarray(a), jnp.asarray(b), size_average=size_average)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        float(tssim.ssim_loss(torch.from_numpy(a), torch.from_numpy(b))),
        float(jssim.ssim_loss(jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-5)


def test_ssim_of_an_image_with_itself_is_one():
    a = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tssim.ssim(a, a, size_average=False).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("method", ["mse", "l1", "ssim"])
def test_anomaly_scoring_matches_jax(method):
    recon, _, image, _ = _batch(4)
    image = np.clip(recon + np.random.default_rng(5).normal(scale=0.2, size=recon.shape),
                    0, 1).astype(np.float32)
    r, o = torch.from_numpy(recon), torch.from_numpy(image)
    score = tm.anomaly_score(r, o, method=method)
    emap = tm.anomaly_error_map(r, o, method=method)
    assert score.shape == (4,) and emap.shape == (4, 24, 24)
    np.testing.assert_allclose(score.numpy(), np.asarray(
        jm.anomaly_score(jnp.asarray(recon), jnp.asarray(image), method=method)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(emap.numpy(), np.asarray(
        jm.anomaly_error_map(jnp.asarray(recon), jnp.asarray(image), method=method)),
        rtol=1e-6)
    if method == "ssim":  # the map stays the MSE map; the score is 1 - SSIM
        np.testing.assert_array_equal(emap.numpy(),
                                      tm.anomaly_error_map(r, o, method="mse").numpy())
        np.testing.assert_allclose(score.numpy(),
                                   1 - tssim.ssim(r, o, size_average=False).numpy())
    with pytest.raises(ValueError):
        tm.anomaly_score(r, o, method="psnr")
