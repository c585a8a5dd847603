"""The port's host metrics (tpu_unet_torch/metrics/curves.py, binary.py)
against the JAX package's on seeded scores: identical results, ties and a
single class included [exact]."""

import numpy as np
import pytest

import tpu_unet.metrics as jm
import tpu_unet_torch.metrics as tm


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    n = 57
    if kind == "continuous":
        y = rng.integers(0, 2, n)
        s = rng.normal(size=n) + y
    elif kind == "ties":  # scores on a coarse grid: many tied groups
        y = rng.integers(0, 2, n)
        s = np.round(rng.uniform(size=n) * 4 + y, 0) / 4
    elif kind == "one_class":
        y = np.zeros(n, int)
        s = rng.uniform(size=n)
    elif kind == "float32":  # scores as the eval step hands them over
        y = rng.integers(0, 2, n)
        s = (rng.uniform(size=n) + 0.3 * y).astype(np.float32)
    else:  # all scores tied
        y = rng.integers(0, 2, n)
        s = np.full(n, 0.25)
    return y, s


KINDS = ["continuous", "ties", "one_class", "float32", "all_tied"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_curves_match_jax(kind, seed):
    y, s = _case(kind, seed)
    for a, b in zip(tm.precision_recall_curve(y, s), jm.precision_recall_curve(y, s)):
        np.testing.assert_array_equal(a, b)
    assert tm.auprc(y, s) == jm.auprc(y, s)
    assert tm.get_optimal_threshold(y, s) == jm.get_optimal_threshold(y, s)
    if kind == "one_class":
        with pytest.raises(ValueError):
            tm.auroc(y, s)
    else:
        assert tm.auroc(y, s) == jm.auroc(y, s)


@pytest.mark.parametrize("kind", KINDS)
def test_calculate_metrics_matches_jax(kind):
    y, s = _case(kind, 3)
    pred = (s > np.percentile(s, 70)).astype(int)
    assert tm.calculate_metrics(y, pred, s) == jm.calculate_metrics(y, pred, s)
    assert tm.calculate_metrics(y, pred) == jm.calculate_metrics(y, pred)
    if kind == "one_class":  # the reference's ValueError -> 0.0
        assert tm.calculate_metrics(y, pred, s)["auroc"] == 0.0


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_pixel_metrics_match_jax(threshold):
    rng = np.random.default_rng(4)
    masks = (rng.uniform(size=(3, 16, 16)) > 0.8).astype(np.float32)
    maps = np.clip(masks * 0.5 + rng.uniform(size=masks.shape) * 0.6, 0, 1).astype(np.float32)
    assert (tm.calculate_pixel_metrics(masks, maps, threshold)
            == jm.calculate_pixel_metrics(masks, maps, threshold))


def test_auc_directions():
    x = np.array([0.0, 0.5, 1.0])
    y = np.array([1.0, 0.5, 0.0])
    assert tm.auc(x, y) == tm.auc(x[::-1], y[::-1]) == jm.auc(x, y) == 0.5
    with pytest.raises(ValueError):
        tm.auc(np.array([0.0, 1.0, 0.5]), y)


def test_exports():
    assert set(tm.__all__) == set(jm.__all__)


def test_pixel_scale_ranks_match_jax():
    """A pixel-level score vector (many distinct values and tied groups):
    the port's vectorized average ranks give JAX's AUROC bit for bit."""
    rng = np.random.default_rng(5)
    y = (rng.uniform(size=200_000) > 0.95).astype(np.uint8)
    s = np.round(rng.uniform(size=y.size) + 0.2 * y, 4).astype(np.float32)
    assert tm.auroc(y, s) == jm.auroc(y, s)
    assert tm.auprc(y, s) == jm.auprc(y, s)
