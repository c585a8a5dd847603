"""The port's confusion matrices and segmentation metrics
(tpu_unet_torch/metrics/confusion.py) against the JAX package's, on the CPU:
the matrices of both paths (C <= 8 mask sums, larger C a chunked one-hot
matmul) with and without ignore_index [exact], and every derived metric."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from tpu_unet.metrics import confusion as jconf
from tpu_unet_torch.metrics import (SegmentationMetrics, compute_metrics_from_predictions,
                                    confusion_matrix_batch)
from tpu_unet_torch.metrics import confusion as tconf


def _pair(seed, c, shape=(3, 20, 12), out_of_range=0):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, c, shape)
    t = rng.integers(0, c + out_of_range, shape)
    return p, t


@pytest.mark.parametrize("c", [3, 4, 9])
@pytest.mark.parametrize("ignore_index", [None, 1, 255])
def test_batch_matrix_matches_jax(c, ignore_index):
    p, t = _pair(c, c)
    if ignore_index == 255:
        t[0, :5] = 255
    want = np.asarray(jconf.confusion_matrix_batch(jnp.asarray(p, jnp.int32),
                                                   jnp.asarray(t, jnp.int32), c, ignore_index))
    got = confusion_matrix_batch(torch.from_numpy(p), torch.from_numpy(t), c, ignore_index)
    assert got.dtype == torch.int64 and tuple(got.shape) == (c, c)
    np.testing.assert_array_equal(got.numpy(), want)


def test_both_paths_agree_and_chunk_exactly():
    """The one-hot path, forced into 7-pixel chunks, equals the mask sums;
    an out-of-range target counts nowhere on either path (a zero one-hot row)."""
    p, t = _pair(1, 4, out_of_range=2)
    p, t = torch.from_numpy(p), torch.from_numpy(t)
    sliced = tconf._confusion_matrix_sliced(p, t, 4, None)
    chunked = tconf._confusion_matrix_impl(p, t, 4, None, max_exact=7)
    assert torch.equal(sliced, chunked)
    assert int(sliced.sum()) == int((t < 4).sum())
    want = np.asarray(jconf._confusion_matrix_impl(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()),
                                                   4, None, max_exact=7))
    np.testing.assert_array_equal(chunked.numpy(), want)


@pytest.mark.parametrize("c", [3, 9])
def test_valid_rows_count_like_the_jax_host_path(c):
    """``valid`` (the port's addition) leaves padded rows out: the counts of
    the JAX validation's host update over the valid rows."""
    p, t = _pair(7, c, shape=(4, 6, 5))
    valid = np.asarray([True, False, True, False])
    got = confusion_matrix_batch(torch.from_numpy(p), torch.from_numpy(t), c, 2,
                                 valid=torch.from_numpy(valid))
    ref = jconf.SegmentationMetrics(c, 2)
    ref.update(p[valid], t[valid])
    np.testing.assert_array_equal(got.numpy(), ref.confusion_matrix)


def _metrics_pair(seed, c=4, logits=False):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, c, (2, 16, 8))
    t[t == 3] = 0  # class 3 absent from the targets: NaN-free zeros, as the reference
    if logits:
        p = rng.standard_normal((2, 16, 8, c)).astype(np.float32)
    else:
        p = rng.integers(0, c, (2, 16, 8))
    return p, t


@pytest.mark.parametrize("logits", [False, True])
def test_segmentation_metrics_match_jax(logits):
    p, t = _metrics_pair(3, logits=logits)
    jm, tm = jconf.SegmentationMetrics(4), SegmentationMetrics(4)
    for _ in range(2):  # the accumulator adds up
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    assert tm.total_samples == jm.total_samples == 2 * t.size
    want, got = jm.compute_all_metrics(), tm.compute_all_metrics()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["confusion_matrix"].dtype == np.int64
    np.testing.assert_array_equal(tm.compute_iou(per_class=False), jm.compute_iou(per_class=False))
    np.testing.assert_array_equal(tm.compute_dice(per_class=False),
                                  jm.compute_dice(per_class=False))
    assert tm.compute_precision_recall_f1(per_class=False) == \
        jm.compute_precision_recall_f1(per_class=False)
    tm.reset()
    assert tm.confusion_matrix.sum() == 0 and tm.total_samples == 0


def test_numpy_inputs_and_the_convenience_wrapper(capsys):
    p, t = _metrics_pair(4)
    got = compute_metrics_from_predictions(p, t, 4)
    want = jconf.compute_metrics_from_predictions(p, t, 4)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    m = SegmentationMetrics(4)
    m.update(p, t)
    m.print_metrics(["bg", "a", "b", "c"])
    out = capsys.readouterr().out
    assert "Mean IoU" in out and "bg" in out


def test_plot_confusion_matrix(tmp_path):
    pytest.importorskip("matplotlib")
    m = SegmentationMetrics(3)
    m.update(*_pair(5, 3))
    path = tmp_path / "cm.png"
    m.plot_confusion_matrix(["a", "b", "c"], str(path))
    assert path.stat().st_size > 0
