"""The port's 'space' axis at heights whose deeper levels split unevenly,
against the JAX package's seg steps on the same mesh (gloo CPU ranks;
base 4, 16 px wide, 4 classes, a batch of 4; the tolerances of
``tests/test_torch_parallel_spatial_seg.py``: the loss 1e-4 relative, the
confusion matrix equal, the parameters and BatchNorm statistics rtol 2e-4
/ atol 2e-5, after one SGD step).

- 40 rows on a (1, 2) mesh: levels of 20/20, 10/10, 5/5, 3/2 and 2/0 rows
  (an odd level, a row the pool's floor drops, a bottleneck rank with no
  rows, a one-row pad on the way up);
- 48 rows on (1, 4): 3-row blocks, then 2/1/2/1 and 1/1/1/0.

Each runs SegmentationUNet's train step with its bottleneck dropout and
the eval step on the updated state (the predictions gathered back to whole
images); at 40 rows also the train step under ``remat='full_res'``, whose
recomputation reruns the row moves. The int8 seg eval (K2's plain
version) holds the one-process int8 eval bit for bit at both heights.
Every launch bounds each collective's wait, so a rank that makes one
exchange too few fails instead of hanging.
"""

import jax
import numpy as np
import pytest

import _torch_space_workers as workers
from _torch_parity import one_torch_thread, seg_batch  # noqa: F401
from test_torch_parallel_spatial_seg import (AUG, BASE, C, LOSS, LOSS_RTOL, LR, N, W, WD,
                                             assert_matches_jax, jax_case, seeded)
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet_torch.parallel.mesh import launch

MESHES = {40: 2, 48: 4}  # height: space ranks
TIMEOUT = 120  # seconds a rank waits at one collective


@pytest.fixture(scope="module")
def runs(devices):
    sd = seeded("seg_unet")
    model_kw = {"n_classes": C, "base_features": BASE}
    out = {}
    for h, n_space in MESHES.items():
        images, labels = seg_batch(3, n=N, h=h, w=W, num_classes=C)
        valid = np.arange(N) < 3
        ev_images, ev_labels = seg_batch(4, n=N, h=h, w=W, num_classes=C)
        ev_images[~valid], ev_labels[~valid] = 0, 0
        ev = (ev_images, ev_labels, valid)
        ref, draws, keep = jax_case("seg_unet", sd, model_kw,
                                    jax_make_mesh(n_data=1, n_space=n_space), images, labels,
                                    jax.random.key(7), eval_batch=ev)
        cases = [(draws, keep, 1, False, ev)]
        if h == 40:
            cases.append((draws, keep, 1, False, None, "full_res"))
        port = launch(workers.seg_cases, ("seg_unet", sd, model_kw, n_space, 1, cases, images,
                                          labels, LOSS, AUG, LR, WD),
                      devices=["cpu"] * n_space, timeout=TIMEOUT)
        out[h] = {"jax": ref, "port": port, "valid": valid, "eval_labels": ev_labels}
    return out


@pytest.mark.parametrize("height", list(MESHES))
def test_seg_step_at_uneven_levels_matches_jax(runs, height):
    assert_matches_jax(runs[height]["port"][0], runs[height]["jax"], "seg_unet")


@pytest.mark.parametrize("height", list(MESHES))
def test_seg_eval_at_uneven_levels_matches_jax(runs, height):
    r = runs[height]
    j, t, valid = r["jax"], r["port"][0], r["valid"]
    for k, v in t["eval_losses"].items():
        np.testing.assert_allclose(v, j["eval_losses"][k], rtol=LOSS_RTOL, err_msg=k)
    assert t["preds"].shape == (N, height, W)
    np.testing.assert_array_equal(t["preds"][valid], j["preds"][valid])
    labels = r["eval_labels"][valid].astype(np.int64).ravel()
    want = np.bincount(labels * C + j["preds"][valid].ravel(), minlength=C * C)
    np.testing.assert_array_equal(t["eval_cm"], want.reshape(C, C))


def test_remat_full_res_step_at_40_rows_matches_jax(runs):
    """The recomputed blocks rerun their halos and row moves in the
    backward: the same update as JAX's step (and as the port's own step
    without remat)."""
    plain, remat = runs[40]["port"]
    assert_matches_jax(remat, runs[40]["jax"], "seg_unet")
    assert remat["losses"] == plain["losses"]
    for k, v in plain["state"].items():
        np.testing.assert_allclose(remat["state"][k], v, rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("height", list(MESHES))
def test_int8_seg_eval_at_uneven_levels_is_one_process_bit_for_bit(height):
    sd = seeded("seg_unet")
    model_kw = {"n_classes": C, "base_features": BASE}
    images, labels = seg_batch(5, n=N, h=height, w=W, num_classes=C)
    calib, _ = seg_batch(6, n=4, h=height, w=W, num_classes=C)
    valid = np.arange(N) < 3
    args = ("seg_unet", sd, model_kw)
    one = workers.int8_eval(*args, 1, calib, images, labels, valid, LOSS)
    rows = launch(workers.int8_eval, (*args, MESHES[height], calib, images, labels, valid,
                                      LOSS), devices=["cpu"] * MESHES[height], timeout=TIMEOUT)
    np.testing.assert_array_equal(rows["preds"], one["preds"])
    np.testing.assert_array_equal(rows["cm"], one["cm"])
    for k, v in one["losses"].items():
        np.testing.assert_allclose(rows["losses"][k], v, rtol=1e-6, err_msg=k)
    # 18 K2 inputs halo'd, and the two deepest pools and the two deepest
    # level-ups move rows (the upper levels' blocks are even).
    assert rows["halo"]["exchanges"] == 18 + 4 and one["halo"]["exchanges"] == 0
