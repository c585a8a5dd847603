"""The port's segmentation train and eval steps over 2 data-parallel ranks
(gloo, CPU) against the JAX package's on a 2-device 'data' mesh, at
KolektorSDD's class weights 1:50:50 (base_features=4, 64 x 32, a global
batch of 8).

The class-weighted cross entropy is sum(w[y] ce) / sum(w[y]) over the
global batch; the two ranks' rows hold different amounts of the weighted
defect classes, so the mean of the ranks' own ratios is not the global
loss, nor its gradient. The port divides each rank's numerator by the
all-reduced denominator. Same weights, batch, draws and dropout mask on
both sides (``_torch_parity``); f32 SGD at the one-device parity tests'
tolerances (tests/test_torch_seg_steps.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_workers as workers
import tpu_unet.models as jmodels
from _torch_parity import jax_draws, jax_dropout_keep, one_torch_thread, seg_batch  # noqa: F401
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet.parallel import replicate as jax_replicate
from tpu_unet.parallel import shard_batch as jax_shard_batch
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train import make_seg_eval_step as jax_eval_step
from tpu_unet.train import make_seg_train_step as jax_train_step
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.losses.segmentation import combined_segmentation_loss
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.train.steps import AugmentConfig, SegLossConfig
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

BASE, LR, WD, C, N = 4, 0.05, 1e-4, 3, 8
KSDD_AUG = AugmentConfig(degrees=5.0, brightness=0.1, contrast=0.1, saturation=0.1, hue=0.05)
KSDD_LOSS = SegLossConfig(class_weights=(1.0, 50.0, 50.0))


def _pairs(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in sorted(a):
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(a[k]), np.asarray(b[k])


def _batch():
    """A KolektorSDD-like batch whose defects sit in rank 0's rows only."""
    images, labels = seg_batch(3, n=N, num_classes=C)
    labels[N // 2:] = 0
    return images, labels


@pytest.fixture(scope="module")
def runs():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        sd = build_model("seg_unet", n_classes=C, base_features=BASE).state_dict()
    params, stats = jax_trees_from_state_dict(sd, model="seg_unet")
    jstate = JaxTrainState.create(
        apply_fn=jmodels.build_model("seg_unet", n_classes=C, base_features=BASE).apply,
        params=params, batch_stats=stats, tx=jax_optimizer("sgd", LR, WD))
    mesh = jax_make_mesh(n_data=2)
    images, labels = _batch()
    key = jax.random.key(7)
    k_aug, k_drop = jax.random.split(key)
    draws = jax_draws(k_aug, N, KSDD_AUG)
    keep = jax_dropout_keep(jstate.apply_fn, {"params": params, "batch_stats": stats},
                            images.shape, k_drop)
    rep = jax_replicate(mesh, jstate)
    b = jax_shard_batch(mesh, {"image": images, "mask": labels})
    new, jl, jcm = jax_train_step(C, KSDD_LOSS, KSDD_AUG, donate_state=False)(
        rep, b["image"], b["mask"], key)

    valid = np.arange(N) < 5
    ev_images, ev_labels = seg_batch(4, n=N, num_classes=C)
    ev_images[~valid], ev_labels[~valid] = 0, 0
    eb = jax_shard_batch(mesh, {"image": ev_images, "mask": ev_labels, "valid": valid})
    jel, jep, _ = jax_eval_step(C, KSDD_LOSS)(new, eb["image"], eb["mask"], eb["valid"])

    port = launch(workers.seg_step_and_eval,
                  (sd, BASE, C, images, labels, draws, keep, KSDD_LOSS, KSDD_AUG, LR, WD,
                   ev_images, ev_labels, valid), devices=["cpu", "cpu"])
    return {"jax": {"losses": {k: float(v) for k, v in jl.items()}, "cm": np.asarray(jcm),
                    "params": jax.device_get(new.params),
                    "stats": jax.device_get(new.batch_stats),
                    "eval_losses": {k: float(v) for k, v in jel.items()},
                    "preds": np.asarray(jep)},
            "port": port, "valid": valid, "ev_labels": ev_labels, "images": images,
            "labels": labels}


def test_the_ranks_ratios_differ_from_the_global_one(runs):
    """The case is one where a per-rank mean would be wrong: for logits
    that favour the background, the weighted CE of the two halves,
    averaged, is not the whole batch's."""
    logits = torch.randn(N, 64, 32, C, generator=torch.Generator().manual_seed(0))
    logits[..., 0] += 3.0
    lbl = torch.from_numpy(runs["labels"]).long()
    whole = combined_segmentation_loss(logits, lbl, **KSDD_LOSS.kwargs())["ce_loss"]
    halves = [combined_segmentation_loss(logits[s], lbl[s], **KSDD_LOSS.kwargs())["ce_loss"]
              for s in (slice(0, N // 2), slice(N // 2, N))]
    assert abs(float(sum(halves) / 2 - whole)) > 0.1 * float(whole)


def test_losses_match_the_jax_mesh(runs):
    j, t = runs["jax"], runs["port"]
    assert set(t["losses"]) == set(j["losses"]) == {"ce_loss", "dice_loss", "total_loss"}
    for k, v in t["losses"].items():
        np.testing.assert_allclose(v, j["losses"][k], rtol=1e-5, err_msg=k)


def test_parameters_and_statistics_match_the_jax_mesh(runs):
    j, t = runs["jax"], runs["port"]
    params, stats = jax_trees_from_state_dict(
        {k: torch.from_numpy(v) for k, v in t["state"].items()}, model="seg_unet")
    n = 0
    for path, p, ref in _pairs(params, j["params"]):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
        n += 1
    assert n == 64
    for path, v, ref in _pairs(stats, j["stats"]):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-7, err_msg=path)
    assert t["ranks_equal"]


def test_confusion_matrix_is_the_global_batch(runs):
    """Both ranks' augmented rows, summed over the group [exact]."""
    t = runs["port"]
    assert int(t["cm"].sum()) == N * 64 * 32
    np.testing.assert_array_equal(t["cm"], runs["jax"]["cm"])


def test_eval_step_on_a_padded_batch_matches_the_jax_mesh(runs):
    """Losses over the 5 valid rows of both ranks [rtol 1e-5], predictions
    [exact], and the matrix of the valid rows of both ranks."""
    j, t, valid = runs["jax"], runs["port"], runs["valid"]
    for k, v in t["eval_losses"].items():
        np.testing.assert_allclose(v, j["eval_losses"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(t["preds"], j["preds"])
    lbl, pred = runs["ev_labels"][valid], t["preds"][valid]
    want = np.bincount(lbl.ravel() * C + pred.ravel(), minlength=C * C).reshape(C, C)
    np.testing.assert_array_equal(t["eval_cm"], want)
