"""The port's 'space' axis on the seg steps against the JAX package's on the
same ('data', 'space') mesh (gloo CPU ranks; base 4, 32 x 16 px, 4
classes, a global batch of 4).

The JAX side runs ``make_mesh(n_data=2, n_space=2)`` of the 8 virtual CPU
devices with the batch sharded ``P('data', 'space')``; the port runs four
ranks whose steps split each image's rows over two space ranks. The same
weights (the port's seeded init, carried over by
``jax_trees_from_state_dict``), draws (``_torch_parity.jax_draws``) and
dropout masks (``jax_dropout_keep``). Tolerances are
``tests/test_spatial_kolektorsdd.py``'s: the loss 1e-4 relative, the
confusion matrix equal, the parameters (and BatchNorm statistics) rtol
2e-4 / atol 2e-5, after one SGD step:

- SegmentationUNet with its bottleneck dropout, then the eval step on the
  updated state (losses, the predictions gathered back to whole images);
- the same with ``grad_accum=2`` (N split first, then H, as
  ``tests/test_grad_accum.py`` does);
- with ``--fsdp``: FSDP2 over 'data', replicated over 'space'.

The int8 seg eval on the (2, 2) mesh (K2's plain version) holds the
one-process int8 eval bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_space_workers as workers
import tpu_unet.models as jmodels
from _torch_parity import jax_draws, jax_dropout_keep, one_torch_thread, seg_batch  # noqa: F401
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet.parallel import shard_batch as jax_shard_batch
from tpu_unet.parallel import shard_state as jax_shard_state
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train import make_seg_eval_step as jax_eval_step
from tpu_unet.train import make_seg_train_step as jax_train_step
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.train.steps import AugmentConfig, SegLossConfig
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

BASE, LR, WD, C, N, H, W = 4, 0.05, 1e-4, 4, 4, 32, 16
AUG = AugmentConfig(degrees=5.0)
LOSS = SegLossConfig(class_weights=(1.0, 5.0, 5.0, 5.0))
LOSS_RTOL, RTOL, ATOL = 1e-4, 2e-4, 2e-5


def seeded(name, **kw):
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return build_model(name, base_features=BASE, n_classes=C, **kw).state_dict()


def jax_case(name, sd, model_kw, mesh, images, labels, key, grad_accum=1, fsdp=False,
             tp=False, eval_batch=None):
    """The JAX seg step (and optionally its eval step) on ``mesh`` with the
    batch sharded over 'data' and 'space', and the draws and keep masks
    that it took from ``key``, for the port (at the images' size)."""
    params, stats = jax_trees_from_state_dict(sd, model=name)
    apply_fn = jmodels.build_model(name, **model_kw).apply
    jstate = JaxTrainState.create(apply_fn=apply_fn, params=params, batch_stats=stats,
                                  tx=jax_optimizer("sgd", LR, WD))
    variables = {"params": params, "batch_stats": stats}
    draws, keeps = [], []
    n, (h, w) = N // grad_accum, images.shape[1:3]
    for k in (jax.random.split(key, grad_accum) if grad_accum > 1 else [key]):
        k_aug, k_drop = jax.random.split(k)
        draws.append(jax_draws(k_aug, n, AUG))
        keeps.append(jax_dropout_keep(apply_fn, variables, (n, h, w, 3), k_drop)
                     if model_kw.get("dropout", 0.1) > 0 else None)
    rep = jax_shard_state(mesh, jstate, fsdp=fsdp, tp=tp)
    b = jax_shard_batch(mesh, {"image": images, "mask": labels}, spatial=True)
    new, jl, jcm = jax_train_step(C, LOSS, AUG, donate_state=False, grad_accum=grad_accum)(
        rep, b["image"], b["mask"], key)
    out = {"losses": {k: float(v) for k, v in jl.items()}, "cm": np.asarray(jcm),
           "params": jax.device_get(new.params), "stats": jax.device_get(new.batch_stats)}
    if eval_batch is not None:
        ev_images, ev_labels, valid = eval_batch
        eb = jax_shard_batch(mesh, {"image": ev_images, "mask": ev_labels}, spatial=True)
        jel, jep, jecm = jax_eval_step(C, LOSS)(new, eb["image"], eb["mask"],
                                                jax_shard_batch(mesh, valid))
        out.update(eval_losses={k: float(v) for k, v in jel.items()},
                   preds=np.asarray(jep), eval_cm=np.asarray(jecm))
    if grad_accum == 1:
        draws, keeps = draws[0], keeps[0]
    return out, draws, keeps


def _pairs(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in sorted(a):
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(a[k]), np.asarray(b[k])


def assert_matches_jax(port, ref, name, spread=None):
    """Losses, matrix and the whole updated state within the tolerances;
    ``spread`` (another JAX run's result) widens each parameter leaf's
    absolute tolerance to twice the JAX package's own difference between
    the two runs on that leaf."""
    assert set(port["losses"]) == set(ref["losses"])
    for k, v in port["losses"].items():
        np.testing.assert_allclose(v, ref["losses"][k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_array_equal(port["cm"], ref["cm"])
    params, stats = jax_trees_from_state_dict(
        {k: torch.from_numpy(v) for k, v in port["state"].items()}, model=name)
    other = dict((path, b) for path, b, _ in _pairs(spread["params"], ref["params"])) \
        if spread else {}
    for path, p, want in _pairs(params, ref["params"]):
        atol = max(ATOL, 2 * float(np.abs(other[path] - want).max())) if other else ATOL
        np.testing.assert_allclose(p, want, rtol=RTOL, atol=atol, err_msg=path)
    for path, s, want in _pairs(stats, ref["stats"]):
        np.testing.assert_allclose(s, want, rtol=RTOL, atol=ATOL, err_msg=path)
    assert port["agree"]  # every rank holds the same state
    assert port["halo"]["exchanges"] > 0


CASES = {"dropout": {}, "grad_accum": {"grad_accum": 2}, "fsdp": {"fsdp": True}}


@pytest.fixture(scope="module")
def runs(devices):
    sd = seeded("seg_unet")
    model_kw = {"n_classes": C, "base_features": BASE}
    mesh = jax_make_mesh(n_data=2, n_space=2)
    images, labels = seg_batch(3, n=N, h=H, w=W, num_classes=C)
    valid = np.arange(N) < 3
    ev_images, ev_labels = seg_batch(4, n=N, h=H, w=W, num_classes=C)
    ev_images[~valid], ev_labels[~valid] = 0, 0
    ev = (ev_images, ev_labels, valid)
    refs, cases = {}, []
    for i, (case, kw) in enumerate(CASES.items()):
        ref, draws, keep = jax_case("seg_unet", sd, model_kw, mesh, images, labels,
                                    jax.random.key(7 + i), eval_batch=ev if i == 0 else None,
                                    **kw)
        refs[case] = ref
        cases.append((draws, keep, kw.get("grad_accum", 1), kw.get("fsdp", False),
                      ev if i == 0 else None))
    port = launch(workers.seg_cases, ("seg_unet", sd, model_kw, 2, 1, cases, images, labels,
                                      LOSS, AUG, LR, WD), devices=["cpu"] * 4, timeout=120)
    return {"jax": refs, "port": dict(zip(CASES, port)), "valid": valid,
            "eval_labels": ev_labels}


@pytest.mark.parametrize("case", list(CASES))
def test_seg_step_on_a_data_space_mesh_matches_jax(runs, case):
    assert_matches_jax(runs["port"][case], runs["jax"][case], "seg_unet")


def test_seg_eval_on_a_data_space_mesh_matches_jax(runs):
    j, t, valid = runs["jax"]["dropout"], runs["port"]["dropout"], runs["valid"]
    for k, v in t["eval_losses"].items():
        np.testing.assert_allclose(v, j["eval_losses"][k], rtol=LOSS_RTOL, err_msg=k)
    assert t["preds"].shape == (N, H, W)  # gathered back to whole images
    np.testing.assert_array_equal(t["preds"][valid], j["preds"][valid])
    # The JAX step's matrix counts the padded row too (its CLIs drop it on
    # the host): the valid rows' matrix from its predictions.
    labels = runs["eval_labels"][valid].astype(np.int64).ravel()
    want = np.bincount(labels * C + j["preds"][valid].ravel(), minlength=C * C)
    np.testing.assert_array_equal(t["eval_cm"], want.reshape(C, C))
    assert t["eval_cm"].sum() == valid.sum() * H * W


def test_int8_seg_eval_on_a_data_space_mesh_is_one_process_bit_for_bit():
    """K2's plain version on halo'd rows: every prediction, the matrix and
    the losses (to their reductions' rounding) equal the one-process int8
    eval's."""
    sd = seeded("seg_unet")
    model_kw = {"n_classes": C, "base_features": BASE}
    images, labels = seg_batch(5, n=N, h=H, w=W, num_classes=C)
    calib, _ = seg_batch(6, n=4, h=H, w=W, num_classes=C)
    valid = np.arange(N) < 3
    args = ("seg_unet", sd, model_kw)
    one = workers.int8_eval(*args, 1, calib, images, labels, valid, LOSS)
    mesh = launch(workers.int8_eval, (*args, 2, calib, images, labels, valid, LOSS),
                  devices=["cpu"] * 4, timeout=120)
    np.testing.assert_array_equal(mesh["preds"], one["preds"])
    np.testing.assert_array_equal(mesh["cm"], one["cm"])
    for k, v in one["losses"].items():
        np.testing.assert_allclose(mesh["losses"][k], v, rtol=1e-6, err_msg=k)
    # 18 K2 convs per batch, each input halo'd once.
    assert mesh["halo"]["exchanges"] == 18 and one["halo"]["exchanges"] == 0
