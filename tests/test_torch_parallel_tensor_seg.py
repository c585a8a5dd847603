"""The port's tensor parallelism on the segmentation models and its
checkpoints (gloo CPU ranks; base 4, 32 x 32 px, 4 classes, a global batch
of 8).

- The seg step with the bottleneck dropout on a (2, 1, 2) ('data', 'space',
  'model') mesh against the JAX seg step on the same mesh: same weights,
  draws (``_torch_parity.jax_draws``) and keep mask
  (``_torch_parity.jax_dropout_keep``); losses 1e-5 relative, the
  confusion matrix exact, SGD parameters 1e-6 absolute and BN statistics
  1e-5 relative (the data-parallel tests' tolerances), then the eval step
  on the updated state.
- The attention UNet (its gates' W_g and W_x column, psi row) and UNet++
  with deep supervision (its ``up{i}_{j}`` column) on a (1, 1, 2) mesh
  against world size 1 at the same tolerances.
- ``.pth`` files between tensor parallelism and world size 1: a
  tensor-parallel file holds whole tensors and loads strict at world size
  1; it and a world-size-1 file resume on the mesh, loaded before the state
  is placed (as the CLIs do) or after it, each rank holding its slices.
"""

import os

import jax
import numpy as np
import pytest
import torch

import _torch_tp_workers as workers
import tpu_unet.models as jmodels
from _torch_parity import jax_draws, jax_dropout_keep, one_torch_thread, seg_batch  # noqa: F401
from _torch_parity import u8_batch
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet.parallel import shard_batch as jax_shard_batch
from tpu_unet.parallel import shard_state as jax_shard_state
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train import make_seg_eval_step as jax_eval_step
from tpu_unet.train import make_seg_train_step as jax_train_step
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.train.checkpoint import save_checkpoint
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (AnomalyLossConfig, AugmentConfig, SegLossConfig,
                                        make_anomaly_train_step)
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

BASE, LR, WD, C, N = 4, 0.05, 1e-4, 4, 8
AUG = AugmentConfig(degrees=5.0)
LOSS = SegLossConfig()


def _seeded(name, **kw):
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return build_model(name, base_features=BASE, **kw).state_dict()


def _pairs(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in sorted(a):
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(a[k]), np.asarray(b[k])


def _assert_states_close(got, want, model):
    params, stats = jax_trees_from_state_dict({k: torch.from_numpy(v) for k, v in got.items()},
                                              model=model)
    ref_p, ref_s = want
    for path, p, ref in _pairs(params, ref_p):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
    for path, s, ref in _pairs(stats, ref_s):
        np.testing.assert_allclose(s, ref, rtol=1e-5, atol=1e-7, err_msg=path)


@pytest.fixture(scope="module")
def seg_runs(devices):
    sd = _seeded("seg_unet", n_classes=C)
    params, stats = jax_trees_from_state_dict(sd, model="seg_unet")
    jstate = JaxTrainState.create(
        apply_fn=jmodels.build_model("seg_unet", n_classes=C, base_features=BASE).apply,
        params=params, batch_stats=stats, tx=jax_optimizer("sgd", LR, WD))
    mesh = jax_make_mesh(n_data=2, n_space=1, n_model=2)
    images, labels = seg_batch(3, n=N, h=32, w=32, num_classes=C)
    key = jax.random.key(7)
    k_aug, k_drop = jax.random.split(key)
    draws = jax_draws(k_aug, N, AUG)
    keep = jax_dropout_keep(jstate.apply_fn, {"params": params, "batch_stats": stats},
                            images.shape, k_drop)
    rep = jax_shard_state(mesh, jstate, tp=True)
    b = jax_shard_batch(mesh, {"image": images, "mask": labels})
    new, jl, jcm = jax_train_step(C, LOSS, AUG, donate_state=False)(
        rep, b["image"], b["mask"], key)
    valid = np.arange(N) < 5
    ev_images, ev_labels = seg_batch(4, n=N, h=32, w=32, num_classes=C)
    ev_images[~valid], ev_labels[~valid] = 0, 0
    eb = jax_shard_batch(mesh, {"image": ev_images, "mask": ev_labels, "valid": valid})
    jel, jep, _ = jax_eval_step(C, LOSS)(new, eb["image"], eb["mask"], eb["valid"])
    port = launch(workers.seg_step,
                  ("seg_unet", sd, {"n_classes": C, "base_features": BASE}, 2, images,
                   labels, draws, keep, LOSS, AUG, LR, WD, ev_images, ev_labels, valid),
                  devices=["cpu"] * 4)
    return {"jax": {"losses": {k: float(v) for k, v in jl.items()}, "cm": np.asarray(jcm),
                    "params": jax.device_get(new.params),
                    "stats": jax.device_get(new.batch_stats),
                    "eval_losses": {k: float(v) for k, v in jel.items()},
                    "preds": np.asarray(jep)},
            "port": port, "valid": valid, "keep": keep}


def test_seg_step_with_dropout_matches_the_jax_tp_step(seg_runs):
    j, t = seg_runs["jax"], seg_runs["port"]
    assert not seg_runs["keep"].all()  # the dropout drops channels
    assert set(t["losses"]) == set(j["losses"])
    for k, v in t["losses"].items():
        np.testing.assert_allclose(v, j["losses"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(t["cm"], j["cm"])
    _assert_states_close(t["state"], (j["params"], j["stats"]), "seg_unet")
    assert t["agree"]


def test_seg_eval_after_the_tp_step_matches_jax(seg_runs):
    j, t, valid = seg_runs["jax"], seg_runs["port"], seg_runs["valid"]
    for k, v in t["eval_losses"].items():
        np.testing.assert_allclose(v, j["eval_losses"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(t["preds"][valid], j["preds"][valid])
    assert t["eval_cm"].sum() == valid.sum() * 32 * 32


EXTENSIONS = {"attn_unet": {"n_classes": C}, "unetpp": {"n_classes": C,
                                                        "deep_supervision": True}}


@pytest.mark.parametrize("name", list(EXTENSIONS))
def test_extension_under_tp_matches_world_size_one(name):
    kw = {"base_features": BASE, **EXTENSIONS[name]}
    sd = _seeded(name, **EXTENSIONS[name])
    images, labels = seg_batch(5, n=4, h=32, w=32, num_classes=C)
    draws = jax_draws(jax.random.key(9), 4, AUG)
    model = build_model(name, **kw)
    keep = model.sample_dropout(4, torch.Generator().manual_seed(3))
    args = (name, sd, kw, images, labels, draws, keep, LOSS, AUG, LR, WD)
    one = workers.seg_step(*args[:3], 1, *args[3:])
    tp = launch(workers.seg_step, (*args[:3], 2, *args[3:]), devices=["cpu", "cpu"])
    for k, v in tp["losses"].items():
        np.testing.assert_allclose(v, one["losses"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tp["cm"], one["cm"])
    _assert_states_close(tp["state"], jax_trees_from_state_dict(
        {k: torch.from_numpy(v) for k, v in one["state"].items()}, model=name), name)
    assert tp["agree"]
    if name == "attn_unet":  # W_g, W_x on C_out; psi (1 x F_int) on C_in; bn2 whole
        att = "up1.att"
        assert tp["dims"][f"{att}.g.conv1.weight"] == 0
        assert tp["dims"][f"{att}.x.conv1.weight"] == 0
        assert tp["dims"][f"{att}.conv2.weight"] == 1
        assert f"{att}.bn2.weight" not in tp["dims"]
    else:
        assert tp["dims"]["up0_1.weight"] == 1 and "outc_1.conv.weight" not in tp["dims"]


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("tp_ckpt"))
    sd = _seeded("anomaly_unet")
    img, mask = u8_batch(13, n=4)
    draws = jax_draws(jax.random.key(5), 4, AugmentConfig())
    loss = AnomalyLossConfig()
    # A world-size-1 Adam step's checkpoint.
    model = build_model("anomaly_unet", base_features=BASE)
    model.load_state_dict(sd)
    one = create_train_state(model, "adam", 1e-3, WD, device="cpu")
    make_anomaly_train_step(loss, AugmentConfig()).with_draws(one, img, mask, draws)
    save_checkpoint(one, 2, 0.25, os.path.join(work, "ws1.pth"))
    out = launch(workers.checkpoint_round_trip,
                 (sd, BASE, 2, img, mask, draws, loss, AugmentConfig(), 1e-3, WD, work),
                 devices=["cpu", "cpu"])
    return work, out


def test_a_tp_checkpoint_loads_strict_at_world_size_one(round_trip):
    work, out = round_trip
    blob = torch.load(os.path.join(work, "tp.pth"), weights_only=True)
    model = build_model("anomaly_unet", base_features=BASE)
    model.load_state_dict(blob["model_state_dict"], strict=True)
    state, moments = out["written"]
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)
    opt = create_train_state(model, "adam", 1e-3, WD, device="cpu").optimizer
    opt.load_state_dict(blob["optimizer_state_dict"])
    names = [n for n, _ in model.named_parameters()]
    for i, st in blob["optimizer_state_dict"]["state"].items():
        np.testing.assert_array_equal(st["exp_avg"].numpy(), moments[names[i]]["exp_avg"])
    assert blob["epoch"] == 4


@pytest.mark.parametrize("name", ["tp.pth", "ws1.pth"])
def test_checkpoints_resume_under_tp(round_trip, name):
    """Each rank holds its slices of the file's whole tensors, loaded before
    or after the state is placed; Adam's moments likewise; a step runs."""
    work, out = round_trip
    blob = torch.load(os.path.join(work, name), weights_only=True)
    sd = blob["model_state_dict"]
    names = [n for n, _ in build_model("anomaly_unet", base_features=BASE).named_parameters()]
    moments = {names[i]: st["exp_avg"] for i, st in blob["optimizer_state_dict"]["state"].items()}
    for part in out["ranks"]:
        got, r = part[name], part[name]["rank"]
        dims = got["dims"]
        assert got["epoch"] == blob["epoch"] and np.isfinite(got["loss"])
        for k, v in sd.items():
            want = v.chunk(2, dims[k])[r].numpy() if k in dims else v.numpy()
            np.testing.assert_array_equal(got["before"][k], want, err_msg=k)
            np.testing.assert_array_equal(got["after"][k], want, err_msg=k)
        for k, v in moments.items():
            want = v.chunk(2, dims[k])[r].numpy() if k in dims else v.numpy()
            np.testing.assert_array_equal(got["moments_after"][k], want, err_msg=k)
