"""Rematerialization in the port's train steps (``remat='full_res'|'full'``,
tpu_unet_torch/train/steps.py and models/blocks.py), on the CPU at
base_features=4.

Against the port's plain step from the same weights and draws: the losses
and the BN running statistics (and ``num_batches_tracked``) [exact], the
parameters after one f32 SGD step [atol 1e-6]; the tagged blocks really
run again in the backward, and their BatchNorms update once. Against the
JAX package's step with the same ``remat`` over a model built with
``remat_full_res=True``, with the same draws: the tolerances of
tests/test_torch_train_steps.py and tests/test_torch_seg_steps.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.models as jmodels
from _torch_parity import (jax_accum_draws, jax_draws, jax_dropout_keep,  # noqa: F401
                           one_torch_thread, seg_batch, u8_batch)
from tpu_unet.train import make_anomaly_train_step as jax_anomaly_step
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train import make_seg_train_step as jax_seg_step
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models.blocks import BatchNorm2d, recomputing
from tpu_unet_torch.models.unet import AnomalyUNet, SegmentationUNet
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (AnomalyLossConfig, AugmentConfig, SegLossConfig,
                                        make_anomaly_train_step, make_seg_train_step)
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict, state_dict_from_jax

BASE, LR = 4, 0.05
AUG = AugmentConfig()
LOSS = AnomalyLossConfig()
SEG_AUG = AugmentConfig(degrees=5.0)
SEG_LOSS = SegLossConfig(class_weights=(1.0, 50.0, 50.0))
C = 3


def _model(kind):
    """A seeded port model with the 'full_res' tags where the JAX model has
    them (AnomalyUNet, SegmentationUNet); UNet++ has none."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        if kind == "anomaly":
            return AnomalyUNet(base_features=BASE, remat_full_res=True)
        if kind == "seg":
            return SegmentationUNet(n_classes=C, base_features=BASE, remat_full_res=True)
        return build_model("unetpp", n_classes=C, base_features=BASE, deep_supervision=True)


class _BNCalls:
    """Counts each BatchNorm's train-mode forwards, recomputed ones apart."""

    def __init__(self, model):
        self.plain, self.again = {}, {}
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm2d):
                m.register_forward_hook(functools.partial(self._hook, name))

    def _hook(self, name, module, args, out):
        d = self.again if recomputing() else self.plain
        d[name] = d.get(name, 0) + 1


def _port_step(kind, remat, grad_accum=1, seed=0):
    """One f32 SGD step of the port; returns (losses, state, BN calls)."""
    state = create_train_state(_model(kind), "sgd", LR, 1e-4, device="cpu")
    calls = _BNCalls(state.model)
    if kind == "anomaly":
        img, mask = u8_batch(seed)
        draws = jax_accum_draws(jax.random.key(seed), len(img), AUG, grad_accum)
        losses = make_anomaly_train_step(LOSS, AUG, grad_accum=grad_accum,
                                         remat=remat).with_draws(state, img, mask, draws)
        return losses, state, calls
    images, labels = seg_batch(seed, n=4, h=32, w=32, num_classes=C)
    g = torch.Generator().manual_seed(seed)
    step = make_seg_train_step(C, SEG_LOSS, SEG_AUG, grad_accum=grad_accum, remat=remat)
    augment, dropout = step.draws(state.model, len(images), g)
    losses, _ = step.with_draws(state, images, labels, augment, dropout)
    return losses, state, calls


def _assert_same_step(plain, rem, param_atol=1e-6):
    (pl, ps, _), (rl, rs, _) = plain, rem
    assert {k: float(v) for k, v in rl.items()} == {k: float(v) for k, v in pl.items()}
    want = ps.model.state_dict()
    for k, v in rs.model.state_dict().items():
        if "running" in k or "num_batches_tracked" in k:
            assert torch.equal(v, want[k]), k
        else:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=param_atol,
                                       err_msg=k)


@pytest.mark.parametrize("kind,remat", [("anomaly", "full_res"), ("anomaly", "full"),
                                        ("seg", "full_res"), ("seg", "full"),
                                        ("unetpp", "full")])
def test_remat_step_equals_the_plain_step(kind, remat):
    plain = _port_step(kind, "none")
    rem = _port_step(kind, remat)
    _assert_same_step(plain, rem)
    _, state, calls = rem
    for m in state.model.modules():
        if isinstance(m, BatchNorm2d):
            assert int(m.num_batches_tracked) == 1
    assert calls.plain == plain[2].plain  # one update-bearing forward per BN
    if remat == "full":  # every BN runs again in the backward, without updating
        assert calls.again == calls.plain
    else:  # only the tagged rows run again: inc, down1, up3/up4 of each decoder
        rows = {name.split(".")[0] for name in calls.again}
        want = {"inc", "down1"} | {f"up{i}{s}" for i in (3, 4)
                                   for s in (("_recon", "_seg") if kind == "anomaly" else ("",))}
        assert rows == want
        assert all(calls.again[n] == 1 for n in calls.again)


@pytest.mark.parametrize("kind", ["anomaly", "seg"])
def test_full_res_without_tags_is_the_plain_step(kind):
    """A model built without ``remat_full_res`` has no tags: 'full_res'
    recomputes nothing, as in JAX."""
    model = _model(kind)
    for m in model.modules():
        if hasattr(m, "remat_tag"):
            m.remat_tag = None
    state = create_train_state(model, "sgd", LR, 1e-4, device="cpu")
    calls = _BNCalls(state.model)
    img, mask = u8_batch(0)
    if kind == "anomaly":
        make_anomaly_train_step(LOSS, AUG, remat="full_res").with_draws(
            state, img, mask, jax_draws(jax.random.key(0), len(img), AUG))
    else:
        images, labels = seg_batch(0, n=4, h=32, w=32, num_classes=C)
        step = make_seg_train_step(C, SEG_LOSS, SEG_AUG, remat="full_res")
        step(state, images, labels, torch.Generator().manual_seed(0))
    assert calls.again == {} and calls.plain


@pytest.mark.parametrize("kind,remat", [("anomaly", "full_res"), ("seg", "full")])
def test_grad_accum_chains_the_statistics_once_per_microbatch(kind, remat):
    plain = _port_step(kind, "none", grad_accum=2, seed=3)
    rem = _port_step(kind, remat, grad_accum=2, seed=3)
    _assert_same_step(plain, rem)
    assert int(rem[1].model.inc.double_conv[1].num_batches_tracked) == 2


# --- against the JAX package's remat steps ----------------------------------

def _pairs(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in sorted(a):
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(a[k]), np.asarray(b[k])


def _jax_state(kind):
    name = "anomaly_unet" if kind == "anomaly" else "seg_unet"
    params, stats = jax_trees_from_state_dict(_model(kind).state_dict(), model=name)
    jmodel = (jmodels.AnomalyUNet(base_features=BASE, remat_full_res=True) if kind == "anomaly"
              else jmodels.SegmentationUNet(n_classes=C, base_features=BASE,
                                            remat_full_res=True))
    return JaxTrainState.create(apply_fn=jmodel.apply, params=params, batch_stats=stats,
                                tx=jax_optimizer("sgd", LR, 1e-4)), name


@pytest.mark.parametrize("kind,remat,grad_accum", [("anomaly", "full_res", 1),
                                                   ("anomaly", "full", 1),
                                                   ("seg", "full_res", 1),
                                                   ("seg", "full", 2)])
def test_remat_step_matches_the_jax_remat_step(kind, remat, grad_accum):
    jstate, name = _jax_state(kind)
    key = jax.random.key(11)
    model = _model(kind)
    model.load_state_dict(state_dict_from_jax(*jax.device_get(
        (jstate.params, jstate.batch_stats)), model=name))
    state = create_train_state(model, "sgd", LR, 1e-4, device="cpu")
    if kind == "anomaly":
        img, mask = u8_batch(11)
        new_j, jl = jax_anomaly_step(LOSS, AUG, donate_state=False, grad_accum=grad_accum,
                                     remat=remat)(jstate, jnp.asarray(img), jnp.asarray(mask),
                                                  key)
        draws = (jax_draws(key, len(img), AUG) if grad_accum == 1
                 else jax_accum_draws(key, len(img), AUG, grad_accum))
        tl = make_anomaly_train_step(LOSS, AUG, grad_accum=grad_accum, remat=remat).with_draws(
            state, img, mask, draws)
    else:
        images, labels = seg_batch(11, n=4, h=32, w=32, num_classes=C)
        new_j, jl, _ = jax_seg_step(C, SEG_LOSS, SEG_AUG, donate_state=False,
                                    grad_accum=grad_accum, remat=remat)(
            jstate, jnp.asarray(images), jnp.asarray(labels), key)
        keys = [key] if grad_accum == 1 else list(jax.random.split(key, grad_accum))
        draws, keeps = [], []
        for k, img in zip(keys, np.split(images, grad_accum)):
            k_aug, k_drop = jax.random.split(k)
            draws.append(jax_draws(k_aug, len(img), SEG_AUG))
            keeps.append(jax_dropout_keep(jstate.apply_fn, {"params": jstate.params,
                                                            "batch_stats": jstate.batch_stats},
                                          img.shape, k_drop))
        tl, _ = make_seg_train_step(C, SEG_LOSS, SEG_AUG, grad_accum=grad_accum,
                                    remat=remat).with_draws(state, images, labels, draws, keeps)
    for k in tl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    params, stats = jax_trees_from_state_dict(state.model.state_dict(), model=name)
    for path, p, ref in _pairs(params, jax.device_get(new_j.params)):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
    for path, v, ref in _pairs(stats, jax.device_get(new_j.batch_stats)):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-6 if grad_accum > 1 else 1e-7,
                                   err_msg=path)
    assert int(state.model.inc.double_conv[1].num_batches_tracked) == grad_accum
