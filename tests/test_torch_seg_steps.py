"""The port's segmentation train and eval steps (tpu_unet_torch/train/steps.py),
and SegmentationUNet's train mode against the JAX package's,
on the CPU at base_features=4, KolektorSDD-like 64 x 32 batches; and the
step on UNet++ with deep supervision (the mean of the four heads' losses)
and on the attention UNet.

Both packages start from the same seeded weights and see the same augment
draws (``_torch_parity.jax_draws``) and the same bottleneck dropout mask,
read from a JAX apply (``_torch_parity.jax_dropout_keep``). Whole steps run
SGD in f32, at the tolerances of tests/test_torch_train_steps.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.models as jmodels
from _torch_parity import (jax_draws, jax_dropout_keep, one_torch_thread,  # noqa: F401
                           seg_batch)
from tpu_unet.ops.augment import train_transform as jax_train_transform
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train import make_seg_eval_step as jax_eval_step
from tpu_unet.train import make_seg_train_step as jax_train_step
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.augment import train_transform
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (AugmentConfig, SegLossConfig, make_seg_eval_step,
                                        make_seg_train_step)
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict, state_dict_from_jax

BASE, LR = 4, 0.05
KSDD_AUG = AugmentConfig(degrees=5.0, brightness=0.1, contrast=0.1, saturation=0.1, hue=0.05)
KSDD_LOSS = SegLossConfig(class_weights=(1.0, 50.0, 50.0))


# The port's build_model arguments of each model the steps are held on.
_MODELS = {"seg_unet": ("seg_unet", {}),
           "unetpp_ds": ("unetpp", {"deep_supervision": True}),
           "attn_unet": ("attn_unet", {})}


@functools.lru_cache(maxsize=None)
def _init(c, model="seg_unet"):
    name, kw = _MODELS[model]
    with torch.random.fork_rng():
        torch.manual_seed(0)
        sd = build_model(name, n_classes=c, base_features=BASE, **kw).state_dict()
    params, stats = jax_trees_from_state_dict(sd, model=name)
    return params, stats


def _jax_model(c, model="seg_unet"):
    return jmodels.build_model(_MODELS[model][0], n_classes=c, base_features=BASE,
                               **_MODELS[model][1])


def _jax_state(c, model="seg_unet"):
    params, stats = _init(c, model)
    return JaxTrainState.create(apply_fn=_jax_model(c, model).apply, params=params,
                                batch_stats=stats, tx=jax_optimizer("sgd", LR, 1e-4))


def _port_state(jstate, c, precision="f32", model="seg_unet"):
    from tpu_unet_torch.core.precision import get_policy
    name, kw = _MODELS[model]
    net = build_model(name, n_classes=c, base_features=BASE, policy=get_policy(precision),
                      **kw)
    params, stats = jax.device_get((jstate.params, jstate.batch_stats))
    net.load_state_dict(state_dict_from_jax(params, stats, model=name, **kw))
    return create_train_state(net, "sgd", LR, 1e-4, device="cpu")


def _pairs(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in sorted(a):
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(a[k]), np.asarray(b[k])


def _jax_micro_draws(jstate, images, key, aug, grad_accum):
    """Each microbatch's augment draws and dropout keep mask, as the JAX
    step derives them from ``key``."""
    keys = [key] if grad_accum == 1 else list(jax.random.split(key, grad_accum))
    draws, keeps = [], []
    for k, img in zip(keys, np.split(images, grad_accum)):
        k_aug, k_drop = jax.random.split(k)
        draws.append(jax_draws(k_aug, len(img), aug))
        keeps.append(jax_dropout_keep(jstate.apply_fn,
                                      {"params": jstate.params, "batch_stats": jstate.batch_stats},
                                      img.shape, k_drop))
    return draws, keeps


def _step_pair(c, grad_accum, with_confusion, aug, loss, seed, hw=(64, 32), model="seg_unet"):
    images, labels = seg_batch(seed, n=4, h=hw[0], w=hw[1], num_classes=c)
    key = jax.random.key(seed)
    jstate = _jax_state(c, model)
    new_j, jl, jcm = jax_train_step(c, loss, aug, with_confusion=with_confusion,
                                    donate_state=False, grad_accum=grad_accum)(
        jstate, jnp.asarray(images), jnp.asarray(labels), key)
    draws, keeps = _jax_micro_draws(jstate, images, key, aug, grad_accum)
    assert all(0 < int(k.sum()) < k.numel() for k in keeps)  # some channels dropped
    state = _port_state(jstate, c, model=model)
    tl, tcm = make_seg_train_step(c, loss, aug, with_confusion=with_confusion,
                                  grad_accum=grad_accum).with_draws(state, images, labels,
                                                                    draws, keeps)
    return dict(jax=(new_j, jl, jcm), port=(state, tl, tcm))


@pytest.fixture(scope="module")
def ksdd_step():
    """One f32 SGD step at KolektorSDD's class weights and augment, C = 3."""
    return _step_pair(3, 1, True, KSDD_AUG, KSDD_LOSS, seed=1)


def test_losses_match_jax(ksdd_step):
    (_, jl, _), (state, tl, _) = ksdd_step["jax"], ksdd_step["port"]
    assert set(tl) == set(jl) == {"ce_loss", "dice_loss", "total_loss"}
    for k in tl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    assert state.step == 1


def test_parameters_and_statistics_match_jax(ksdd_step):
    (new_j, _, _), (state, _, _) = ksdd_step["jax"], ksdd_step["port"]
    params, stats = jax_trees_from_state_dict(state.model.state_dict(), model="seg_unet")
    n = 0
    for path, p, ref in _pairs(params, jax.device_get(new_j.params)):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
        n += 1
    assert n == len(list(state.model.parameters()))
    for path, v, ref in _pairs(stats, jax.device_get(new_j.batch_stats)):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-7, err_msg=path)


def test_confusion_matrix_matches_jax(ksdd_step):
    """The batch's matrix from the augmented batch's predictions [exact],
    left on the device as an int64 tensor."""
    (_, _, jcm), (_, _, tcm) = ksdd_step["jax"], ksdd_step["port"]
    assert tcm.dtype == torch.int64 and int(tcm.sum()) == 4 * 64 * 32
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))


def test_grad_accum_matches_jax_scan():
    """grad_accum=2 (Gear's 4 classes and augment, no confusion matrix): two
    microbatches with their own draws and dropout masks, chained BN
    statistics, the mean gradient, one update, the mean losses."""
    aug = AugmentConfig(degrees=10.0, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1)
    pair = _step_pair(4, 2, False, aug, SegLossConfig(), seed=2, hw=(32, 32))
    (new_j, jl, jcm), (state, tl, tcm) = pair["jax"], pair["port"]
    assert jcm is None and tcm is None
    for k in tl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    params, stats = jax_trees_from_state_dict(state.model.state_dict(), model="seg_unet")
    for path, p, ref in _pairs(params, jax.device_get(new_j.params)):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
    # atol 1e-6: the second microbatch's statistics carry the first's noise.
    for path, v, ref in _pairs(stats, jax.device_get(new_j.batch_stats)):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-6, err_msg=path)
    assert state.model.inc.double_conv[1].num_batches_tracked == 2


@pytest.mark.parametrize("model,grad_accum", [("unetpp_ds", 1), ("unetpp_ds", 2),
                                              ("attn_unet", 1)])
def test_deep_supervision_and_attention_steps_match_jax(model, grad_accum):
    """One f32 SGD step of UNet++ with deep supervision (one loss per head,
    averaged key by key; the confusion matrix from the deepest head;
    UNet++'s x4_0 dropout mask) with and without grad_accum, and of the
    attention UNet (12 more BNs in its gates): the losses to 1e-5 relative,
    the matrix exactly, the parameters to 1e-6 and the statistics as
    test_grad_accum_matches_jax_scan holds them."""
    pair = _step_pair(3, grad_accum, True, KSDD_AUG, KSDD_LOSS, seed=5, hw=(32, 32),
                      model=model)
    (new_j, jl, jcm), (state, tl, tcm) = pair["jax"], pair["port"]
    assert set(tl) == set(jl) == {"ce_loss", "dice_loss", "total_loss"}
    for k in tl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    params, stats = jax_trees_from_state_dict(state.model.state_dict(),
                                              model=_MODELS[model][0])
    n = 0
    for path, p, ref in _pairs(params, jax.device_get(new_j.params)):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
        n += 1
    assert n == len(list(state.model.parameters()))
    for path, v, ref in _pairs(stats, jax.device_get(new_j.batch_stats)):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-6, err_msg=path)


def test_train_mode_dropout_is_the_given_mask():
    """SegmentationUNet in train mode under JAX's mask: the logits of flax's
    apply with that dropout key [atol 1e-5]. Eval mode ignores dropout."""
    c = 3
    images, _ = seg_batch(3, n=2, num_classes=c)
    x = np.array(jax.jit(functools.partial(jax_train_transform, **KSDD_AUG.kwargs()))(
        jnp.asarray(images), None, jax.random.key(0))[0])
    params, stats = _init(c)
    k_drop = jax.random.key(9)
    want, _ = _jax_model(c).apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                  train=True, rngs={"dropout": k_drop}, mutable=["batch_stats"])
    keep = jax_dropout_keep(_jax_model(c).apply, {"params": params, "batch_stats": stats},
                            x.shape, k_drop)
    model = _port_state(_jax_state(c), c).model.train()
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2), keep=keep).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError):  # train mode needs its draw
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    with pytest.raises(ValueError):  # one row per image, one column per channel
        model(torch.from_numpy(x).permute(0, 3, 1, 2), keep=keep[:, :3])
    model.eval()
    with torch.no_grad():
        a = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        b = model(torch.from_numpy(x).permute(0, 3, 1, 2), keep=torch.zeros_like(keep))
    assert torch.equal(a, b)


def test_sample_dropout_keeps_one_minus_the_rate():
    model = build_model("seg_unet", n_classes=3, base_features=BASE, dropout=0.25)
    keep = model.sample_dropout(64, torch.Generator().manual_seed(0))
    assert keep.dtype == torch.bool and tuple(keep.shape) == (64, 16 * BASE)
    assert abs(float(keep.float().mean()) - 0.75) < 0.05
    assert build_model("seg_unet", base_features=BASE, dropout=0.0).sample_dropout(
        2, torch.Generator()) is None


def test_generator_entry_point_trains():
    """``step(state, images, labels, generator)`` draws the augment and the
    dropout; Adam lowers the loss; uint8 labels are cast inside."""
    images, labels = seg_batch(4, num_classes=3)
    state = _port_state(_jax_state(3), 3)
    state = create_train_state(state.model, "adam", 1e-3, 0.0, device="cpu")
    step = make_seg_train_step(3, KSDD_LOSS, KSDD_AUG)
    g = torch.Generator().manual_seed(0)
    totals = []
    for _ in range(5):
        losses, cm = step(state, torch.from_numpy(images), torch.from_numpy(labels), g)
        totals.append(float(losses["total_loss"]))
        assert int(cm.sum()) == labels.size
    assert all(np.isfinite(totals)) and min(totals[1:]) < totals[0]
    with pytest.raises(ValueError):
        make_seg_train_step(3, grad_accum=3)(state, images, labels, g)  # 4 rows in 3
    assert make_seg_train_step(3, remat="full").remat == "full"  # ported
    with pytest.raises(ValueError):
        make_seg_train_step(3, remat="some")


def test_paired_shear_at_kolektorsdd_aspect():
    """The paired geometry at KolektorSDD's aspect (H = 2W) with multi-class
    uint8 labels, in each rotation mode (jitter off, as
    tests/test_torch_augment.py holds the geometry): images [atol 1e-5],
    labels exact and still uint8 (nearest sampling)."""
    images, labels = seg_batch(5, n=3, h=48, w=24, num_classes=3)
    for mode in ("per_batch_shear", "per_sample", "per_sample_shear"):
        cfg = AugmentConfig(degrees=5.0, brightness=0.0, contrast=0.0, saturation=0.0,
                            hue=0.0, rotation_mode=mode)
        key = jax.random.key(11)
        ref_img, ref_lbl = jax.jit(functools.partial(jax_train_transform, **cfg.kwargs()))(
            jnp.asarray(images), jnp.asarray(labels)[..., None], key)
        img, lbl = train_transform(torch.from_numpy(images), torch.from_numpy(labels)[..., None],
                                   jax_draws(key, len(images), cfg), **cfg.transform_kwargs())
        assert lbl.dtype == torch.uint8
        np.testing.assert_array_equal(lbl.numpy(), np.asarray(ref_lbl), err_msg=mode)
        np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=0, atol=1e-5,
                                   err_msg=mode)
        assert set(np.unique(lbl.numpy())) <= {0, 1, 2}


def _confusion(preds, labels, c):
    return np.bincount(labels.ravel() * c + preds.ravel(), minlength=c * c).reshape(c, c)


def test_eval_step_matches_jax_with_padded_rows():
    """Losses over the valid rows [rtol 1e-5], predictions [exact]; the
    port's matrix counts the valid rows only, as the JAX validation's host
    update does."""
    c = 3
    images, labels = seg_batch(6, num_classes=c)
    valid = np.asarray([1, 1, 1, 0], np.float32)
    jstate = _jax_state(c)
    jl, jp, _ = jax_eval_step(c, KSDD_LOSS)(jstate, jnp.asarray(images), jnp.asarray(labels),
                                            jnp.asarray(valid))
    state = _port_state(jstate, c)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    tl, tp, tcm = make_seg_eval_step(c, KSDD_LOSS)(state, images, labels, valid)
    assert state.model.training  # the mode is restored
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tcm.numpy(), _confusion(tp.numpy()[:3], labels[:3], c))
    three = make_seg_eval_step(c, KSDD_LOSS)(state, images[:3], labels[:3])
    np.testing.assert_allclose(float(tl["total_loss"]), float(three[0]["total_loss"]),
                               rtol=1e-6)
