"""The port's anomaly train and eval steps (tpu_unet_torch/train/) against the
JAX package's, on the CPU, at base_features=4, 32 px, batch 4.

Both packages start from the same seeded weights and see the same
augmentation draws (``_torch_parity.jax_draws`` rebuilds the key's draws).
The JAX gradients come from ``jax.grad`` of the loss that
``tpu_unet/train/steps.py`` builds (train_transform, apply_fn in train mode,
combined_anomaly_loss), and the whole-step comparison runs SGD: Adam's first
step is a sign function that turns gradient noise near 0 into +-2 lr.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.models as jmodels
from _torch_parity import jax_accum_draws, jax_draws, u8_batch
from tpu_unet.core.precision import BF16_POLICY as JAX_BF16
from tpu_unet.losses.anomaly import combined_anomaly_loss as jax_loss
from tpu_unet.ops.augment import train_transform as jax_train_transform
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet.train import make_anomaly_eval_step as jax_eval_step
from tpu_unet.train import make_anomaly_train_step as jax_train_step
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models.unet import AnomalyUNet
from tpu_unet_torch.ops.augment import AugmentDraws
from tpu_unet_torch.train.state import create_train_state, num_params
from tpu_unet_torch.train.steps import (AnomalyLossConfig, AugmentConfig,
                                        make_anomaly_eval_step, make_anomaly_train_step)
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict, state_dict_from_jax

BASE = 4
LR = 0.05
AUG = AugmentConfig()  # the flagship's: one shear rotation per batch
LOSS = AnomalyLossConfig()


@functools.lru_cache(maxsize=None)
def _jax_variables(name):
    """Seeded initial variables in the JAX layout: the port model's init
    carried over by the inverse weight map (a flax init costs 12-30 s of
    compilation on the CPU)."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        sd = build_model(name, base_features=BASE).state_dict()
    params, stats = jax_trees_from_state_dict(sd, model=name)
    return {"params": params, "batch_stats": stats}


def _jax_model(name, policy=None):
    kw = {} if policy is None else {"policy": policy}
    return (jmodels.AnomalyUNet(base_features=BASE, **kw) if name == "anomaly_unet"
            else jmodels.UNet(n_classes=1, base_features=BASE, **kw))


def _jax_state(name="anomaly_unet", opt="sgd", policy=None):
    """The JAX package's TrainState over the seeded variables."""
    v = _jax_variables(name)
    return JaxTrainState.create(apply_fn=_jax_model(name, policy).apply, params=v["params"],
                                batch_stats=v["batch_stats"], tx=jax_optimizer(opt, LR, 1e-4))


def _port_state(jstate, name="anomaly_unet", opt="sgd", precision="f32"):
    model = build_model(name, base_features=BASE, policy=get_policy(precision))
    params, stats = jax.device_get((jstate.params, jstate.batch_stats))
    model.load_state_dict(state_dict_from_jax(params, stats, model=name))
    return create_train_state(model, opt, LR, 1e-4, device="cpu")


def _pairs(a, b, path=""):
    """(path, a_leaf, b_leaf) over two nested dicts with the same keys."""
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in sorted(a):
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(a[k]), np.asarray(b[k])


def _jax_loss_fn(jstate, img, msk, dual_decoder=True):
    """The loss of tpu_unet/train/steps.py's step, as a function of params."""
    def loss_fn(params):
        out, mut = jstate.apply_fn({"params": params, "batch_stats": jstate.batch_stats},
                                   img, train=True, mutable=["batch_stats"])
        if dual_decoder:
            recon, amap = out
        else:
            recon, amap = img, jax.nn.sigmoid(out)
        losses = jax_loss(recon, amap, img, msk, **LOSS.kwargs())
        return losses["total_loss"], (losses, mut["batch_stats"])
    return loss_fn


@pytest.fixture(scope="module")
def one_step():
    """One f32 step of AnomalyUNet in both packages, from the same weights and draws."""
    img, mask = u8_batch(0)
    key = jax.random.key(3)
    jstate = _jax_state()
    jimg, jmsk = jax.jit(functools.partial(jax_train_transform, **AUG.kwargs()))(
        jnp.asarray(img), jnp.asarray(mask), key)
    grads, (jlosses, jstats) = jax.jit(jax.grad(
        _jax_loss_fn(jstate, jimg, jmsk.astype(jnp.float32)), has_aux=True))(jstate.params)
    new_jstate, step_losses = jax_train_step(LOSS, AUG, donate_state=False)(
        jstate, jnp.asarray(img), jnp.asarray(mask), key)

    state = _port_state(jstate)
    losses = make_anomaly_train_step(LOSS, AUG).with_draws(
        state, img, mask, jax_draws(key, len(img), AUG))
    tgrads, _ = jax_trees_from_state_dict(
        {n: p.grad for n, p in state.model.named_parameters()})
    tparams, tstats = jax_trees_from_state_dict(state.model.state_dict())
    return dict(jax=dict(grads=jax.device_get(grads), losses=jlosses, stats=jstats,
                         step_losses=step_losses, params=jax.device_get(new_jstate.params),
                         new_stats=jax.device_get(new_jstate.batch_stats)),
                port=dict(grads=tgrads, losses=losses, params=tparams, stats=tstats,
                          state=state))


def test_losses_match_jax(one_step):
    j, t = one_step["jax"], one_step["port"]
    assert set(t["losses"]) == {"total_loss", "recon_loss", "seg_loss"}
    for k, v in t["losses"].items():
        np.testing.assert_allclose(float(v), float(j["losses"][k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(v), float(j["step_losses"][k]), rtol=1e-5, err_msg=k)


def test_every_gradient_leaf_matches_jax(one_step):
    j, t = one_step["jax"], one_step["port"]
    n = 0
    for path, g, ref in _pairs(t["grads"], j["grads"]):
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=path)
        n += 1
    assert n == len(list(one_step["port"]["state"].model.parameters())) == 98


def test_bn_running_stats_match_flax(one_step):
    """Biased batch variance and momentum 0.1, as flax."""
    j, t = one_step["jax"], one_step["port"]
    for path, v, ref in _pairs(t["stats"], j["new_stats"]):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-7, err_msg=path)
    assert one_step["port"]["state"].model.inc.double_conv[1].num_batches_tracked == 1


def test_sgd_step_parameters_match_jax(one_step):
    j, t = one_step["jax"], one_step["port"]
    for path, p, ref in _pairs(t["params"], j["params"]):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
    assert one_step["port"]["state"].step == 1


def test_plain_unet_without_dual_decoder():
    """dual_decoder=False: UNet's sigmoid(logits) is the map, the input the
    reconstruction (recon loss 0)."""
    img, mask = u8_batch(1)
    key = jax.random.key(4)
    jstate = _jax_state("unet")
    new_j, jl = jax_train_step(LOSS, AUG, donate_state=False, dual_decoder=False)(
        jstate, jnp.asarray(img), jnp.asarray(mask), key)
    state = _port_state(jstate, "unet")
    tl = make_anomaly_train_step(LOSS, AUG, dual_decoder=False).with_draws(
        state, img, mask, jax_draws(key, len(img), AUG))
    assert float(tl["recon_loss"]) == 0.0
    for k in tl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, atol=1e-8, err_msg=k)
    tparams, tstats = jax_trees_from_state_dict(state.model.state_dict(), model="unet")
    for path, p, ref in _pairs(tparams, jax.device_get(new_j.params)):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
    for path, v, ref in _pairs(tstats, jax.device_get(new_j.batch_stats)):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-7, err_msg=path)


def test_grad_accum_matches_jax_scan():
    """grad_accum=2: two microbatches with their own draws, BN statistics
    chained, the mean gradient, one SGD update, the mean losses."""
    img, mask = u8_batch(2)
    key = jax.random.key(5)
    jstate = _jax_state()
    new_j, jl = jax_train_step(LOSS, AUG, donate_state=False, grad_accum=2)(
        jstate, jnp.asarray(img), jnp.asarray(mask), key)
    state = _port_state(jstate)
    tl = make_anomaly_train_step(LOSS, AUG, grad_accum=2).with_draws(
        state, img, mask, jax_accum_draws(key, len(img), AUG, 2))
    for k in tl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    tparams, tstats = jax_trees_from_state_dict(state.model.state_dict())
    for path, p, ref in _pairs(tparams, jax.device_get(new_j.params)):
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-6, err_msg=path)
    # atol 1e-6: the second microbatch's statistics carry the first's noise.
    for path, v, ref in _pairs(tstats, jax.device_get(new_j.batch_stats)):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-6, err_msg=path)
    assert state.model.inc.double_conv[1].num_batches_tracked == 2
    with pytest.raises(ValueError):  # 3 rows do not split in 2
        make_anomaly_train_step(LOSS, AUG, grad_accum=2)(
            state, img[:3], mask[:3], torch.Generator().manual_seed(0))


def test_bf16_policy_loss_tracks_jax():
    """bf16 convolutions in both packages: the losses agree within 2e-2 (bf16
    rounding, ties in max-pool and clip gradients)."""
    img, mask = u8_batch(3)
    key = jax.random.key(6)
    jstate = _jax_state(opt="adam", policy=JAX_BF16)
    _, jl = jax_train_step(LOSS, AUG, donate_state=False)(
        jstate, jnp.asarray(img), jnp.asarray(mask), key)
    state = _port_state(jstate, opt="adam", precision="bf16")
    tl = make_anomaly_train_step(LOSS, AUG).with_draws(
        state, img, mask, jax_draws(key, len(img), AUG))
    for k in tl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=2e-2, err_msg=k)


def test_adam_steps_reduce_the_loss_with_generator_draws():
    """The generator entry point: drawn augmentation, Adam, loss falls."""
    img, mask = u8_batch(4, mask_dtype=np.uint8)
    state = _port_state(_jax_state(opt="adam"), opt="adam")
    step = make_anomaly_train_step(LOSS, AUG)
    g = torch.Generator().manual_seed(0)
    totals = [float(step(state, img, mask, g)["total_loss"]) for _ in range(6)]
    assert all(np.isfinite(totals)) and min(totals[1:]) < totals[0]
    assert state.step == 6 and num_params(state) == num_params(state.model) > 0


def test_eval_step_matches_jax_with_padded_rows(one_step):
    img, mask = u8_batch(5)
    valid = np.asarray([1, 1, 1, 0], np.float32)
    jstate = _jax_state()
    out_j = jax_eval_step(LOSS)(jstate, jnp.asarray(img), jnp.asarray(mask),
                                jnp.asarray(valid))
    state = _port_state(jstate)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    out = make_anomaly_eval_step(LOSS)(state, img, mask, valid)
    assert state.model.training  # the mode is restored
    for k, v in state.model.state_dict().items():  # eval touches no statistic
        assert torch.equal(v, before[k]), k
    for k in out["losses"]:
        np.testing.assert_allclose(float(out["losses"][k]), float(out_j["losses"][k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("score", "error_map", "anomaly_map", "reconstruction", "image"):
        assert tuple(out[k].shape) == tuple(out_j[k].shape), k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(out_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # The padded row is out of the loss: the same loss as the 3 valid rows alone.
    three = make_anomaly_eval_step(LOSS)(state, img[:3], mask[:3])
    np.testing.assert_allclose(float(out["losses"]["total_loss"]),
                               float(three["losses"]["total_loss"]), rtol=1e-6)


@pytest.mark.parametrize("remat", ["full", "full_res"])
def test_remat_is_not_ported(remat):
    """remat is ported: a step with it gives the plain step's losses and BN
    statistics exactly (tests/test_torch_remat.py holds it in full); other
    modes and grad_accum < 1 raise."""
    img, mask = u8_batch(7)
    draws = jax_draws(jax.random.key(7), len(img), AUG)
    out = []
    for mode in ("none", remat):
        with torch.random.fork_rng():
            torch.manual_seed(0)
            model = AnomalyUNet(base_features=BASE, remat_full_res=True)
        state = create_train_state(model, "sgd", LR, 1e-4, device="cpu")
        losses = make_anomaly_train_step(LOSS, AUG, remat=mode).with_draws(state, img, mask,
                                                                           draws)
        out.append((losses, state.model.state_dict()))
    (plain, sd_plain), (rem, sd_rem) = out
    assert {k: float(v) for k, v in rem.items()} == {k: float(v) for k, v in plain.items()}
    for k, v in sd_plain.items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(sd_rem[k], v), k
    with pytest.raises(ValueError):
        make_anomaly_train_step(remat="some")
    with pytest.raises(ValueError):
        make_anomaly_train_step(grad_accum=0)


def test_train_state_defaults_to_cuda():
    """Nothing falls back to the CPU: without a GPU the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(build_model("anomaly_unet", base_features=BASE))


def test_draws_move_with_the_batch():
    d = AugmentDraws(flip=torch.zeros(2, dtype=torch.bool), angle=torch.zeros(()),
                     fb=torch.ones(2, 1, 1, 1), fc=torch.ones(2, 1, 1, 1),
                     fs=torch.ones(2, 1, 1, 1), fh=torch.zeros(2, 1, 1), perm=5)
    moved = d.to("cpu")
    assert moved.perm == 5 and torch.equal(moved.fb, d.fb)
    with pytest.raises(ValueError):  # two draw sets for grad_accum=1
        make_anomaly_train_step().with_draws(
            _port_state(_jax_state()), *u8_batch(0, n=2), [d, d])
