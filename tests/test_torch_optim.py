"""The port's optimizers and schedules (tpu_unet_torch/train/optim.py)
against the JAX package's optax chains and LRScheduler, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.train.optim as jo
import tpu_unet_torch.train.optim as to


def _leaves(seed=0):
    """A conv kernel, a bias and a BN scale: weight decay reaches them all."""
    rng = np.random.default_rng(seed)
    return {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
            "bias": rng.normal(size=(8,)).astype(np.float32),
            "scale": (1 + 0.1 * rng.normal(size=(8,))).astype(np.float32)}


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax_over_three_steps(name):
    lr, wd = 1e-2, 1e-2  # large enough that the decay term shows
    params = _leaves()
    rng = np.random.default_rng(1)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]

    tx = jo.make_optimizer(name, lr, wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = to.make_optimizer(tp.values(), name, lr, wd)
    for g in grads:
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    # atol: two float32 ulps at |p| = 2. The updates differ by ulps of the
    # parameters: optax computes Adam's bias corrections in float32
    # (1 - 0.999 = 0.0009999871), torch in float64.
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=5e-7, err_msg=k)
        assert not np.allclose(tp[k].detach().numpy(), params[k])


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        to.make_optimizer([torch.nn.Parameter(torch.zeros(2))], "lamb")


def test_set_and_get_learning_rate():
    p = torch.nn.Parameter(torch.ones(3))
    opt = to.make_optimizer([p], "sgd", 0.1, 0.0)
    assert to.get_learning_rate(opt) == pytest.approx(0.1)
    to.set_learning_rate(opt, 0.05)
    assert to.get_learning_rate(opt) == pytest.approx(0.05)
    p.grad = torch.ones(3)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 0.95, rtol=1e-6)  # the new rate was used


@pytest.mark.parametrize("rule", ["cosine", "step", "plateau", "none"])
def test_lr_scheduler_matches_jax(rule):
    ours = to.LRScheduler(rule, base_lr=1e-3, num_epochs=30, plateau_patience=3)
    ref = jo.LRScheduler(rule, base_lr=1e-3, num_epochs=30, plateau_patience=3)
    # Validation losses: falling, then a plateau with drifts inside the 1e-4
    # relative threshold, then falling again.
    losses = [1.0 / (e + 1) for e in range(10)] + [0.1 * (1 - 1e-5 * e) for e in range(12)] \
        + [0.05 / (e + 1) for e in range(8)]
    seen = []
    for epoch, loss in enumerate(losses):
        assert ours.lr_for_epoch(epoch) == ref.lr_for_epoch(epoch), epoch
        if rule == "plateau":
            assert ours.step_plateau(loss) == ref.step_plateau(loss), epoch
        seen.append(ours.lr_for_epoch(epoch))
    if rule != "none":
        assert len(set(seen)) > 1  # the rule moved the rate
