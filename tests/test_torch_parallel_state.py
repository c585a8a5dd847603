"""The port's data-parallel state over 2 ranks (gloo, CPU): sync BatchNorm's
gradient, FSDP against plain data parallelism, a checkpoint written by the
2-rank run and loaded at world size 1, and the SIGTERM latch agreed across
ranks. AnomalyUNet at base_features=4, 32 px, a global batch of 8; one
2-rank launch (``_torch_dp_workers.state_checks``)."""

import numpy as np
import pytest
import torch

import _torch_dp_workers as workers
from _torch_parity import one_torch_thread, u8_batch  # noqa: F401
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.augment import sample_augment_draws
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.train.checkpoint import load_checkpoint
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (AnomalyLossConfig, AugmentConfig,
                                        make_anomaly_train_step)

BASE, LR, WD, N = 4, 1e-3, 1e-4, 8
AUG = AugmentConfig()
# The gradient comparison runs without rotation: the rotation's constant fill
# makes max-pool windows of tied values, whose gradient goes to whichever
# element float32 rounding makes largest, so any reordering of a sum moves
# it (the JAX-mesh tests hold the rotation through losses and parameters).
GRAD_AUG = AugmentConfig(degrees=0.0)
LOSS = AnomalyLossConfig()


def _seeded_sd():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return build_model("anomaly_unet", base_features=BASE).state_dict()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sd = _seeded_sd()
    img, mask = u8_batch(21, n=N)
    g = torch.Generator().manual_seed(5)
    draws = sample_augment_draws(N, GRAD_AUG, g)
    per_step = [sample_augment_draws(N, AUG, g) for _ in range(3)]
    ckpt_dir = str(tmp_path_factory.mktemp("dp_ckpt"))
    out = launch(workers.state_checks,
                 (sd, BASE, img, mask, draws, per_step, LOSS, GRAD_AUG, AUG, LR, WD,
                  ckpt_dir),
                 devices=["cpu", "cpu"])
    return {**out, "sd": sd, "img": img, "mask": mask, "draws": draws}


def test_sync_bn_gradient_is_the_whole_batch_gradient(runs):
    """The 2-rank gradient (sync BN's all-reduce differentiated, the losses
    over global denominators, the gradients averaged) equals one process's
    on the concatenated batch with the same BatchNorm arithmetic, flax's
    E[x^2] - E[x]^2 [atol 1e-4 of each leaf's largest], and the plain
    one-process step's, whose BatchNorm takes the variance in another form
    [atol 2e-3 of each leaf's largest: the E[x^2] - E[x]^2 form, flax's too,
    loses float32 digits in proportion to |mean| / std, and its backward
    with them]."""
    model = build_model("anomaly_unet", base_features=BASE)
    model.load_state_dict(runs["sd"])
    state = create_train_state(model, "sgd", 0.0, 0.0, device="cpu")
    make_anomaly_train_step(LOSS, GRAD_AUG).with_draws(state, runs["img"], runs["mask"],
                                                       runs["draws"])
    n = 0
    for name, p in state.model.named_parameters():
        got, one, plain = runs["grads"]["ranks"][name], runs["grads"]["one"][name], p.grad.numpy()
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-4 * np.abs(one).max(),
                                   err_msg=name)
        np.testing.assert_allclose(got, plain, rtol=0, atol=2e-3 * np.abs(plain).max(),
                                   err_msg=name)
        n += 1
    assert n == 98


def test_fsdp_matches_plain_data_parallelism_after_three_adam_steps(runs):
    """The same losses and state [atol 1e-6]: the update is the same math on
    shards; FSDP holds its share of the state per rank."""
    dp, fs = runs["fsdp"]["dp"], runs["fsdp"]["fsdp"]
    np.testing.assert_allclose(fs["losses"], dp["losses"], rtol=1e-6)
    for k, v in dp["state"].items():
        np.testing.assert_allclose(fs["state"][k], v, rtol=0, atol=1e-6, err_msg=k)
    for k, v in dp["exp_avg"].items():
        np.testing.assert_allclose(fs["exp_avg"][k], v, rtol=0, atol=1e-7, err_msg=k)
    assert dp["sharded_fraction"] == 0.0 and fs["sharded_fraction"] > 0.99
    # Each rank holds about half the state; the JAX placement keeps the small
    # leaves whole, which FSDP2 shards on dim 0 (parallel/fsdp.py).
    assert 0.45 * dp["bytes"] < fs["bytes"] < 0.55 * dp["bytes"]
    assert fs["bytes"] <= fs["jax_bytes"] < dp["bytes"]


def test_a_two_rank_checkpoint_loads_at_world_size_one(runs):
    """Every rank joined the FSDP gather and rank 0 wrote the whole tensors:
    the file loads strict at world size 1 with the epoch and Adam step."""
    fs = runs["fsdp"]
    model = build_model("anomaly_unet", base_features=BASE)
    state = create_train_state(model, "adam", LR, WD, device="cpu")
    state, epoch, _ = load_checkpoint(state, fs["ckpt"])
    assert epoch == 7 and fs["opt_steps"] == 3
    assert int(next(iter(state.optimizer.state.values()))["step"]) == 3
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), fs["fsdp"]["state"][k], err_msg=k)


def test_sigterm_on_one_rank_stops_every_rank_at_the_same_epoch(runs):
    parts = runs["interrupt"]
    assert [p["last"] for p in parts] == [1, 1]
    assert [p["triggered"] for p in parts] == [False, True]
    assert all(p["step_poll"] is None for p in parts)
