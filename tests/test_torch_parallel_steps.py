"""The port's anomaly train and eval steps over 2 data-parallel ranks (gloo,
CPU) against the JAX package's steps on a 2-device 'data' mesh, at
base_features=4, 32 px, a global batch of 8.

Both sides start from the same seeded weights and see the same global batch
and draws (``_torch_parity.jax_draws`` of the JAX step's key). Each rank
takes its rows of the batch and of the draws (microbatch-major under
``grad_accum``), its BatchNorms normalize by the global batch's statistics,
its losses divide by global denominators and the gradients are averaged
over the ranks. One 2-rank launch runs every case (``_torch_dp_workers``);
the tests read its results.

Tolerances: f32 reorder noise. Losses 1e-5 relative; SGD parameters 1e-6
absolute and BN statistics 1e-5 relative, as the one-device parity tests
hold them (tests/test_torch_train_steps.py); Adam's first update is about
lr * g / (|g| + 1e-8), whose sensitivity to the gradient g grows as
1e-8 / (|g| + 1e-8)^2, so its parameters are held at 1e-6 absolute where
|g| > 1e-5 (read from the JAX step's first moment, (1 - 0.9) g) and
within 2 lr elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_workers as workers
import tpu_unet.models as jmodels
from _torch_parity import jax_accum_draws, jax_draws, one_torch_thread, u8_batch  # noqa: F401
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet.parallel import replicate as jax_replicate
from tpu_unet.parallel import shard_batch as jax_shard_batch
from tpu_unet.train import make_anomaly_eval_step as jax_eval_step
from tpu_unet.train import make_anomaly_train_step as jax_train_step
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.train.steps import AnomalyLossConfig, AugmentConfig
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

BASE, LR, WD, N = 4, 0.05, 1e-4, 8
AUG = AugmentConfig()
LOSS = AnomalyLossConfig()
CASES = [("sgd", 1), ("sgd", 2), ("adam", 1), ("adam", 2)]


def _seeded_sd():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return build_model("anomaly_unet", base_features=BASE).state_dict()


def _jax_state(sd, opt):
    params, stats = jax_trees_from_state_dict(sd)
    return JaxTrainState.create(apply_fn=jmodels.AnomalyUNet(base_features=BASE).apply,
                                params=params, batch_stats=stats,
                                tx=jax_optimizer(opt, LR, WD))


def _pairs(a, b, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in sorted(a):
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(a[k]), np.asarray(b[k])


@pytest.fixture(scope="module")
def runs():
    """Every case in both packages: the port on 2 ranks, JAX on a 2-device mesh."""
    sd = _seeded_sd()
    img, mask = u8_batch(11, n=N)
    mesh = jax_make_mesh(n_data=2)
    jax_out, port_cases = [], []
    for i, (opt, ga) in enumerate(CASES):
        key = jax.random.key(20 + i)
        jstate = jax_replicate(mesh, _jax_state(sd, opt))
        b = jax_shard_batch(mesh, {"image": img, "mask": mask})
        new, losses = jax_train_step(LOSS, AUG, donate_state=False, grad_accum=ga)(
            jstate, b["image"], b["mask"], key)
        jax_out.append({"losses": {k: float(v) for k, v in losses.items()},
                        "params": jax.device_get(new.params),
                        "grad": (jax.device_get(new.opt_state.inner_state[1].mu)
                                 if opt == "adam" else None),
                        "stats": jax.device_get(new.batch_stats)})
        draws = (jax_draws(key, N, AUG) if ga == 1 else jax_accum_draws(key, N, AUG, ga))
        port_cases.append((opt, ga, draws))
    # A padded eval batch: 5 valid rows of 8, so rank 1 holds one real row.
    valid = np.arange(N) < 5
    ev_img, ev_mask = u8_batch(12, n=N)
    ev_img[~valid], ev_mask[~valid] = 0, 0
    jstate = jax_replicate(mesh, _jax_state(sd, "sgd"))
    b = jax_shard_batch(mesh, {"image": ev_img, "mask": ev_mask, "valid": valid})
    jev = jax.device_get(jax_eval_step(LOSS)(jstate, b["image"], b["mask"], b["valid"]))

    devices = ["cpu", "cpu"]
    port = launch(workers.anomaly_steps, (sd, BASE, port_cases, img, mask, LOSS, AUG, LR, WD),
                  devices=devices)
    port_eval = launch(workers.anomaly_eval, (sd, BASE, ev_img, ev_mask, valid, LOSS),
                       devices=devices)
    return {"jax": jax_out, "port": port, "jax_eval": jev, "port_eval": port_eval,
            "valid": valid}


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{o}-accum{g}" for o, g in CASES])
def test_losses_match_the_jax_mesh(runs, case):
    j, t = runs["jax"][case], runs["port"][case]
    assert set(t["losses"]) == set(j["losses"]) == {"total_loss", "recon_loss", "seg_loss"}
    for k, v in t["losses"].items():
        np.testing.assert_allclose(v, j["losses"][k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{o}-accum{g}" for o, g in CASES])
def test_parameters_match_the_jax_mesh(runs, case):
    j, t = runs["jax"][case], runs["port"][case]
    opt = CASES[case][0]
    params, _ = jax_trees_from_state_dict({k: torch.from_numpy(v)
                                           for k, v in t["state"].items()})
    grads = dict((path, g / 0.1) for path, _, g in _pairs(j["grad"], j["grad"])) \
        if opt == "adam" else {}
    n = held = total = 0
    for path, p, ref in _pairs(params, j["params"]):
        firm = np.abs(grads[path]) > 1e-5 if opt == "adam" else np.ones(p.shape, bool)
        np.testing.assert_allclose(p[firm], ref[firm], rtol=0, atol=1e-6,
                                   err_msg=f"{opt} {path}")
        assert np.abs(p - ref).max() <= 2 * LR, path
        n, held, total = n + 1, held + firm.sum(), total + firm.size
    assert n == 98 and held > 0.5 * total
    assert t["ranks_equal"]


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"{o}-accum{g}" for o, g in CASES])
def test_bn_statistics_match_the_jax_mesh(runs, case):
    """The running statistics move by the global batch's (each microbatch's,
    under grad_accum) mean and biased variance, on every rank."""
    j, t = runs["jax"][case], runs["port"][case]
    _, stats = jax_trees_from_state_dict({k: torch.from_numpy(v)
                                          for k, v in t["state"].items()})
    atol = 1e-7 if CASES[case][1] == 1 else 1e-6  # a second microbatch carries the first's noise
    for path, v, ref in _pairs(stats, j["stats"]):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=atol, err_msg=path)
    assert t["bn_steps"] == CASES[case][1]


def test_eval_step_on_a_padded_batch_matches_the_jax_mesh(runs):
    """Loss scalars over the 5 valid rows of both ranks (rank 1 holds one),
    the same on every rank; per-row outputs gathered in batch order."""
    j, t, valid = runs["jax_eval"], runs["port_eval"], runs["valid"]
    for k, v in t["losses"].items():
        np.testing.assert_allclose(v, float(j["losses"][k]), rtol=1e-5, err_msg=k)
    for k in ("score", "error_map", "anomaly_map", "reconstruction", "image"):
        np.testing.assert_allclose(t[k][valid], np.asarray(j[k])[valid], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
