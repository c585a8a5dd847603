"""The port's tensor parallelism (tpu_unet_torch/parallel/tensor.py) on gloo
CPU ranks against the JAX package's on its 8-virtual-CPU mesh
(tests/conftest.py), following tests/test_tensor_parallel.py.

Placement: every leaf's sharded torch dim is the JAX package's
``tp_leaf_spec`` on the JAX tree, read through ``jax_trees_from_state_dict``
(the layouts' transposes), for the four model families at base 8 on a
2-wide 'model' axis, the attention gate included; the transposed convs and
heads; Adam's moments; indivisible widths at 8 model ranks; a mesh without
'model' refused.

Numerics (AnomalyUNet base 4, 32 px, a global batch of 8, the default
augment): one f32 SGD step and one Adam step of the port on a (2, 1, 2)
('data', 'space', 'model') mesh of four ranks against the JAX step on the
same mesh, same weights (``jax_trees_from_state_dict``) and draws
(``_torch_parity.jax_draws``), at the data-parallel tests' tolerances
(tests/test_torch_parallel_steps.py: losses 1e-5 relative, SGD parameters
1e-6 absolute, BN statistics 1e-5 relative, Adam's parameters 1e-6 where
the gradient is above 1e-5 and within 2 lr elsewhere); TP+FSDP against TP
alone over three SGD steps (1e-6, as the JAX test holds them at its
reorder tolerance); the replicated leaves bit for bit equal on every rank
after three steps; the eval step on a tensor-parallel state against the
JAX eval step on the sharded state (losses 1e-5 relative, scores and maps
1e-5 absolute).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_tp_workers as workers
import tpu_unet.models as jmodels
from _torch_parity import jax_draws, one_torch_thread, u8_batch  # noqa: F401
from tpu_unet.parallel import make_mesh as jax_make_mesh
from tpu_unet.parallel import shard_batch as jax_shard_batch
from tpu_unet.parallel import shard_state as jax_shard_state
from tpu_unet.parallel.tensor import tp_leaf_spec as jax_tp_leaf_spec
from tpu_unet.parallel.tensor import tp_state_sharding
from tpu_unet.train import make_anomaly_eval_step as jax_eval_step
from tpu_unet.train import make_anomaly_train_step as jax_train_step
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.parallel.tensor import shard_state, tp_dims
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import AnomalyLossConfig, AugmentConfig
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

BASE, LR, WD, N = 4, 0.05, 1e-4, 8
AUG = AugmentConfig()
LOSS = AnomalyLossConfig()
FOUR = ["cpu"] * 4  # a (2, 1, 2) mesh
FAMILIES = {"anomaly_unet": {}, "seg_unet": {"n_classes": 4}, "attn_unet": {"n_classes": 4},
            "unetpp": {"n_classes": 4, "deep_supervision": True}}


def _seeded(name, base=BASE, **kw):
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return build_model(name, base_features=base, **kw).state_dict()


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


def _tree(state, model="anomaly_unet"):
    return jax_trees_from_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                                     model=model)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _jax_local_shapes(sd, name, n):
    """Each JAX leaf's shape on one device under the JAX rule."""
    params, stats = jax_trees_from_state_dict(sd, model=name)
    out = {}
    for tree in (params, stats):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            spec = jax_tp_leaf_spec(path, leaf.shape, n)
            shape = list(leaf.shape)
            for a, axis in enumerate(tuple(spec)):
                if axis is not None:
                    shape[a] //= n
            out[jax.tree_util.keystr(path)] = (tuple(shape), spec != P())
    return out


def _port_local_shapes(shapes, name):
    """The port's local state_dict shapes in the JAX layout."""
    zeros = {k: torch.zeros(s) for k, s in shapes.items()}
    params, stats = jax_trees_from_state_dict(zeros, model=name)
    return {jax.tree_util.keystr(p): leaf.shape
            for tree in (params, stats)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def placed():
    models = [(name, _seeded(name, 8, **kw), {"base_features": 8, **kw})
              for name, kw in FAMILIES.items()]
    return models, launch(workers.placement, (models, 2), devices=["cpu", "cpu"])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_every_leaf_is_sharded_as_the_jax_rule_says(placed, name):
    models, shapes = placed
    sd = next(m[1] for m in models if m[0] == name)
    want = _jax_local_shapes(sd, name, 2)
    got = _port_local_shapes(shapes[name], name)
    assert set(got) == set(want)
    for path, (shape, _) in want.items():
        assert got[path] == shape, path
    sharded = sum(s for _, s in want.values())
    assert sharded > 0.3 * len(want)
    if name == "attn_unet":  # the gate: W_g, W_x column, psi row, bn2 whole
        gate = "['decoder']['up1']['att']"
        for leaf, is_sharded in (("['g']['conv1']['kernel']", True),
                                 ("['x']['conv1']['kernel']", True),
                                 ("['g']['bn1']['scale']", True),
                                 ("['conv2']['kernel']", True), ("['bn2']['scale']", False)):
            assert want[gate + leaf][1] == is_sharded, leaf


def test_double_conv_column_row_pattern(placed):
    """conv1 on C_out (OIHW dim 0), conv2 on C_in (dim 1), bn1 and its
    statistics per slice, bn2 whole."""
    shapes = placed[1]["anomaly_unet"]
    assert shapes["inc.double_conv.0.weight"] == (4, 3, 3, 3)
    assert shapes["inc.double_conv.3.weight"] == (8, 4, 3, 3)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        assert shapes[f"inc.double_conv.1.{leaf}"] == (4,)
        assert shapes[f"inc.double_conv.4.{leaf}"] == (8,)


def test_transposed_convs_and_heads(placed):
    """A ConvTranspose2d kernel (in, out, kh, kw) on C_out (dim 1) with its
    bias; the 1x1 heads (C_out 3 and 1) whole."""
    shapes = placed[1]["anomaly_unet"]
    assert shapes["up1_seg.up.weight"] == (128, 32, 2, 2)
    assert shapes["up1_seg.up.bias"] == (32,)
    assert shapes["outc_seg.conv.weight"] == (1, 8, 1, 1)
    assert shapes["outc_recon.conv.weight"] == (3, 8, 1, 1)
    dims = placed[1]["unetpp"]
    assert dims["up0_1.weight"] == (16, 4, 2, 2) and dims["outc_1.conv.weight"] == (4, 8, 1, 1)


def test_indivisible_widths_stay_replicated():
    """base 4 over 8 model ranks: the 4-wide rows cannot shard, deeper ones
    can, as the JAX package decides; nothing raises."""
    model = build_model("anomaly_unet", base_features=4)
    dims = tp_dims(model, 8)
    assert "inc.double_conv.0.weight" not in dims
    assert dims["down3.maxpool_conv.1.double_conv.0.weight"] == 0
    want = _jax_local_shapes(model.state_dict(), "anomaly_unet", 8)
    params, _ = jax_trees_from_state_dict(model.state_dict())
    assert not want["['encoder']['inc']['conv1']['kernel']"][1]
    assert want["['encoder']['down3']['conv']['conv1']['kernel']"][1]
    n_sharded = sum(s for _, s in want.values())
    n_port = len([k for k in dims if not k.endswith("num_batches_tracked")])
    assert n_port == n_sharded


def test_a_mesh_without_model_raises(devices):
    with pytest.raises(ValueError, match="model"):
        tp_state_sharding(jax_make_mesh(n_data=8), _jax_state(_seeded("anomaly_unet"), "sgd"))
    model = build_model("anomaly_unet", base_features=4)
    with pytest.raises(ValueError, match="model"):
        shard_state(None, create_train_state(model, "sgd", 0.0, 0.0, device="cpu"))


# ---------------------------------------------------------------------------
# Numerics against the JAX package on a (2, 1, 2) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(devices):
    sd = _seeded("anomaly_unet")
    img, mask = u8_batch(11, n=N)
    mesh = jax_make_mesh(n_data=2, n_space=1, n_model=2)
    jax_out, draws = {}, {}
    for opt, seed in (("sgd", 20), ("adam", 21)):
        key = jax.random.key(seed)
        jstate = jax_shard_state(mesh, _jax_state(sd, opt), tp=True)
        b = jax_shard_batch(mesh, {"image": img, "mask": mask})
        new, losses = jax_train_step(LOSS, AUG, donate_state=False)(
            jstate, b["image"], b["mask"], key)
        jax_out[opt] = {"losses": {k: float(v) for k, v in losses.items()},
                        "params": jax.device_get(new.params),
                        "grad": (jax.device_get(new.opt_state.inner_state[1].mu)
                                 if opt == "adam" else None),
                        "stats": jax.device_get(new.batch_stats)}
        draws[opt] = jax_draws(key, N, AUG)
    three = [jax_draws(jax.random.key(30 + i), N, AUG) for i in range(3)]
    cases = [("sgd", False, [draws["sgd"]]), ("adam", False, [draws["adam"]]),
             ("sgd", False, three), ("sgd", True, three)]
    port = launch(workers.anomaly_cases, (sd, BASE, 2, cases, img, mask, LOSS, AUG, LR, WD),
                  devices=FOUR)

    valid = np.arange(N) < 5
    ev_img, ev_mask = u8_batch(12, n=N)
    ev_img[~valid], ev_mask[~valid] = 0, 0
    jstate = jax_shard_state(mesh, _jax_state(sd, "sgd"), tp=True)
    b = jax_shard_batch(mesh, {"image": ev_img, "mask": ev_mask, "valid": valid})
    jev = jax.device_get(jax_eval_step(LOSS)(jstate, b["image"], b["mask"], b["valid"]))
    port_eval = launch(workers.anomaly_eval, (sd, BASE, 2, ev_img, ev_mask, valid, LOSS),
                       devices=FOUR)
    return {"jax": jax_out, "port": port, "jax_eval": jev, "port_eval": port_eval,
            "valid": valid}


@pytest.mark.parametrize("case,opt", [(0, "sgd"), (1, "adam")])
def test_tp_step_matches_the_jax_tp_step(runs, case, opt):
    j, t = runs["jax"][opt], runs["port"][case]
    assert set(t["losses"][0]) == set(j["losses"]) == {"total_loss", "recon_loss", "seg_loss"}
    for k, v in t["losses"][0].items():
        np.testing.assert_allclose(v, j["losses"][k], rtol=1e-5, err_msg=k)
    params, stats = _tree(t["state"])
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
    for path, s, ref in _pairs(stats, j["stats"]):
        np.testing.assert_allclose(s, ref, rtol=1e-5, atol=1e-7, err_msg=path)


def test_adam_moments_are_sliced_as_their_parameters(runs):
    """The moments mirror the parameters: each sharded leaf's exp_avg holds
    the same slice, and gathered they are JAX's first moment."""
    t, j = runs["port"][1], runs["jax"]["adam"]
    params, moments = t["shapes"]
    assert moments and all(moments[n] == params[n] for n in moments)
    assert moments["inc.double_conv.0.weight"] == (2, 3, 3, 3)
    assert moments["inc.double_conv.3.weight"] == (4, 2, 3, 3)
    mu, _ = _tree({n: m["exp_avg"] for n, m in t["moments"].items()})
    for path, m, ref in _pairs(mu, j["grad"]):
        np.testing.assert_allclose(m, ref, rtol=1e-3, atol=1e-7, err_msg=path)


def test_replicated_leaves_stay_equal_across_the_ranks(runs):
    """After three steps every rank's replicated leaves are bit for bit the
    same, and every rank of a model index holds the same slices."""
    for case in runs["port"]:
        assert case["agree"]
    assert runs["port"][2]["sharded_fraction"] > 0.9


def test_tp_plus_fsdp_matches_tp_alone(runs):
    tp, both = runs["port"][2], runs["port"][3]
    np.testing.assert_allclose([l["total_loss"] for l in both["losses"]],
                               [l["total_loss"] for l in tp["losses"]], rtol=1e-5)
    for k, v in tp["state"].items():
        np.testing.assert_allclose(both["state"][k], v, rtol=0, atol=1e-6, err_msg=k)
    # FSDP shards the tensor-parallel slices over 'data' too (FSDP2 reduces
    # no replicated parameter): fewer bytes than the JAX placement's.
    assert both["bytes"] < tp["bytes"] and both["bytes"] <= both["jax_bytes"]
    assert tp["bytes"] == tp["jax_bytes"]


def test_eval_step_on_a_tp_state_matches_jax(runs):
    j, t, valid = runs["jax_eval"], runs["port_eval"], runs["valid"]
    for k, v in t["losses"].items():
        np.testing.assert_allclose(v, float(j["losses"][k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(t["score"][valid], np.asarray(j["score"])[valid], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t["anomaly_map"][valid], np.asarray(j["anomaly_map"])[valid],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["error_map"][valid], np.asarray(j["error_map"])[valid],
                               rtol=0, atol=1e-5)
