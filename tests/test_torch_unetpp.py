"""The port's UNet++ (tpu_unet_torch/models/unetpp.py) and its int8 plan
against the JAX package's, on the CPU at base_features=4: eval forward for
``heads`` 1-4 with deep supervision and without it, at odd sizes and with
bilinear level-ups, to 1e-3; the train-mode tuple of head logits and the
running statistics; a pruned head that calls no conv of a deeper column;
the parameter count; the weights carried JAX -> torch -> JAX; and the int8
plan op by op against JAX's ``_QuantExec`` (every int8 activation bit for
bit) with 30 K2 convs per batch, 6 at ``heads`` 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_int8_envs_equal, run_recording
from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_models import u8_images, warmed_variables
from tpu_unet.models.unetpp import UNetPlusPlus as JaxUNetPlusPlus
from tpu_unet.ops import quantize as jq
from tpu_unet.ops.augment import eval_transform as jax_eval_transform
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models.unetpp import UNetPlusPlus, grid_nodes
from tpu_unet_torch.ops import quantize as tq
from tpu_unet_torch.ops.augment import eval_transform
from tpu_unet_torch.ops.fold_bn import fold_batchnorm
from tpu_unet_torch.utils.weights import (jax_trees_from_state_dict, qparams_from_numpy,
                                          qparams_to_numpy, state_dict_from_jax)

BASE = 4
C = 3


def _jax(ds=False, heads=4, bilinear=False, dropout=0.0):
    return JaxUNetPlusPlus(n_classes=C, base_features=BASE, deep_supervision=ds, heads=heads,
                           bilinear=bilinear, dropout=dropout)


def _port(v, ds=False, heads=4, bilinear=False, dropout=0.0):
    model = build_model("unetpp", n_classes=C, base_features=BASE, deep_supervision=ds,
                        heads=heads, bilinear=bilinear, dropout=dropout)
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], "unetpp",
                                              bilinear=bilinear, deep_supervision=ds))
    return model.eval()


@pytest.fixture(scope="module")
def ds_variables():
    return warmed_variables(_jax(ds=True), key=3)


def test_param_count_at_the_class_default():
    assert sum(p.numel() for p in UNetPlusPlus().parameters()) == 9_045_924
    assert UNetPlusPlus().bottleneck_channels == 16 * 32


@pytest.mark.parametrize("heads", [1, 2, 3, 4])
def test_deep_supervision_eval_heads_match_jax(ds_variables, heads):
    """heads=4: the mean of the four head logits; k < 4: head X[0][k]. 1e-3."""
    x = np.array(jax_eval_transform(jnp.asarray(u8_images(1))))
    want = np.asarray(_jax(True, heads).apply(ds_variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port(ds_variables, True, heads)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-3)


@pytest.mark.parametrize("shape,bilinear", [((2, 32, 32, 3), False), ((2, 34, 30, 3), False),
                                            ((1, 32, 32, 3), True), ((1, 36, 20, 3), True)])
def test_eval_forward_matches_jax(shape, bilinear):
    """Without deep supervision (one head on X[0][4]), at odd sizes where the
    level-up is padded to the row, and with bilinear level-ups: 1e-3."""
    jax_model = _jax(bilinear=bilinear)
    v = warmed_variables(jax_model, key=5, shape=shape, steps=1)
    x = np.array(jax_eval_transform(jnp.asarray(u8_images(2, shape))))
    want = np.asarray(jax_model.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port(v, bilinear=bilinear)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-3)


def test_train_mode_returns_the_four_heads_and_flax_statistics(ds_variables):
    """Train mode with bottleneck dropout (the JAX key's mask read back): the
    four head logits in order to 1e-3, and the running statistics of every
    node's BNs after the pass to 1e-5 relative (1e-6 absolute for the means
    near zero, which carry float32 conv-order noise through 15 nodes)."""
    from _torch_parity import jax_dropout_keep

    jax_model = _jax(ds=True, dropout=0.3)
    x = np.array(jax.random.normal(jax.random.key(11), (2, 32, 32, 3)))
    k_drop = jax.random.key(12)
    heads, mut = jax_model.apply(ds_variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"], rngs={"dropout": k_drop})
    keep = jax_dropout_keep(jax_model.apply, ds_variables, x.shape, k_drop)
    assert keep.shape == (2, 16 * BASE) and 0 < int(keep.sum()) < keep.numel()
    model = _port(ds_variables, ds=True, dropout=0.3).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), keep=keep)
    assert isinstance(got, tuple) and len(got) == 4 and len(heads) == 4
    for g, w in zip(got, heads):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=1e-3)
    _, stats = jax_trees_from_state_dict(model.state_dict(), "unetpp")
    want = jax.device_get(mut["batch_stats"])
    for i, j in grid_nodes():
        for bn in ("bn1", "bn2"):
            for k in ("mean", "var"):
                np.testing.assert_allclose(stats[f"x{i}_{j}"][bn][k],
                                           np.asarray(want[f"x{i}_{j}"][bn][k]),
                                           rtol=1e-5, atol=1e-6, err_msg=f"x{i}_{j}/{bn}/{k}")
    with pytest.raises(ValueError, match="dropout draw"):
        model(torch.from_numpy(x).permute(0, 3, 1, 2))


@pytest.mark.parametrize("heads", [1, 2, 3, 4])
def test_pruned_head_runs_no_deeper_column(heads):
    """Forward hooks on every node: eval with heads=k calls X[i][j] for
    i + j <= k only (3, 6, 10, 15 nodes), each once; train mode calls all 15."""
    model = UNetPlusPlus(n_classes=C, base_features=BASE, deep_supervision=True,
                         heads=heads).eval()
    called = []
    for i, j in grid_nodes():
        getattr(model, f"x{i}_{j}").register_forward_hook(
            lambda *_, n=(i, j): called.append(n))
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(x)
    assert sorted(called) == sorted((i, j) for i, j in grid_nodes() if i + j <= heads)
    assert len(called) == {1: 3, 2: 6, 3: 10, 4: 15}[heads]
    called.clear()
    with torch.no_grad():
        model.train()(x)
    assert len(called) == 15


@pytest.mark.parametrize("ds,bilinear", [(False, False), (True, False), (False, True)])
def test_weights_round_trip_jax_torch_jax(ds, bilinear):
    v = warmed_variables(_jax(ds=ds, bilinear=bilinear), key=9, steps=1)
    sd = state_dict_from_jax(v["params"], v["batch_stats"], "unetpp", bilinear=bilinear,
                             deep_supervision=ds)
    assert set(sd) == set(build_model("unetpp", n_classes=C, base_features=BASE,
                                      deep_supervision=ds, bilinear=bilinear).state_dict())
    assert any(k.startswith("up0_1.") for k in sd) == (not bilinear)
    assert ("outc_4.conv.weight" in sd) == ds and ("outc.conv.weight" in sd) == (not ds)
    params, stats = jax_trees_from_state_dict(sd, "unetpp")
    for tree, want in ((params, v["params"]), (stats, v["batch_stats"])):
        flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_want = jax.tree_util.tree_flatten_with_path(jax.device_get(want))[0]
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (p, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))


def test_fold_bn_matches_unfolded(ds_variables):
    model = _port(ds_variables, ds=True)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(x)
        fold_batchnorm(model)
        assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
        got = model(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def quantized(request):
    """JAX's fold, calibration and qparams of a UNet++ variant: 'ds' (deep
    supervision), 'plain' (one head) or 'bilinear'."""
    ds, bilinear = request.param == "ds", request.param == "bilinear"
    v = warmed_variables(_jax(ds=ds, bilinear=bilinear), key=5)
    jf = jax.device_get(jq.full_fold(v["params"], v["batch_stats"]))
    calib = [u8_images(10 + i) for i in range(2)]
    absmax = jq.calibrate_absmax("unetpp", jf, calib, deep_supervision=ds)
    return {"v": v, "ds": ds, "bilinear": bilinear, "calib": calib, "absmax": absmax,
            "jqp": jax.device_get(jq.quantize_model("unetpp", jf, absmax))}


@pytest.mark.parametrize("quantized", ["ds", "plain", "bilinear"], indirect=True)
def test_int8_calibration_and_qparams_match_jax(quantized):
    """The port's fold and calibration on the same weights: the same tags
    (every node's relu1/relu2 and level-up ``up``) within 1e-4; the concat
    scale of each node covers its dense row; the qparams carry across the
    .npz layout unchanged."""
    q = quantized
    sd = state_dict_from_jax(q["v"]["params"], q["v"]["batch_stats"], "unetpp",
                             bilinear=q["bilinear"], deep_supervision=q["ds"])
    fparams = tq.full_fold(sd, "unetpp")
    got = tq.calibrate_absmax("unetpp", fparams, q["calib"], deep_supervision=q["ds"])
    assert set(got) == set(q["absmax"])
    assert len([t for t in got if t.endswith("/up")]) == 10
    for tag, want in q["absmax"].items():
        assert got[tag] == pytest.approx(want, rel=1e-4), tag
    port_q = qparams_from_numpy(q["jqp"])
    assert ("up0_1" in port_q["layers"]) == (not q["bilinear"])
    a = q["absmax"]  # x0_3's concat: the row x0_0..x0_2 and the level-up
    s_cat = tq.quantize_model("unetpp", fparams, a)["scales"]["x0_3/cat"]
    assert s_cat.item() == np.float32(max(a["x0_0/relu2"], a["x0_1/relu2"], a["x0_2/relu2"],
                                          a["x0_3/up"]) / 127.0)
    back, want = dict(_flat(qparams_to_numpy(port_q))), dict(_flat(q["jqp"]))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("quantized,heads", [("ds", 1), ("ds", 2), ("ds", 3), ("ds", 4),
                                             ("plain", 4), ("bilinear", 4)],
                         indirect=["quantized"])
def test_int8_forward_matches_jax_op_by_op(quantized, heads, monkeypatch):
    """JAX's qparams carried across: every int8 activation of the plan bit
    for bit, the logits within 1e-5; the plan is JAX's and holds the nodes
    i + j <= heads (deep supervision), all 15 otherwise; K2 runs twice per
    node: 30 convs per batch at heads 4, 6 at heads 1."""
    q = quantized
    images = u8_images(20)
    plan = jq.build_plan("unetpp", deep_supervision=q["ds"], heads=heads)
    assert tq.build_plan("unetpp", deep_supervision=q["ds"], heads=heads) == plan
    jenv = run_recording(jq._QuantExec(q["jqp"]), jax_eval_transform(jnp.asarray(images)), plan)
    calls = []
    real = tq._QuantExec.conv3x3
    monkeypatch.setattr(tq._QuantExec, "conv3x3",
                        staticmethod(lambda *a, **kw: calls.append(1) or real(*a, **kw)))
    port_q = qparams_from_numpy(q["jqp"])
    tenv = run_recording(tq._QuantExec(port_q), eval_transform(torch.from_numpy(images)), plan)
    n_nodes = {1: 3, 2: 6, 3: 10, 4: 15}[heads]
    assert len(calls) == 2 * n_nodes
    assert assert_int8_envs_equal(tenv, jenv) == 1 + heads + n_nodes
    fwd = tq.make_quantized_forward("unetpp", deep_supervision=q["ds"], heads=heads)
    want = jq.make_quantized_forward("unetpp", deep_supervision=q["ds"],
                                     heads=heads)(q["jqp"], jnp.asarray(images))
    np.testing.assert_allclose(fwd(port_q, torch.from_numpy(images)).numpy(), np.asarray(want),
                               atol=1e-5)
