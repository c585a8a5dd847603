"""The port's attention UNet (tpu_unet_torch/models/attention.py and the gated
Up of models/blocks.py) against the JAX package's, on the CPU at
base_features=4: eval forward to 1e-3 (as tests/test_torch_models.py holds
the ladder), the gate alone in bfloat16, train-mode running statistics of
the gate BNs to 1e-5, fold_bn covering the gates, the weights carried JAX ->
torch -> JAX, the parameter count, and the int8 plan op by op against JAX's
``_QuantExec`` (every int8 activation bit for bit, the gates in float)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_int8_envs_equal, run_recording
from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_models import u8_images, warmed_variables
from tpu_unet.core.precision import get_policy as jax_policy
from tpu_unet.models.attention import AttentionGate as JaxGate
from tpu_unet.models.attention import AttentionUNet as JaxAttentionUNet
from tpu_unet.ops import quantize as jq
from tpu_unet.ops.augment import eval_transform as jax_eval_transform
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models.attention import AttentionGate
from tpu_unet_torch.ops import quantize as tq
from tpu_unet_torch.ops.augment import eval_transform
from tpu_unet_torch.ops.fold_bn import fold_batchnorm
from tpu_unet_torch.utils.weights import (jax_trees_from_state_dict, qparams_from_numpy,
                                          qparams_to_numpy, state_dict_from_jax)

BASE = 4


def _port(v, bilinear=False, precision="f32"):
    model = build_model("attn_unet", n_classes=4, base_features=BASE, bilinear=bilinear,
                        policy=get_policy(precision))
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], "attn_unet",
                                              bilinear=bilinear))
    return model.eval()


@pytest.fixture(scope="module")
def variables():
    return warmed_variables(JaxAttentionUNet(n_classes=4, base_features=BASE), key=3)


def test_param_count_at_base_64():
    model = build_model("attn_unet", n_classes=4)
    assert sum(p.numel() for p in model.parameters()) == 31_562_476


@pytest.mark.parametrize("shape,bilinear", [((2, 32, 32, 3), False), ((2, 34, 30, 3), False),
                                            ((1, 32, 32, 3), True)])
def test_eval_forward_matches_jax(shape, bilinear):
    """Square, odd and H != W extents (the stride-2 projection cropped, the
    alpha map resized at H != W), and a bilinear decoder: 1e-3."""
    jax_model = JaxAttentionUNet(n_classes=4, base_features=BASE, bilinear=bilinear)
    v = warmed_variables(jax_model, key=5, shape=shape, steps=1)
    x = np.array(jax_eval_transform(jnp.asarray(u8_images(1, shape))))
    want = np.asarray(jax_model.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _port(v, bilinear)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-3)


def _gate_state_dict(p, s):
    """A JAX gate's (params, batch_stats) -> the port gate's state_dict."""
    sd = {}
    for jconv, jbn, tconv, tbn in (("g", "bn1", "g.conv1", "g.bn1"),
                                   ("x", "bn1", "x.conv1", "x.bn1"),
                                   (None, "bn2", "conv2", "bn2")):
        node, st = (p, s) if jconv is None else (p[jconv], s[jconv])
        conv = node["conv2" if jconv is None else "conv1"]
        sd[f"{tconv}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"{tbn}.weight"] = torch.from_numpy(np.asarray(node[jbn]["scale"]))
        sd[f"{tbn}.bias"] = torch.from_numpy(np.asarray(node[jbn]["bias"]))
        sd[f"{tbn}.running_mean"] = torch.from_numpy(np.asarray(st[jbn]["mean"]))
        sd[f"{tbn}.running_var"] = torch.from_numpy(np.asarray(st[jbn]["var"]))
        sd[f"{tbn}.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gate_alone_matches_jax(precision):
    """The gate at the JAX dtypes step by step: f32 to 1e-5; bf16 (the
    projections and psi in bf16, BNs, sigmoid and resize in f32, the gated
    skip cast to bf16) to one bf16 ulp of the gated value."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
    x = rng.standard_normal((2, 17, 12, 8)).astype(np.float32)
    gate = JaxGate(f_int=4, policy=jax_policy(precision))
    v = jax.device_get(gate.init(jax.random.key(1), g, x, train=False))
    v = {"params": jax.tree_util.tree_map(
             lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), v["params"]),
         "batch_stats": jax.tree_util.tree_map(
             lambda a: a + 0.2 * rng.uniform(size=a.shape).astype(np.float32),
             v["batch_stats"])}
    want = np.asarray(gate.apply(v, jnp.asarray(g).astype(jax_policy(precision).compute_dtype),
                                 jnp.asarray(x).astype(jax_policy(precision).compute_dtype),
                                 train=False).astype(jnp.float32))
    port = AttentionGate(16, 8, 4, policy=get_policy(precision))
    port.load_state_dict(_gate_state_dict(v["params"], v["batch_stats"]))
    cd = get_policy(precision).compute_dtype
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(g).permute(0, 3, 1, 2).to(cd),
                          torch.from_numpy(x).permute(0, 3, 1, 2).to(cd))
    assert got.dtype == cd
    got = got.permute(0, 2, 3, 1).float().numpy()
    if precision == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        np.testing.assert_array_less(np.abs(got - want), np.abs(want) * 2.0 ** -7 + 1e-6)


def test_train_mode_gate_running_statistics_match_flax(variables):
    """Three train-mode passes: the running mean and variance of every gate
    BN (bn1 of W_g and W_x, the 1-channel bn2) follow flax's to 1e-5."""
    jax_model = JaxAttentionUNet(n_classes=4, base_features=BASE, dropout=0.0)
    v = variables
    model = _port(v).train()
    model.dropout = 0.0
    for i in range(3):
        x = np.array(jax.random.normal(jax.random.key(400 + i), (2, 32, 32, 3)))
        _, mut = jax_model.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        with torch.no_grad():
            model(torch.from_numpy(x).permute(0, 3, 1, 2))
    _, stats = jax_trees_from_state_dict(model.state_dict(), "attn_unet")
    want = jax.device_get(v["batch_stats"])
    n = 0
    for k in range(1, 5):
        for sub in ("g/bn1", "x/bn1", "bn2"):
            node, ref = stats["decoder"][f"up{k}"]["att"], want["decoder"][f"up{k}"]["att"]
            for part in sub.split("/"):
                node, ref = node[part], ref[part]
            for key in ("mean", "var"):
                np.testing.assert_allclose(node[key], np.asarray(ref[key]), rtol=1e-5,
                                           atol=1e-7, err_msg=f"up{k}/att/{sub}/{key}")
                n += 1
    assert n == 24


def test_fold_bn_covers_the_gates(variables):
    """All 18 DoubleConv BNs and the 12 gate BNs fold; the folded model
    matches the unfolded one and the JAX package's folded model to 1e-5."""
    from tpu_unet.ops.fold_bn import fold_batchnorm as jax_fold

    model = _port(variables)
    x = np.array(jax_eval_transform(jnp.asarray(u8_images(2))))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        ref = model(xt)
        n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
        fold_batchnorm(model)
        assert n_bn == 18 + 12
        assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
        got = model(xt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    fp, fs = jax_fold(variables["params"], variables["batch_stats"])
    jax_model = JaxAttentionUNet(n_classes=4, base_features=BASE)
    want = np.asarray(jax_model.apply({"params": fp, "batch_stats": fs}, jnp.asarray(x)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("bilinear", [False, True])
def test_weights_round_trip_jax_torch_jax(bilinear):
    v = warmed_variables(JaxAttentionUNet(n_classes=4, base_features=BASE, bilinear=bilinear),
                         key=9, steps=1)
    sd = state_dict_from_jax(v["params"], v["batch_stats"], "attn_unet", bilinear=bilinear)
    assert set(sd) == set(build_model("attn_unet", n_classes=4, base_features=BASE,
                                      bilinear=bilinear).state_dict())
    assert {k for k in sd if ".att." in k and k.endswith(".weight")} == {
        f"up{k}.att.{n}.weight" for k in range(1, 5)
        for n in ("g.conv1", "g.bn1", "x.conv1", "x.bn1", "conv2", "bn2")}
    params, stats = jax_trees_from_state_dict(sd, "attn_unet")
    for tree, want in ((params, v["params"]), (stats, v["batch_stats"])):
        flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_want = jax.tree_util.tree_flatten_with_path(jax.device_get(want))[0]
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (p, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def quantized(variables):
    jf = jax.device_get(jq.full_fold(variables["params"], variables["batch_stats"]))
    calib = [u8_images(10 + i) for i in range(2)]
    absmax = jq.calibrate_absmax("attn_unet", jf, calib)
    return {"jf": jf, "calib": calib, "absmax": absmax,
            "jqp": jax.device_get(jq.quantize_model("attn_unet", jf, absmax))}


def test_int8_calibration_tags_match_jax(variables, quantized):
    """The port's fold and calibration on the same weights: the same tags,
    among them the gates' ``att/out``, within 1e-4; the gate leaves of the
    quantized tree stay float and carry across the .npz layout unchanged."""
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], "attn_unet")
    got = tq.calibrate_absmax("attn_unet", tq.full_fold(sd, "attn_unet"), quantized["calib"])
    assert set(got) == set(quantized["absmax"])
    assert {f"decoder/up{k}/att/out" for k in range(1, 5)} <= set(got)
    for tag, want in quantized["absmax"].items():
        assert got[tag] == pytest.approx(want, rel=1e-4), tag
    port_q = qparams_from_numpy(quantized["jqp"])
    att = port_q["layers"]["decoder"]["up1"]["att"]
    assert att["g"]["conv1"]["kernel"].dtype == torch.float32 and "w_scale" not in att["conv2"]
    back, want = dict(_flat(qparams_to_numpy(port_q))), dict(_flat(quantized["jqp"]))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_int8_forward_matches_jax_op_by_op(quantized):
    """JAX's qparams carried across: every int8 activation of the plan, the
    gated up blocks included, bit for bit; the logits within 1e-5; the plan
    is JAX's and runs 18 K2 convs."""
    images = u8_images(20)
    plan = jq.build_plan("attn_unet")
    assert tq.build_plan("attn_unet") == plan
    assert sum(op[0] == "up_block" and op[5] for op in plan) == 4
    jenv = run_recording(jq._QuantExec(quantized["jqp"]),
                         jax_eval_transform(jnp.asarray(images)), plan)
    tenv = run_recording(tq._QuantExec(qparams_from_numpy(quantized["jqp"])),
                         eval_transform(torch.from_numpy(images)), plan)
    assert assert_int8_envs_equal(tenv, jenv) == 14  # x1..x5, 4 pools, 4 up blocks, input
    n_conv = sum(op[0] in ("double_conv", "up_block") for op in plan)
    assert 2 * n_conv == 18
