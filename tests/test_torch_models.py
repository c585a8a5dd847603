"""Port models (tpu_unet_torch/models, ops/fold_bn.py, utils/weights.py)
against the JAX package's models, on the CPU at base_features=4, 32 px.

Weights come from a JAX init plus a few train-mode passes (non-trivial BN
statistics) and cross into the port through utils/weights.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.models as jm
from tpu_unet.models.attention import AttentionUNet as JaxAttentionUNet
from tpu_unet.ops.augment import eval_transform as jax_eval_transform
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.fold_bn import fold_batchnorm
from tpu_unet_torch.utils.weights import state_dict_from_jax

BASE = 4


def warmed_variables(model, key=0, shape=(2, 32, 32, 3), steps=3):
    """JAX init + a few train-mode passes so BN stats are non-trivial; numpy leaves."""
    x = jax.random.normal(jax.random.key(key + 100), shape)
    v = model.init(jax.random.key(key), x, train=False)
    for i in range(steps):
        xi = jax.random.normal(jax.random.key(key + 200 + i), shape)
        _, mut = model.apply(v, xi, train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(key + 300 + i)})
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    return jax.device_get(v)


def u8_images(seed, shape=(2, 32, 32, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def port_model(name, variables, n_classes=1, precision="f32"):
    from tpu_unet_torch.core.precision import get_policy
    model = build_model(name, n_classes=n_classes, base_features=BASE,
                        policy=get_policy(precision))
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"], model=name))
    return model.eval()


_JAX_MODELS = {
    "unet": lambda: jm.UNet(n_classes=1, base_features=BASE),
    "seg_unet": lambda: jm.SegmentationUNet(n_classes=4, base_features=BASE),
    "anomaly_unet": lambda: jm.AnomalyUNet(base_features=BASE),
}
_CLASSES = {"unet": 1, "seg_unet": 4, "anomaly_unet": 1}


@pytest.fixture(scope="module")
def anomaly_variables():
    return warmed_variables(_JAX_MODELS["anomaly_unet"]())


@pytest.mark.parametrize("name,n_classes,count", [
    ("unet", 1, 31_037_633),
    ("seg_unet", 4, 31_037_828),
    ("anomaly_unet", 1, 43_228_228),
])
def test_full_width_param_counts(name, n_classes, count):
    model = build_model(name, n_classes=n_classes)
    assert sum(p.numel() for p in model.parameters()) == count


@pytest.mark.parametrize("name", ["unet", "seg_unet", "anomaly_unet"])
def test_eval_forward_parity_with_jax(name):
    jax_model = _JAX_MODELS[name]()
    v = warmed_variables(jax_model, key=3)
    x = np.array(jax_eval_transform(jnp.asarray(u8_images(1))))
    ref = jax_model.apply(v, jnp.asarray(x), train=False)
    ref = ref if isinstance(ref, tuple) else (ref,)
    model = port_model(name, v, n_classes=_CLASSES[name])
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        # f32 conv-order noise over 23 layers (tests/test_torch_import.py:114)
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   atol=1e-3)


_JAX_BILINEAR = {
    "unet": lambda: jm.UNet(n_classes=1, base_features=BASE, bilinear=True),
    "seg_unet": lambda: jm.SegmentationUNet(n_classes=4, base_features=BASE, bilinear=True),
    "anomaly_unet": lambda: jm.AnomalyUNet(base_features=BASE, bilinear=True),
    "attn_unet": lambda: JaxAttentionUNet(n_classes=4, base_features=BASE, bilinear=True),
}


@pytest.mark.parametrize("name", ["unet", "seg_unet", "anomaly_unet", "attn_unet"])
def test_bilinear_eval_forward_parity_with_jax(name):
    """Bilinear decoders (align-corners upsample, ``factor`` 2 widths, no
    ``up`` parameters), at an H != W size that pads the upsample: the
    parameter count equals JAX's, the eval forward within 1e-3, and
    score_forward is the reconstruction."""
    jax_model = _JAX_BILINEAR[name]()
    shape = (2, 36, 28, 3)
    v = warmed_variables(jax_model, key=4, shape=shape, steps=1)
    x = np.array(jax_eval_transform(jnp.asarray(u8_images(6, shape))))
    ref = jax_model.apply(v, jnp.asarray(x), train=False)
    ref = ref if isinstance(ref, tuple) else (ref,)
    model = build_model(name, n_classes=_CLASSES.get(name, 4), base_features=BASE,
                        bilinear=True)
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], model=name,
                                              bilinear=True))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(v["params"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = model.eval()(xt)
        out = out if isinstance(out, tuple) else (out,)
        if name == "anomaly_unet":
            assert torch.equal(model.score_forward(xt), out[0])
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(r), atol=1e-3)


def test_reference_bilinear_pth_loads_strict(tmp_path):
    """A reference-layout bilinear checkpoint (``upK.conv.double_conv.*``, no
    ``upK.up.*``, mid width in // 2) loads with strict=True."""
    from tpu_unet_torch.utils.weights import load_reference_checkpoint

    sd = build_model("unet", n_classes=1, base_features=BASE, bilinear=True).state_dict()
    assert not any(".up." in k for k in sd)
    assert sd["up1.conv.double_conv.0.weight"].shape == (8 * BASE, 16 * BASE, 3, 3)
    path = str(tmp_path / "ref.pth")
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    fresh = build_model("unet", n_classes=1, base_features=BASE, bilinear=True)
    fresh.load_state_dict(load_reference_checkpoint(path), strict=True)


def test_score_forward_is_the_recon_output(anomaly_variables):
    model = port_model("anomaly_unet", anomaly_variables)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        recon, _ = model(x)
        assert torch.equal(model.score_forward(x), recon)


def test_fold_bn_matches_unfolded(anomaly_variables):
    model = port_model("anomaly_unet", anomaly_variables)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(x)
        folded = fold_batchnorm(model)
        assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
        out = folded(x)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=1e-5)


def test_state_dict_carries_every_reference_key(anomaly_variables):
    """state_dict_from_jax yields exactly the port model's (reference) keys, and
    only the transposed-conv kernels differ from export_state_dict's mapping:
    flipped in both spatial axes, flax's ConvTranspose convention."""
    from tpu_unet.utils.torch_import import export_state_dict

    sd = state_dict_from_jax(anomaly_variables["params"],
                             anomaly_variables["batch_stats"])
    assert set(sd) == set(build_model("anomaly_unet", base_features=BASE).state_dict())
    exported = export_state_dict(anomaly_variables["params"],
                                 anomaly_variables["batch_stats"])
    assert set(exported) == set(sd)
    for k, v in exported.items():
        want = np.asarray(v)[..., ::-1, ::-1] if k.endswith(".up.weight") else v
        np.testing.assert_array_equal(sd[k].numpy(), want, err_msg=k)


def test_bf16_policy_forward_tracks_f32(anomaly_variables):
    """bf16 convs with f32 params, BN and ReLU in f32: close to the f32 model
    at bf16's ~3 significant digits."""
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    f32 = port_model("anomaly_unet", anomaly_variables)
    bf16 = port_model("anomaly_unet", anomaly_variables, precision="bf16")
    with torch.no_grad():
        r32, _ = f32(x)
        r16, a16 = bf16(x)
    assert r16.dtype == torch.float32 and a16.dtype == torch.float32
    np.testing.assert_allclose(r16.numpy(), r32.numpy(), atol=3e-2)


def test_unported_variants_raise():
    """Every variant of the JAX package's build_model builds (bilinear
    ladders, UNet++, the attention UNet), and the JAX package's ValueErrors
    hold: deep supervision or ``heads`` outside UNet++ with deep
    supervision, and an unknown model."""
    assert not any(k.endswith(".up.weight")
                   for k in build_model("anomaly_unet", bilinear=True).state_dict())
    assert type(build_model("unetpp")).__name__ == "UNetPlusPlus"
    assert type(build_model("attn_unet")).__name__ == "AttentionUNet"
    with pytest.raises(ValueError, match="deep_supervision"):
        build_model("seg_unet", deep_supervision=True)
    with pytest.raises(ValueError, match="heads"):
        build_model("unetpp", heads=2)
    with pytest.raises(ValueError, match="heads"):
        build_model("unetpp", deep_supervision=True, heads=5)
    with pytest.raises(ValueError):
        build_model("resnet")


def test_train_mode_bn_running_stats_match_flax(anomaly_variables):
    """Three train-mode passes from the same statistics: the port's running
    mean and variance follow flax's (biased batch variance, momentum 0.1)."""
    from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

    jax_model = _JAX_MODELS["anomaly_unet"]()
    v = anomaly_variables
    model = port_model("anomaly_unet", v).train()
    for i in range(3):
        x = np.array(jax.random.normal(jax.random.key(400 + i), (2, 32, 32, 3)))
        _, mut = jax_model.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        with torch.no_grad():
            model(torch.from_numpy(x).permute(0, 3, 1, 2))
    _, stats = jax_trees_from_state_dict(model.state_dict())
    ref = jax.device_get(v["batch_stats"])
    n = 0
    for path in ["encoder/inc", "encoder/down4/conv", "decoder_seg/up_seg4/conv"]:
        for bn in ("bn1", "bn2"):
            node, want = stats, ref
            for part in path.split("/") + [bn]:
                node, want = node[part], want[part]
            for k in ("mean", "var"):
                np.testing.assert_allclose(node[k], np.asarray(want[k]), rtol=1e-5,
                                           atol=1e-7, err_msg=f"{path}/{bn}/{k}")
                n += 1
    assert n == 12
    assert int(model.inc.double_conv[1].num_batches_tracked) == 3


def test_bn_differs_from_torch_only_in_the_running_variance(anomaly_variables):
    """Against nn.BatchNorm2d on the same state: eval forward bit for bit, train
    forward bit for bit, running mean equal, running variance biased (torch
    keeps the unbiased one: n/(n-1) times larger)."""
    import copy

    from tpu_unet_torch.models.blocks import BatchNorm2d

    ours = port_model("anomaly_unet", anomaly_variables)
    plain = copy.deepcopy(ours)
    for m in plain.modules():
        if isinstance(m, BatchNorm2d):
            m.__class__ = torch.nn.BatchNorm2d
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for a, b in zip(ours.eval()(x), plain.eval()(x)):
            assert torch.equal(a, b)
        for a, b in zip(ours.train()(x), plain.train()(x)):
            assert torch.equal(a, b)
    bn_ours, bn_plain = ours.inc.double_conv[1], plain.inc.double_conv[1]
    assert torch.equal(bn_ours.running_mean, bn_plain.running_mean)
    n = 2 * 32 * 32  # values per channel in the batch
    before = torch.from_numpy(np.array(
        anomaly_variables["batch_stats"]["encoder"]["inc"]["bn1"]["var"]))
    batch_var_ours = (bn_ours.running_var - 0.9 * before) / 0.1
    batch_var_plain = (bn_plain.running_var - 0.9 * before) / 0.1
    np.testing.assert_allclose(batch_var_plain.numpy(),
                               (batch_var_ours * n / (n - 1)).numpy(), rtol=1e-4)
