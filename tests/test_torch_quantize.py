"""Port int8 quantization (tpu_unet_torch/ops/quantize.py) against the JAX
package's ops/quantize.py, on the CPU at base_features=4, 32 px: the fold, the
calibration, the quantized weights and scales, the int8 forward (each int8
activation bit for bit) and the shared .npz format."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_recording
from tests.test_torch_models import u8_images, warmed_variables
from tpu_unet.models import AnomalyUNet, UNet
from tpu_unet.ops import quantize as jq
from tpu_unet.ops.augment import eval_transform as jax_eval_transform
from tpu_unet_torch.ops import quantize as tq
from tpu_unet_torch.utils.weights import (ladder_layout, qparams_from_numpy,
                                          qparams_to_numpy, state_dict_from_jax)


@pytest.fixture(scope="module")
def setup():
    """JAX variables, the port's state_dict, both folds, JAX absmax and qparams."""
    v = warmed_variables(AnomalyUNet(base_features=4))
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    jf = jax.device_get(jq.full_fold(v["params"], v["batch_stats"]))
    calib = [u8_images(10 + i) for i in range(2)]
    absmax = jq.calibrate_absmax("anomaly_unet", jf, calib)
    jqp = jax.device_get(jq.quantize_model("anomaly_unet", jf, absmax))
    return {"v": v, "sd": sd, "jf": jf, "calib": calib, "absmax": absmax, "jqp": jqp}


def _jax_fold_in_port_layout(jf, arch="anomaly_unet"):
    """A JAX folded tree in the port's layouts (OIHW, flipped (in, out, 2, 2))."""
    out = {}
    for path, _, kind in ladder_layout(arch):
        node = jq._get(jf, path)
        leaves = ([(f"{path}/conv{i}", node[f"conv{i}"]) for i in (1, 2)]
                  if kind == "double" else [(path, node)])
        for leaf_path, leaf in leaves:
            k = np.asarray(leaf["kernel"])
            k = (k[::-1, ::-1].transpose(2, 3, 0, 1) if kind == "up"
                 else k.transpose(3, 2, 0, 1))
            tq._set(out, leaf_path, {"kernel": torch.from_numpy(np.ascontiguousarray(k)),
                                     "bias": torch.from_numpy(np.array(leaf["bias"]))})
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_full_fold_matches_jax(setup):
    got = dict(_flat(_to_numpy(tq.full_fold(setup["sd"]))))
    want = dict(_flat(_to_numpy(_jax_fold_in_port_layout(setup["jf"]))))
    assert set(got) == set(want)
    for k in want:  # rsqrt may differ by an ulp between XLA and PyTorch
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def test_calibrate_absmax_matches_jax(setup):
    fparams = tq.full_fold(setup["sd"])
    got = tq.calibrate_absmax("anomaly_unet", fparams, setup["calib"])
    assert set(got) == set(setup["absmax"])
    for tag, want in setup["absmax"].items():
        assert got[tag] == pytest.approx(want, rel=1e-4), tag


def test_percentile_calibration_matches_jax(setup):
    want = jq.calibrate_absmax("anomaly_unet", setup["jf"], setup["calib"][:1],
                               percentile=99.0)
    got = tq.calibrate_absmax("anomaly_unet", tq.full_fold(setup["sd"]),
                              setup["calib"][:1], percentile=99.0)
    for tag in want:
        assert got[tag] == pytest.approx(want[tag], rel=1e-4), tag


def test_quantize_model_gives_jax_kernels_and_scales(setup):
    """Same folded weights and the same absmax dict: every int8 kernel, weight
    scale, bias and activation scale equals JAX's exactly."""
    port = tq.quantize_model("anomaly_unet", _jax_fold_in_port_layout(setup["jf"]),
                             setup["absmax"])
    got = dict(_flat(qparams_to_numpy(port)))
    want = dict(_flat(setup["jqp"]))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_int8_forward_matches_jax_bit_for_bit(setup):
    """qparams carried across: every int8 activation of the plan is bit-exact
    (no 1-LSB tie flips), and the f32 heads agree within 1e-5."""
    images = u8_images(20)
    plan = jq.build_plan("anomaly_unet")
    assert tq.build_plan("anomaly_unet") == plan
    jenv = run_recording(jq._QuantExec(setup["jqp"]),
                          jax_eval_transform(jnp.asarray(images)), plan)
    port_q = qparams_from_numpy(setup["jqp"])
    from tpu_unet_torch.ops.augment import eval_transform
    tenv = run_recording(tq._QuantExec(port_q), eval_transform(torch.from_numpy(images)),
                          plan)
    n_int8 = 0
    for key, want in jenv.items():
        if key.startswith("out/"):
            np.testing.assert_allclose(tenv[key].numpy(), np.asarray(want), atol=1e-5)
            continue
        q, s = tenv[key]
        np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]), err_msg=key)
        assert s.item() == float(want[1]), key
        n_int8 += 1
    assert n_int8 == 18  # x0..x5 and 2 decoders x 4 up blocks + pools

    recon, amap = tq.make_quantized_forward("anomaly_unet")(port_q, torch.from_numpy(images))
    jrecon, jamap = jq.make_quantized_forward("anomaly_unet")(setup["jqp"], jnp.asarray(images))
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), atol=1e-5)
    np.testing.assert_allclose(amap.numpy(), np.asarray(jamap), atol=1e-5)
    score_only = tq.make_quantized_forward("anomaly_unet", score_only=True)
    assert torch.equal(score_only(port_q, torch.from_numpy(images)), recon)


def test_unet_int8_forward_matches_jax():
    v = warmed_variables(UNet(n_classes=2, base_features=4), key=7)
    jf = jax.device_get(jq.full_fold(v["params"], v["batch_stats"]))
    absmax = jq.calibrate_absmax("unet", jf, [u8_images(30)])
    jqp = jax.device_get(jq.quantize_model("unet", jf, absmax))
    images = u8_images(31)
    want = jq.make_quantized_forward("unet")(jqp, jnp.asarray(images))
    got = tq.make_quantized_forward("unet")(qparams_from_numpy(jqp), torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bilinear_anomaly_int8_matches_jax_op_by_op():
    """A bilinear AnomalyUNet (no ``up`` leaves: the upsample is a float
    island requantized to the concat scale): the port's calibration tags
    within 1e-4, every int8 activation of the full and the score-only plan
    bit for bit against JAX's ``_QuantExec``, the heads within 1e-5."""
    from _torch_parity import assert_int8_envs_equal

    v = warmed_variables(AnomalyUNet(base_features=4, bilinear=True), key=8)
    jf = jax.device_get(jq.full_fold(v["params"], v["batch_stats"]))
    calib = [u8_images(40 + i) for i in range(2)]
    absmax = jq.calibrate_absmax("anomaly_unet", jf, calib)
    sd = state_dict_from_jax(v["params"], v["batch_stats"], bilinear=True)
    got = tq.calibrate_absmax("anomaly_unet", tq.full_fold(sd), calib)
    assert set(got) == set(absmax)
    for tag, want in absmax.items():
        assert got[tag] == pytest.approx(want, rel=1e-4), tag
    jqp = jax.device_get(jq.quantize_model("anomaly_unet", jf, absmax))
    port_q = qparams_from_numpy(jqp)
    assert "up" not in port_q["layers"]["decoder_recon"]["up_recon1"]
    from tpu_unet_torch.ops.augment import eval_transform
    images = u8_images(41)
    plan = jq.build_plan("anomaly_unet")
    jenv = run_recording(jq._QuantExec(jqp), jax_eval_transform(jnp.asarray(images)), plan)
    tenv = run_recording(tq._QuantExec(port_q), eval_transform(torch.from_numpy(images)), plan)
    assert assert_int8_envs_equal(tenv, jenv) == 18
    recon = tq.make_quantized_forward("anomaly_unet", score_only=True)(
        port_q, torch.from_numpy(images))
    assert torch.equal(recon, tenv["out/outc_recon"])


def test_jax_qparams_file_loads_in_the_port(setup, tmp_path):
    path = str(tmp_path / "q.npz")
    jq.save_qparams(setup["jqp"], path)
    port = tq.load_qparams(path)
    direct = qparams_from_numpy(setup["jqp"])
    got, want = dict(_flat(_to_numpy(port))), dict(_flat(_to_numpy(direct)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and back: the port's file loads in JAX unchanged
    back = str(tmp_path / "back.npz")
    tq.save_qparams(port, back)
    original = dict(_flat(jax.device_get(jq.load_qparams(path))))
    again = dict(_flat(jax.device_get(jq.load_qparams(back))))
    assert set(again) == set(original)
    for k, vv in again.items():
        assert vv.dtype == original[k].dtype, k
        np.testing.assert_array_equal(vv, original[k], err_msg=k)


def test_quantize_from_train_state_runs_on_the_device_asked_for(setup):
    """The one-call PTQ equals its three steps on the CPU when asked for, and
    its default device (cuda) raises without a GPU instead of calibrating on
    the CPU."""
    got = tq.quantize_from_train_state("anomaly_unet", setup["sd"], setup["calib"],
                                       device="cpu")
    fparams = tq.full_fold(setup["sd"])
    want = tq.quantize_model("anomaly_unet", fparams,
                             tq.calibrate_absmax("anomaly_unet", fparams, setup["calib"]))
    got, want = dict(_flat(_to_numpy(got))), dict(_flat(_to_numpy(want)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tq.quantize_from_train_state("anomaly_unet", setup["sd"], setup["calib"])


def test_chunk_calibration_and_unported_archs():
    chunks = tq.chunk_calibration(np.zeros((38, 4, 4, 3), np.uint8), 16)
    assert [len(c) for c in chunks] == [16, 16]
    assert len(tq.chunk_calibration(np.zeros((5, 4, 4, 3), np.uint8), 16)[0]) == 5
    with pytest.raises(ValueError):
        tq.chunk_calibration(np.zeros((0, 4, 4, 3), np.uint8))
    # UNet++'s plan is the JAX package's, node for node; its heads are checked
    assert tq.build_plan("unetpp") == jq.build_plan("unetpp")
    with pytest.raises(ValueError, match="heads"):
        tq.build_plan("unetpp", deep_supervision=True, heads=0)
    with pytest.raises(ValueError):
        tq.build_plan("resnet")


class _UnpaddedExec(tq._QuantExec):
    """The int8 forward with every layer at its own width: natural 3x3
    weights (the plain K2 takes any Cout) and unpadded matmul operands."""

    def _leaf(self, path, s_in, kind):
        leaf = tq._get(self.layers, path)
        k, scale, bias = leaf["kernel"], s_in * leaf["w_scale"], leaf["bias"]
        cout = k.shape[0] if kind == "conv" else k.shape[-1]
        if kind == "up":
            k, scale, bias = k.reshape(k.shape[0], -1), scale.repeat(4), bias.repeat(4)
        return {"kernel": k, "scale": scale, "bias": bias, "cout": cout}


@pytest.mark.parametrize("base,n,hw", [(8, 2, 32), (12, 1, 32)])
def test_padded_widths_equal_the_unpadded_path(base, n, hw, monkeypatch):
    """The widths CUDA needs, padded with zeros on every device: K2's Cout to
    16 (weights, scale, bias), torch._int_mm's inner dim to 8 and rows to
    17. At base 8 and 12 (Cout 8, 12, 24; a 12-channel head; 4 rows at the
    bottleneck of one 32² image) every int8 activation and the logits equal
    the unpadded path's bit for bit."""
    torch.manual_seed(base)
    from tpu_unet_torch.models import build_model
    model = build_model("seg_unet", n_classes=3, base_features=base).eval()
    fparams = tq.full_fold(model.state_dict(), "seg_unet")
    calib = [u8_images(60 + base, (4, hw, hw, 3))]
    qp = tq.quantize_model("seg_unet", fparams, tq.calibrate_absmax("seg_unet", fparams, calib))
    from tpu_unet_torch.ops.augment import eval_transform
    x = eval_transform(torch.from_numpy(u8_images(70 + base, (n, hw, hw, 3))))
    plan = tq.build_plan("seg_unet")
    padded = tq._QuantExec(qp)
    got = run_recording(padded, x, plan)
    assert padded._consts["encoder/inc/conv1"]["kernel"].shape == (16, 32)  # Cout 8/12 -> 16
    assert padded._consts["outc/conv"]["kernel"].shape[0] % 8 == 0
    monkeypatch.setattr(tq, "_int_matmul", lambda x2d, k, n_out: (
        x2d.to(torch.int64) @ k.to(torch.int64)).to(torch.int32)[:, :n_out])
    want = run_recording(_UnpaddedExec(qp), x, plan)
    assert set(got) == set(want)
    for key, w in want.items():
        if key.startswith("out/"):
            assert torch.equal(got[key], w), key
            continue
        assert got[key][0].shape == w[0].shape and got[key][0].is_contiguous(), key
        assert torch.equal(got[key][0], w[0]), key
