"""The port's SegmentationPredictor (tpu_unet_torch/serve.py) against
tpu_unet.serve.SegmentationPredictor on the CPU: SegmentationUNet, UNet++
with deep supervision at --heads 1 and the attention UNet at base 4, 32 px,
batch 4, the same weights in both packages (a seeded port state_dict and
its JAX trees, utils/weights.py)."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import jax_variables, one_torch_thread, seeded_state_dict  # noqa: F401
from tpu_unet.serve import SegmentationPredictor as JaxPredictor
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.fold_bn import fold_batchnorm
from tpu_unet_torch.serve import DecodeError, SegmentationPredictor
from tpu_unet_torch.utils.weights import qparams_from_numpy

C = 4
# name -> (model_name, build kwargs, predictor kwargs)
MODELS = {
    "seg_unet": ("seg_unet", {}, {}),
    "unetpp_heads1": ("unetpp", {"deep_supervision": True},
                      {"deep_supervision": True, "heads": 1}),
    "attn_unet": ("attn_unet", {}, {}),
}
KW = dict(num_classes=C, image_size_hw=(32, 32), batch_size=4, base_features=4)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    name, build_kw, pred_kw = MODELS[request.param]
    sd = seeded_state_dict(name, 5, n_classes=C, base_features=4, **build_kw)
    return {"key": request.param, "name": name, "sd": sd, "v": jax_variables(sd, name),
            "pred_kw": {"model_name": name, **pred_kw}}


def _images(seed, n=6, hw=(32, 32)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _port(m, **kw):
    return SegmentationPredictor.from_state_dict(m["sd"], device="cpu",
                                                 **{**KW, **m["pred_kw"], **kw})


def _jax(m, **kw):
    return JaxPredictor.from_variables(m["v"]["params"], m["v"]["batch_stats"],
                                       **{**KW, **m["pred_kw"], **kw})


def _top2_gap(m, images):
    """The f32 port model's (BN folded) gap between its two largest logits
    per pixel: where it is below float32 rounding, the argmax is a tie."""
    kw = {k: v for k, v in m["pred_kw"].items() if k != "model_name"}
    net = build_model(m["name"], n_classes=C, base_features=4, **kw)
    net.load_state_dict(m["sd"])
    fold_batchnorm(net.eval())
    from tpu_unet_torch.ops.augment import eval_transform
    with torch.inference_mode():
        logits = net(eval_transform(torch.from_numpy(images)).permute(0, 3, 1, 2))
    top = torch.topk(logits, 2, dim=1).values
    return (top[:, 0] - top[:, 1]).numpy()


def test_f32_matches_jax(model):
    """f32: masks equal except where the top two logits are within 1e-4
    (ties that the packages' summation orders may break either way);
    confidences to rtol 1e-5. Six images at batch 4: a padded chunk."""
    images = _images(1)
    want_m, want_c = _jax(model, precision="f32").predict_array(images)
    got_m, got_c = _port(model, precision="f32").predict_array(images)
    assert got_m.shape == (6, 32, 32) and got_m.dtype == np.uint8
    assert got_c.shape == (6,) and got_c.dtype == np.float32
    differ = got_m != want_m
    assert (_top2_gap(model, images)[differ] < 1e-4).all()
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)


# Share of pixels whose bf16 class equals JAX's bf16 class: bf16 keeps 8
# mantissa bits and the packages round at different points
# (tests/test_torch_serve.py::test_bf16_scores_match_jax). Measured: 1.0 for
# all three models (6 images of 32x32), confidences within 4.9e-5; the limits
# allow 0.5% of the pixels and 5e-4.
BF16_MIN_AGREE = 0.995


def test_bf16_agrees_with_jax(model):
    images = _images(2)
    want_m, want_c = _jax(model, precision="bf16").predict_array(images)
    got_m, got_c = _port(model, precision="bf16").predict_array(images)
    assert (got_m == want_m).mean() >= BF16_MIN_AGREE
    np.testing.assert_allclose(got_c, want_c, rtol=5e-4)


@pytest.fixture(scope="module")
def jax_qparams(model):
    from tpu_unet.ops.quantize import chunk_calibration, quantize_from_train_state
    return jax.device_get(quantize_from_train_state(
        model["name"], model["v"]["params"], model["v"]["batch_stats"],
        chunk_calibration(_images(40, n=8), 8),
        deep_supervision=model["pred_kw"].get("deep_supervision", False)))


# int8 against JAX's jitted predictor on the same qparams: XLA's fused
# epilogues round differently from the op-by-op int8 forward (ROADMAP fault
# 2) and can flip an int8 activation by one step. Measured: shares 1.0 for
# all three models, confidences within 4.8e-7; the limits allow 0.5% of the
# pixels and 1e-4. Against the op-by-op forward the port's masks are equal.
INT8_MIN_AGREE_JITTED = 0.995


def test_int8_matches_jax_with_the_same_qparams(model, jax_qparams):
    from tpu_unet.ops import quantize as jq
    from tpu_unet.ops.augment import eval_transform as jax_eval
    from tpu_unet.ops.seg_head import sliced_pred_confidence as jax_head

    images = _images(3)
    pred = _port(model, quantize="int8", qparams=qparams_from_numpy(jax_qparams))
    assert pred.quantize == "int8"
    got_m, got_c = pred.predict_array(images)
    ds = model["pred_kw"].get("deep_supervision", False)
    plan = jq.build_plan(model["name"], deep_supervision=ds,
                         heads=model["pred_kw"].get("heads", 4))
    logits = jq._run(jq._QuantExec(jax_qparams), jax_eval(images), plan)
    op_m, op_c = (np.asarray(a) for a in jax_head(logits))
    np.testing.assert_array_equal(got_m, op_m)
    np.testing.assert_allclose(got_c, op_c.mean(axis=(1, 2)), rtol=1e-5)
    jit_m, jit_c = _jax(model, quantize="int8", qparams=jax_qparams).predict_array(images)
    assert (got_m == jit_m).mean() >= INT8_MIN_AGREE_JITTED
    np.testing.assert_allclose(got_c, jit_c, rtol=1e-4)


def test_int8_calibrated_in_process_tracks_f32(model):
    """A predictor calibrated here on 8 images against the f32 one: measured
    agreement 1.0 for all three models; the limit allows 1% of the pixels."""
    images = _images(4)
    q = _port(model, quantize="int8", calib_images=_images(41, n=8))
    f = _port(model, precision="f32")
    assert (q.predict_array(images)[0] == f.predict_array(images)[0]).mean() >= 0.99
    with pytest.raises(ValueError, match="calib_images"):
        _port(model, quantize="int8")


@pytest.fixture(scope="module")
def seg():
    return {"sd": seeded_state_dict("seg_unet", 6, n_classes=C, base_features=4)}


def _seg_port(seg, **kw):
    return SegmentationPredictor.from_state_dict(seg["sd"], device="cpu",
                                                 **{**KW, "precision": "f32", **kw})


def test_buckets_padding_and_empty_input(seg):
    images = _images(5, n=7)
    plain = _seg_port(seg)
    laddered = _seg_port(seg, bucket_sizes=(1, 2))
    assert laddered.bucket_sizes == (1, 2, 4)
    assert [laddered._pad_target(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    m, c = plain.predict_array(images)
    for engine in (plain, laddered):
        one = [engine.predict_array(images[i:i + 1]) for i in range(7)]
        np.testing.assert_array_equal(np.concatenate([o[0] for o in one]), m)
        np.testing.assert_allclose(np.concatenate([o[1] for o in one]), c, rtol=1e-6)
    m0, c0 = plain.predict_array(np.zeros((0, 32, 32, 3), np.uint8))
    assert m0.shape == (0, 32, 32) and c0.shape == (0,)
    with pytest.raises(ValueError, match="exceeds"):
        _seg_port(seg, bucket_sizes=(8,))


def test_predict_paths_equals_predict_array_and_decode_policy(seg, tmp_path):
    images = _images(6, n=5)
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / f"img_{i}.png"))
        Image.fromarray(im).save(paths[-1])
    pred = _seg_port(seg)
    m, c = pred.predict_array(images)
    pm, pc = pred.predict_paths(paths, num_workers=2)
    np.testing.assert_array_equal(pm, m)
    np.testing.assert_array_equal(pc, c)
    bad = str(tmp_path / "broken.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(DecodeError) as e:
        pred.predict_paths(paths + [bad])
    assert e.value.path == bad
    sm, sc, failed = pred.predict_paths(paths + [bad], on_decode_error="skip",
                                        return_failed=True)
    assert failed == [5] and np.isnan(sc[5]) and (sm[5] == 0).all()
    np.testing.assert_array_equal(sm[:5], m)
    em, ec, ef = pred.predict_paths([], return_failed=True)
    assert em.shape == (0, 32, 32) and ec.shape == (0,) and ef == []


def test_heads_validation_pruned_notice_and_multi_device(capsys):
    sd = seeded_state_dict("unetpp", 7, n_classes=C, base_features=4, deep_supervision=True)
    with pytest.raises(ValueError, match="heads"):
        SegmentationPredictor.from_state_dict(sd, model_name="unetpp", heads=2,
                                              device="cpu", **KW)
    SegmentationPredictor.from_state_dict(sd, model_name="unetpp", deep_supervision=True,
                                          heads=2, device="cpu", **KW)
    assert "pruned fast mode: serving the single head X[0][2]" in capsys.readouterr().out
    for flags in ({"n_devices": 2}, {"n_space": 2}):
        with pytest.raises(NotImplementedError, match="item 7"):
            SegmentationPredictor.from_state_dict(sd, model_name="unetpp",
                                                  deep_supervision=True, device="cpu",
                                                  **KW, **flags)
    with pytest.raises(ValueError, match="int8"):
        SegmentationPredictor.from_state_dict(sd, model_name="unet", quantize="int8",
                                              device="cpu", **KW)


def test_tiled_predictor_matches_jax(seg):
    """32x32 tiles over 48x64 images, overlap 16, f32: masks as
    test_f32_matches_jax holds them (here: no pixel differs) and confidences to
    rtol 1e-5; a tile the size of the image equals the untiled engine exactly."""
    v = jax_variables(seg["sd"], "seg_unet")
    kw = dict(KW, image_size_hw=(48, 64), precision="f32", tile_hw=(32, 32), tile_overlap=16)
    images = _images(8, n=3, hw=(48, 64))
    want_m, want_c = JaxPredictor.from_variables(
        v["params"], v["batch_stats"], **kw).predict_array(images)
    got_m, got_c = SegmentationPredictor.from_state_dict(
        seg["sd"], device="cpu", **kw).predict_array(images)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5)
    one = _seg_port(seg, tile_hw=(32, 32), tile_overlap=16).predict_array(_images(9))
    plain = _seg_port(seg).predict_array(_images(9))
    np.testing.assert_array_equal(one[0], plain[0])
    np.testing.assert_array_equal(one[1], plain[1])


def test_from_checkpoint_throughput_latency_and_no_gpu(seg, tmp_path):
    pth = str(tmp_path / "best_model.pth")
    torch.save({"model_state_dict": seg["sd"]}, pth)
    pred = SegmentationPredictor.from_checkpoint(pth, device="cpu", precision="f32",
                                                 **{**KW, "batch_size": 2})
    images = _images(10, n=3)
    np.testing.assert_array_equal(pred.predict_array(images)[0],
                                  _seg_port(seg).predict_array(images)[0])
    assert pred.throughput(n_batches=2) > 0
    lat = pred.latency_ms(n_iters=2)
    assert set(lat) == {"p50_ms", "p95_ms", "mean_ms"} and lat["p50_ms"] > 0
    pred.warmup()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            SegmentationPredictor.from_state_dict(seg["sd"], **KW)
