"""The port's serving engine and CLI (tpu_unet_torch/serve.py,
cli/serve_mvtec.py) against tpu_unet.serve.AnomalyScorer, on the CPU at
base_features=4, 32 px, batch 4. The same weights go to both packages through
utils/weights.py (or a .pth written by the JAX package's exporter)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_models import u8_images, warmed_variables
from tpu_unet.models import AnomalyUNet
from tpu_unet.serve import AnomalyScorer as JaxScorer
from tpu_unet_torch.serve import AnomalyScorer, DecodeError
from tpu_unet_torch.utils.weights import qparams_from_numpy, state_dict_from_jax

KW = dict(image_size=32, batch_size=4, base_features=4)


@pytest.fixture(scope="module")
def weights():
    v = warmed_variables(AnomalyUNet(base_features=4))
    return v, state_dict_from_jax(v["params"], v["batch_stats"])


@pytest.fixture(scope="module")
def jax_qparams(weights):
    from tpu_unet.ops.quantize import chunk_calibration, quantize_from_train_state
    v, _ = weights
    calib = u8_images(40, (8, 32, 32, 3))
    return jax.device_get(quantize_from_train_state(
        "anomaly_unet", v["params"], v["batch_stats"], chunk_calibration(calib, 4)))


def _port(sd, **kw):
    return AnomalyScorer.from_state_dict(sd, device="cpu", **{**KW, **kw})


def test_f32_scores_match_jax(weights):
    v, sd = weights
    images = u8_images(1, (5, 32, 32, 3))  # 5 images at batch 4: a padded chunk
    want = JaxScorer.from_variables(v["params"], v["batch_stats"], precision="f32",
                                    **KW).score_array(images)
    got = _port(sd, precision="f32").score_array(images)
    assert got.shape == (5,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_bf16_scores_match_jax(weights):
    """bf16 keeps 8 mantissa bits (relative rounding ~4e-3) and the two
    packages round at different points (the port adds the folded BN bias to
    the bf16 conv output in f32; the JAX fold pre-scales the kernel by
    sqrt(1 + eps) and applies a residual BN). The score averages the squared
    error over 3*H*W values, so those roundings mostly cancel: rtol 1e-3."""
    v, sd = weights
    images = u8_images(2, (6, 32, 32, 3))
    want = JaxScorer.from_variables(v["params"], v["batch_stats"], precision="bf16",
                                    **KW).score_array(images)
    got = _port(sd, precision="bf16").score_array(images)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_int8_scores_match_jax_with_the_same_qparams(weights, jax_qparams):
    """Against JAX's op-by-op int8 forward (_QuantExec as written) the port's
    int8 activations are bit-exact (tests/test_torch_quantize.py), so scores
    differ only by the f32 sigmoid head and mean: rtol 1e-6. JAX's jitted
    scorer is looser: XLA's fused epilogues round differently from the
    written ops and flip about 0.5% of int8 values by one step from x4 on
    (measured against the op-by-op forward), so rtol 1e-4 there."""
    import jax.numpy as jnp

    from tpu_unet.metrics.anomaly import anomaly_score
    from tpu_unet.ops.augment import eval_transform
    from tpu_unet.ops.quantize import make_quantized_forward

    v, sd = weights
    images = u8_images(3, (6, 32, 32, 3))
    scorer = _port(sd, quantize="int8", qparams=qparams_from_numpy(jax_qparams))
    assert scorer.quantize == "int8"
    got = scorer.score_array(images)
    recon, _ = make_quantized_forward("anomaly_unet")(jax_qparams, jnp.asarray(images))
    op_by_op = np.asarray(anomaly_score(recon, eval_transform(jnp.asarray(images))))
    np.testing.assert_allclose(got, op_by_op, rtol=1e-6)
    jitted = JaxScorer.from_variables(v["params"], v["batch_stats"], quantize="int8",
                                      qparams=jax_qparams, **KW).score_array(images)
    np.testing.assert_allclose(got, jitted, rtol=1e-4)


def test_int8_calibrated_in_process_tracks_float(weights):
    _, sd = weights
    calib = u8_images(41, (8, 32, 32, 3))
    images = u8_images(4, (6, 32, 32, 3))
    q = _port(sd, quantize="int8", calib_images=calib)
    f = _port(sd, precision="f32")
    np.testing.assert_allclose(q.score_array(images), f.score_array(images), rtol=0.1)
    with pytest.raises(ValueError):
        _port(sd, quantize="int8")  # neither calib_images nor qparams


def test_padding_bucket_ladder_and_empty_input(weights):
    _, sd = weights
    images = u8_images(5, (7, 32, 32, 3))
    plain = _port(sd, precision="f32")
    laddered = _port(sd, precision="f32", bucket_sizes=(1, 2))
    assert laddered.bucket_sizes == (1, 2, 4)
    assert [laddered._pad_target(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    one_by_one = np.concatenate([plain.score_array(images[i:i + 1]) for i in range(7)])
    np.testing.assert_allclose(plain.score_array(images), one_by_one, rtol=1e-6)
    np.testing.assert_allclose(laddered.score_array(images), one_by_one, rtol=1e-6)
    assert plain.score_array(np.zeros((0, 32, 32, 3), np.uint8)).shape == (0,)
    with pytest.raises(ValueError):
        _port(sd, bucket_sizes=(8,))  # above the serving batch


def _write_pngs(root, images):
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, im in enumerate(images):
        p = os.path.join(root, f"img_{i:02d}.png")
        Image.fromarray(im).save(p)
        paths.append(p)
    return paths


def test_score_paths_equals_score_array_and_decode_policy(weights, tmp_path):
    _, sd = weights
    images = u8_images(6, (5, 32, 32, 3))
    paths = _write_pngs(str(tmp_path / "imgs"), images)  # target size: no resize
    scorer = _port(sd, precision="f32")
    np.testing.assert_array_equal(scorer.score_paths(paths, num_workers=2),
                                  scorer.score_array(images))
    assert scorer.score_paths([]).shape == (0,)

    bad = str(tmp_path / "imgs" / "broken.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(DecodeError) as e:
        scorer.score_paths(paths + [bad])
    assert e.value.path == bad
    scores, failed = scorer.score_paths(paths + [bad], on_decode_error="skip",
                                        return_failed=True)
    assert failed == [5] and np.isnan(scores[5])
    np.testing.assert_array_equal(scores[:5], scorer.score_array(images))


def test_heatmap_array_and_paths_match_jax(weights, tmp_path):
    v, sd = weights
    images = u8_images(7, (5, 32, 32, 3))
    want_s, want_m = JaxScorer.from_variables(
        v["params"], v["batch_stats"], precision="f32", with_heatmap=True,
        **KW).heatmap_array(images)
    scorer = _port(sd, precision="f32", with_heatmap=True)
    assert scorer.has_heatmap
    scores, maps = scorer.heatmap_array(images)
    assert maps.dtype == np.uint8 and maps.shape == (5, 32, 32)
    np.testing.assert_allclose(scores, want_s, rtol=1e-4)
    assert np.abs(maps.astype(int) - want_m.astype(int)).max() <= 1  # .5 rounding ties
    np.testing.assert_allclose(scores, scorer.score_array(images), rtol=1e-6)
    paths = _write_pngs(str(tmp_path / "hm"), images)
    p_scores, p_maps = scorer.heatmap_paths(paths, num_workers=2)
    np.testing.assert_array_equal(p_maps, maps)
    np.testing.assert_allclose(p_scores, scores, rtol=1e-6)
    with pytest.raises(RuntimeError):
        _port(sd, precision="f32").heatmap_array(images)


def test_cli_on_a_pth_written_by_the_jax_exporter(weights, tmp_path):
    """tpu_unet's save_torch_checkpoint writes the .pth; the port's CLI scores
    it in f32 and in int8 (calibrating, saving, then reloading --qparams).
    The .pth holds the reference's (PyTorch) convention, in which the JAX
    exporter leaves the transposed-conv kernels unflipped, so the JAX model
    the CLI reproduces is the one with those kernels flipped."""
    from tpu_unet.utils.torch_import import save_torch_checkpoint
    from tpu_unet_torch.cli.serve_mvtec import main

    v, _ = weights
    pth = str(tmp_path / "best_model.pth")
    save_torch_checkpoint(pth, v["params"], v["batch_stats"])
    images = u8_images(8, (5, 32, 32, 3))
    root = str(tmp_path / "in")
    _write_pngs(root, images)
    out = str(tmp_path / "scores.json")
    args = ["--checkpoint", pth, "--input_dir", root, "--image_size", "32",
            "--batch_size", "4", "--base_features", "4", "--device", "cpu",
            "--output", out]
    payload = main(args + ["--precision", "f32", "--threshold", "1.0"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(payload))
    assert payload["quantize"] == "none" and len(payload["scores"]) == 5
    assert set(payload["verdicts"]) == set(payload["scores"])

    flipped = jax.tree_util.tree_map(lambda a: a, v["params"])
    for dec, up in (("decoder_recon", "up_recon"), ("decoder_seg", "up_seg")):
        for i in range(1, 5):
            leaf = flipped[dec][f"{up}{i}"]["up"]
            leaf["kernel"] = np.ascontiguousarray(np.asarray(leaf["kernel"])[::-1, ::-1])
    want = JaxScorer.from_variables(flipped, v["batch_stats"], precision="f32",
                                    **KW).score_array(images)
    got = np.array([payload["scores"][f"img_{i:02d}.png"] for i in range(5)])
    np.testing.assert_allclose(got, want, rtol=1e-4)

    calib = str(tmp_path / "calib")
    _write_pngs(calib, u8_images(9, (4, 32, 32, 3)))
    qpath = str(tmp_path / "q.npz")
    first = main(args + ["--quantize", "int8", "--calib_dir", calib, "--qparams", qpath])
    assert os.path.exists(qpath) and first["quantize"] == "int8"
    again = main(args + ["--quantize", "int8", "--qparams", qpath])
    assert again["scores"] == first["scores"]


def test_default_device_without_a_gpu_raises(weights, tmp_path):
    _, sd = weights
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the default device then works")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        AnomalyScorer.from_state_dict(sd, **KW)
    from tpu_unet_torch.cli.serve_mvtec import main
    pth = str(tmp_path / "m.pth")
    torch.save({"model_state_dict": sd}, pth)
    root = str(tmp_path / "in")
    _write_pngs(root, u8_images(11, (1, 32, 32, 3)))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["--checkpoint", pth, "--input_dir", root, "--image_size", "32",
              "--base_features", "4", "--output", str(tmp_path / "s.json")])


def test_throughput_and_latency_report(weights):
    _, sd = weights
    scorer = _port(sd, precision="f32", batch_size=2)
    assert scorer.throughput(n_batches=2) > 0
    lat = scorer.latency_ms(n_iters=3)
    assert set(lat) == {"p50_ms", "p95_ms", "mean_ms"} and lat["p50_ms"] > 0
    scorer.warmup()


@pytest.fixture(scope="module")
def bilinear_weights():
    v = warmed_variables(AnomalyUNet(base_features=4, bilinear=True), key=6)
    return v, state_dict_from_jax(v["params"], v["batch_stats"], bilinear=True)


@pytest.mark.parametrize("precision,rtol", [("f32", 1e-4), ("bf16", 1e-3)])
def test_bilinear_scores_match_jax(bilinear_weights, precision, rtol):
    """AnomalyScorer(bilinear=True) against the JAX scorer on the same
    weights, at test_f32_scores_match_jax's and test_bf16_scores_match_jax's
    tolerances."""
    v, sd = bilinear_weights
    images = u8_images(7, (5, 32, 32, 3))
    want = JaxScorer.from_variables(v["params"], v["batch_stats"], precision=precision,
                                    bilinear=True, **KW).score_array(images)
    got = _port(sd, precision=precision, bilinear=True).score_array(images)
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_bilinear_int8_scores_match_jax_with_the_same_qparams(bilinear_weights):
    """int8 with JAX's qparams (the upsamples float islands): the port's
    scores against the JAX op-by-op int8 forward's to rtol 1e-6, as
    test_int8_scores_match_jax_with_the_same_qparams holds the ladder; and a
    scorer calibrated in process tracks the f32 one within 10%."""
    from tpu_unet.ops import quantize as jq
    from tpu_unet.ops.augment import eval_transform as jax_eval_transform
    from tpu_unet.metrics.anomaly import anomaly_score as jax_anomaly_score

    v, sd = bilinear_weights
    calib = u8_images(41, (8, 32, 32, 3))
    jqp = jax.device_get(jq.quantize_from_train_state(
        "anomaly_unet", v["params"], v["batch_stats"], jq.chunk_calibration(calib, 4)))
    images = u8_images(8, (4, 32, 32, 3))
    img = jax_eval_transform(images)
    recon, _ = jq._run(jq._QuantExec(jqp), img, jq.build_plan("anomaly_unet"))
    want = np.asarray(jax_anomaly_score(recon, img))
    got = _port(sd, quantize="int8", qparams=qparams_from_numpy(jqp),
                bilinear=True).score_array(images)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    f32 = _port(sd, precision="f32", bilinear=True).score_array(images)
    calibrated = _port(sd, quantize="int8", calib_images=calib,
                       bilinear=True).score_array(images)
    np.testing.assert_allclose(calibrated, f32, rtol=0.1)
