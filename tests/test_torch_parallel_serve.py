"""The serving engines with one replica per device (``n_devices`` /
``devices``) on the CPU: each batch splits into contiguous chunks, one per
replica, and the outputs come back in order. Two replicas on ("cpu", "cpu")
give the single engine's outputs (int8 bit for bit; f32 to rtol 1e-5, the
replicas running half batches), tiled or not; the batch and its buckets
must split over the replicas; an artifact is refused for a multi-device
engine. Also the JAX engine's refusals at the same flags."""

import numpy as np
import pytest

from _torch_parity import jax_variables, one_torch_thread, seeded_state_dict  # noqa: F401
from tpu_unet.serve import AnomalyScorer as JaxScorer
from tpu_unet_torch.serve import AnomalyScorer, SegmentationPredictor
from tpu_unet_torch.serve_artifact import export_artifact

C = 4
SEG_KW = dict(num_classes=C, image_size_hw=(32, 32), batch_size=4, base_features=4,
              precision="f32")


def _images(seed, n=6, hw=(32, 32)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def anomaly_sd():
    return seeded_state_dict("anomaly_unet", 41, base_features=4)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_two_scorer_replicas_equal_the_single_engine(anomaly_sd, quantize):
    kw = dict(image_size=32, batch_size=4, precision="f32", base_features=4,
              quantize=quantize, calib_images=_images(1, n=8), with_heatmap=True,
              bucket_sizes=(2,), device="cpu")
    one = AnomalyScorer.from_state_dict(anomaly_sd, **kw)
    two = AnomalyScorer.from_state_dict(anomaly_sd, n_devices=2, **kw)
    named = AnomalyScorer.from_state_dict(anomaly_sd, devices=("cpu", "cpu"),
                                          **{k: v for k, v in kw.items() if k != "device"})
    assert len(one.devices) == 1 and len(two.devices) == len(named.devices) == 2
    images = _images(2, n=7)  # a full batch, then 3 rows padded to the bucket of 4
    want = one.score_array(images)
    want_s, want_m = one.heatmap_array(images)
    for engine in (two, named):
        got = engine.score_array(images)
        got_s, got_m = engine.heatmap_array(images)
        if quantize:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got_m, want_m)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5)
            np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
            assert np.mean(got_m != want_m) < 1e-3  # uint8 heatmaps: rounding ties
    assert two.score_array(images[:1]).shape == (1,)  # bucket 2, one row per replica


def test_two_predictor_replicas_equal_the_single_engine_tiled():
    """Tiled inference (32 x 32 tiles over 48 x 64 images) composes with the
    replicas: each replica tiles its chunk. It does not compose with
    ``n_space``, as in the JAX predictor."""
    sd = seeded_state_dict("seg_unet", 43, n_classes=C, base_features=4)
    kw = dict(SEG_KW, image_size_hw=(48, 64), tile_hw=(32, 32), tile_overlap=16, device="cpu")
    one = SegmentationPredictor.from_state_dict(sd, **kw)
    two = SegmentationPredictor.from_state_dict(sd, n_devices=2, **kw)
    images = _images(3, n=5, hw=(48, 64))
    m1, c1 = one.predict_array(images)
    m2, c2 = two.predict_array(images)
    assert np.mean(m1 != m2) < 1e-3
    np.testing.assert_allclose(c2, c1, rtol=1e-5)
    with pytest.raises(ValueError, match="tiled inference does not compose with --n_space"):
        SegmentationPredictor.from_state_dict(sd, n_space=2, **kw)


def test_the_batch_and_buckets_must_split_over_the_replicas(anomaly_sd):
    """As in the JAX engine: the serving batch and every bucket divide by
    the replica count; a count that disagrees with the devices given
    raises."""
    v = jax_variables(anomaly_sd, "anomaly_unet")
    kw = dict(image_size=32, precision="f32", base_features=4)
    for bad in ({"batch_size": 3}, {"batch_size": 4, "bucket_sizes": (1,)}):
        with pytest.raises(ValueError, match="divisible"):
            AnomalyScorer.from_state_dict(anomaly_sd, n_devices=2, device="cpu", **kw, **bad)
        with pytest.raises(ValueError, match="divisible"):
            JaxScorer.from_variables(v["params"], v["batch_stats"], n_devices=2, **kw, **bad)
    with pytest.raises(ValueError, match="devices given"):
        AnomalyScorer.from_state_dict(anomaly_sd, n_devices=3, devices=("cpu", "cpu"),
                                      batch_size=4, **kw)


def test_export_artifact_refuses_a_multi_device_engine(anomaly_sd, tmp_path):
    two = AnomalyScorer.from_state_dict(anomaly_sd, image_size=32, batch_size=4,
                                        precision="f32", base_features=4, n_devices=2,
                                        device="cpu")
    with pytest.raises(ValueError, match="per-device"):
        export_artifact(two, str(tmp_path / "art"))
    assert not (tmp_path / "art").exists()
