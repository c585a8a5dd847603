"""The port's serving artifacts (tpu_unet_torch/serve_artifact.py) on the
CPU: torch.export programs over one weights file, loaded without the model
code; outputs bit-equal to the live engine's (f32 and int8, bucketed and
not, the heatmap program, tiling); meta.json with the JAX package's keys
and its platforms; corrupt directories, tpu, a platform the artifact has no
programs for, and replica engines refused; an artifact of the earlier
format (one device, no platform in the program names) and one whose CPU
programs sit beside another device's load on the CPU."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, one_torch_thread, seeded_state_dict  # noqa: F401
from tpu_unet_torch.serve import AnomalyScorer, SegmentationPredictor
from tpu_unet_torch.serve_artifact import export_artifact, load_artifact
from tpu_unet_torch.serve_http import ServingService


def _images(seed, n=5, hw=(32, 32)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def anomaly_sd():
    return seeded_state_dict("anomaly_unet", 21, base_features=4)


@pytest.fixture(scope="module")
def seg_sd():
    return seeded_state_dict("seg_unet", 22, n_classes=4, base_features=4)


def _anomaly(sd, **kw):
    return AnomalyScorer.from_state_dict(sd, image_size=32, batch_size=4, base_features=4,
                                         device="cpu", **kw)


def _seg(sd, **kw):
    kw = {"image_size_hw": (32, 32), **kw}
    return SegmentationPredictor.from_state_dict(sd, num_classes=4, batch_size=4,
                                                 base_features=4, device="cpu", **kw)


ANOMALY_CASES = {
    "f32_buckets_heatmap": dict(precision="f32", with_heatmap=True, bucket_sizes=(1, 2)),
    "int8": dict(quantize="int8"),
}
SEG_CASES = {
    "f32": dict(precision="f32"),
    "bf16_buckets": dict(precision="bf16", bucket_sizes=(2,)),
    "int8_buckets": dict(quantize="int8", bucket_sizes=(1,)),
    "int8_tiled": dict(quantize="int8", image_size_hw=(48, 40), tile_hw=(32, 32),
                       tile_overlap=8),
}


def _program_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".pt2"))


@pytest.mark.parametrize("case", list(ANOMALY_CASES))
def test_anomaly_artifact_outputs_equal_the_live_engine(anomaly_sd, case, tmp_path):
    kw = dict(ANOMALY_CASES[case])
    if kw.get("quantize"):
        kw["calib_images"] = _images(30, n=8)
    live = _anomaly(anomaly_sd, **kw)
    meta = export_artifact(live, str(tmp_path))
    loaded = load_artifact(str(tmp_path), device="cpu")
    assert isinstance(loaded, AnomalyScorer) and loaded.quantize == live.quantize
    assert loaded.bucket_sizes == live.bucket_sizes and loaded.has_heatmap == live.has_heatmap
    images = _images(1, n=7)  # a full and a ragged batch
    np.testing.assert_array_equal(loaded.score_array(images), live.score_array(images))
    if live.has_heatmap:
        for a, b in zip(loaded.heatmap_array(images), live.heatmap_array(images)):
            np.testing.assert_array_equal(a, b)
        assert _program_files(tmp_path) == [f"{stem}_b{b}.pt2" for stem in ("heatmap", "program")
                                            for b in (1, 2, 4)]
    assert meta["device"] == "cpu" and meta["image_size_hw"] == [32, 32]


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_seg_artifact_outputs_equal_the_live_engine(seg_sd, case, tmp_path):
    kw = dict(SEG_CASES[case])
    hw = kw.get("image_size_hw", (32, 32))
    if kw.get("quantize"):
        kw["calib_images"] = _images(31, n=8)
    live = _seg(seg_sd, **kw)
    export_artifact(live, str(tmp_path))
    loaded = load_artifact(str(tmp_path), device="cpu")
    assert isinstance(loaded, SegmentationPredictor) and loaded.image_size_hw == hw
    assert loaded.num_classes == 4 and loaded.quantize == live.quantize
    images = _images(2, n=5, hw=hw)
    for a, b in zip(loaded.predict_array(images), live.predict_array(images)):
        np.testing.assert_array_equal(a, b)
    buckets = live.bucket_sizes or (4,)
    assert _program_files(tmp_path) == sorted(f"program_b{b}.pt2" for b in buckets)


def test_weights_are_stored_once_and_programs_hold_the_kernels(seg_sd, tmp_path):
    """A three-bucket int8 artifact: one weights file (K2's packed kernels
    among its tensors); programs that hold no tensor of their own and call
    both kernel operators."""
    live = _seg(seg_sd, quantize="int8", calib_images=_images(32, n=8), bucket_sizes=(1, 2))
    export_artifact(live, str(tmp_path))
    for name in _program_files(tmp_path):
        program = torch.export.load(str(tmp_path / name))
        assert not program.state_dict and not program.constants
        targets = {str(n.target) for n in program.graph.nodes}
        assert {"tpu_unet_torch.normalize_u8.default",
                "tpu_unet_torch.conv3x3_int8.default"} <= targets
    state = torch.load(tmp_path / "weights.pt", weights_only=True)
    assert set(state) == {"scales", "consts", "gates"}
    assert all(c["kernel"].dtype == torch.int8 for p, c in state["consts"].items()
               if "conv" in p and "outc" not in p)


def test_meta_has_the_jax_keys(anomaly_sd, seg_sd, tmp_path):
    """meta.json carries the JAX package's keys for the same engine (each
    present where the JAX package writes it), plus the device."""
    from tpu_unet import serve as jserve
    from tpu_unet.serve_artifact import export_artifact as jax_export

    v = jax_variables(seg_sd, "seg_unet")
    kw = dict(num_classes=4, image_size_hw=(32, 32), batch_size=4, base_features=4,
              precision="f32", bucket_sizes=(2,))
    want = jax_export(jserve.SegmentationPredictor.from_variables(
        v["params"], v["batch_stats"], **kw), str(tmp_path / "jax"))
    got = export_artifact(SegmentationPredictor.from_state_dict(seg_sd, device="cpu", **kw),
                          str(tmp_path / "port"))
    assert set(want) - {"jax_version"} <= set(got)
    assert set(got) - set(want) == {"device", "torch_version"}
    for key in ("kind", "batch_size", "image_size_hw", "num_classes", "bucket_sizes"):
        assert got[key] == want[key]
    with open(tmp_path / "port" / "meta.json") as f:
        assert json.load(f) == got
    with pytest.raises(ValueError, match="JAX package"):
        load_artifact(str(tmp_path / "jax"), device="cpu")


def test_corrupt_directories_other_devices_and_platforms_raise(anomaly_sd, tmp_path):
    live = _anomaly(anomaly_sd, precision="f32")
    good = str(tmp_path / "good")
    export_artifact(live, good)
    with pytest.raises(FileNotFoundError, match="not a serving artifact"):
        load_artifact(str(tmp_path), device="cpu")
    for missing in ("weights.pt", "program_b4.pt2"):
        bad = str(tmp_path / f"no_{missing}")
        shutil.copytree(good, bad)
        os.remove(os.path.join(bad, missing))
        with pytest.raises(FileNotFoundError, match="corrupt"):
            load_artifact(bad, device="cpu")
    bad = str(tmp_path / "version")
    shutil.copytree(good, bad)
    with open(os.path.join(bad, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(bad, "meta.json"), "w") as f:
        json.dump({**meta, "format_version": 99}, f)
    with pytest.raises(ValueError, match="format_version"):
        load_artifact(bad, device="cpu")
    with pytest.raises(ValueError, match=r"exported on cpu with programs for the platforms "
                                         r"\['cpu'\]; it has none for cuda"):
        load_artifact(good, device="cuda")  # never moved at load
    with pytest.raises(ValueError, match="'tpu' is refused.*JAX package"):
        export_artifact(live, str(tmp_path / "multi"), platforms=["tpu", "cpu"])
    with pytest.raises(ValueError, match="unknown platform"):
        export_artifact(live, str(tmp_path / "multi"), platforms=["metal"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="GPU"):
            export_artifact(live, str(tmp_path / "multi"), platforms=["cpu", "gpu"])
    assert not os.path.exists(tmp_path / "multi")  # refused before writing
    meta = export_artifact(live, str(tmp_path / "named"), platforms=["CPU", "cpu"])
    assert meta["platforms"] == ["cpu"] and _program_files(tmp_path / "named") == [
        "program_b4.pt2"]
    with pytest.raises(ValueError, match="loaded from an artifact"):
        export_artifact(load_artifact(good, device="cpu"), str(tmp_path / "again"))


def test_loaded_artifact_serves_through_the_service(seg_sd, tmp_path):
    import io

    from PIL import Image

    live = _seg(seg_sd, precision="f32", bucket_sizes=(1,))
    export_artifact(live, str(tmp_path))
    service = ServingService(load_artifact(str(tmp_path), device="cpu"), max_wait_ms=1)
    try:
        img = _images(3, n=1)[0]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        r = service.handle("/v1/predict", buf.getvalue())
        m, c = live.predict_array(img[None])
        assert r["mean_confidence"] == float(c[0])
        assert service.meta()["bucket_sizes"] == [1, 4]
    finally:
        service.close()


def test_replica_engines_are_refused(anomaly_sd, tmp_path):
    two = _anomaly(anomaly_sd, precision="f32", devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="per-device programs"):
        export_artifact(two, str(tmp_path))


def _by_hand(engine, out_dir, meta, program_name):
    """An artifact written without ``export_artifact``: the engine's
    weights, one traced program per bucket under ``program_name(b)`` and
    ``meta`` as given."""
    from tpu_unet_torch.serve_artifact import _clone_tree, _Program

    os.makedirs(out_dir)
    with engine._serving():
        engine._predict_fn(torch.zeros((4, 32, 32, 3), dtype=torch.uint8))
    params_fn, bind = engine._export_state
    params = _clone_tree(params_fn())
    torch.save(params, os.path.join(out_dir, "weights.pt"))
    for b in engine.bucket_sizes or (engine.batch_size,):
        program = torch.export.export(
            _Program(engine._predict_fn, bind),
            (params, torch.zeros((b, 32, 32, 3), dtype=torch.uint8)), strict=False)
        program.example_inputs = None
        torch.export.save(program, os.path.join(out_dir, program_name(b)))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


EARLIER_META = {"format_version": 1, "kind": "segmentation_predictor", "batch_size": 4,
            "image_size_hw": [32, 32], "device": "cpu", "platforms": ["cpu"],
            "torch_version": "2.11.0", "num_classes": 4, "quantize": "int8",
            "bucket_sizes": [2, 4]}


@pytest.mark.parametrize("layout", ["earlier", "earlier_without_platforms", "cpu_beside_cuda"])
def test_artifacts_of_other_layouts_load_on_the_cpu(seg_sd, layout, tmp_path):
    """The earlier format (programs ``program_b<N>.pt2`` of the one device;
    also without ``platforms``, which it always wrote), and a cuda-exported
    artifact's CPU programs (``program_cpu_b<N>.pt2``, the cuda ones absent
    here): served on the CPU bit for bit the live engine."""
    live = _seg(seg_sd, quantize="int8", calib_images=_images(33, n=8), bucket_sizes=(2,))
    meta = dict(EARLIER_META)
    name = lambda b: f"program_b{b}.pt2"  # noqa: E731
    if layout == "earlier_without_platforms":
        del meta["platforms"]
    elif layout == "cpu_beside_cuda":
        meta.update(device="cuda", platforms=["cuda", "cpu"])
        name = lambda b: f"program_cpu_b{b}.pt2"  # noqa: E731
    art = str(tmp_path / "art")
    _by_hand(live, art, meta, name)
    loaded = load_artifact(art, device="cpu")
    images = _images(6, n=7)
    for a, b in zip(loaded.predict_array(images), live.predict_array(images)):
        np.testing.assert_array_equal(a, b)
