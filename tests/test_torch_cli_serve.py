"""The port's serve CLIs on the CPU: cli/serve_seg.py against the JAX CLI's
output writer on the JAX engine with the same weights, tiling, int8 with
saved qparams, --export_artifact and --artifact on serve_seg and
serve_mvtec, and cli/serve_daemon.py's build_service and SIGTERM shutdown."""

import argparse
import http.client
import io
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import jax_variables, one_torch_thread, seeded_state_dict  # noqa: F401
from tpu_unet_torch.cli import serve_daemon, serve_mvtec, serve_seg

BASE = ["--base_features", "4", "--batch_size", "4", "--device", "cpu"]


def _write_pngs(root, images, prefix="img"):
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, im in enumerate(images):
        paths.append(os.path.join(root, f"{prefix}_{i:02d}.png"))
        Image.fromarray(im).save(paths[-1])
    return paths


def _images(seed, n=5, hw=(32, 32)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def seg_ckpt(tmp_path_factory):
    sd = seeded_state_dict("seg_unet", 31, n_classes=4, base_features=4)
    root = tmp_path_factory.mktemp("seg")
    pth = str(root / "best_model.pth")
    torch.save({"model_state_dict": sd, "epoch": 3}, pth)
    return sd, pth


def _masks(out_dir, payload):
    return {rel: np.asarray(Image.open(os.path.join(out_dir, r["mask"])))
            for rel, r in payload["predictions"].items() if r["mask"]}


def test_serve_seg_matches_the_jax_cli_writer(seg_ckpt, tmp_path):
    """f32, a corrupt file skipped: the port CLI's predictions.json and mask
    PNGs against the JAX CLI's writer (its _predict_and_save) run on the JAX
    engine with the same weights: the same records, masks and decode
    failures, confidences to rtol 1e-5."""
    from tpu_unet.cli import serve_seg as jax_serve_seg
    from tpu_unet.serve import SegmentationPredictor as JaxPredictor

    sd, pth = seg_ckpt
    root = str(tmp_path / "in")
    _write_pngs(root, _images(1))
    with open(os.path.join(root, "zz_broken.png"), "wb") as f:
        f.write(b"not a png")
    flags = ["--input_dir", root, "--image_height", "32", "--image_width", "32",
             "--precision", "f32", "--on_decode_error", "skip", "--num_workers", "2"]
    got = serve_seg.main(["--checkpoint", pth, "--output_dir", str(tmp_path / "port")]
                         + flags + BASE)
    with open(tmp_path / "port" / "predictions.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))

    v = jax_variables(sd, "seg_unet")
    jpred = JaxPredictor.from_variables(v["params"], v["batch_stats"], num_classes=4,
                                        image_size_hw=(32, 32), batch_size=4,
                                        precision="f32", base_features=4)
    jargs = argparse.Namespace(num_classes=4, num_workers=2, on_decode_error="skip",
                               input_dir=root, output_dir=str(tmp_path / "jax"),
                               checkpoint=pth, artifact=None)
    from tpu_unet.utils.io import list_images
    want = jax_serve_seg._predict_and_save(jargs, jpred, list_images(root))
    for key in ("checkpoint", "quantize", "image_size_hw", "num_classes", "decode_failures"):
        assert got[key] == want[key], key
    assert set(got["predictions"]) == set(want["predictions"])
    for rel, w in want["predictions"].items():
        g = got["predictions"][rel]
        assert g["mask"] == w["mask"] and g["class_pixel_share"] == w["class_pixel_share"]
        if w["mean_confidence"] is None:
            assert g == w
        else:
            assert g["mean_confidence"] == pytest.approx(w["mean_confidence"], rel=1e-5)
    gm, wm = _masks(tmp_path / "port", got), _masks(tmp_path / "jax", want)
    assert set(gm) == set(wm) and all(np.array_equal(gm[k], wm[k]) for k in gm)


def test_serve_seg_tiles_int8_qparams_and_artifact(seg_ckpt, tmp_path):
    """Tiled int8 (32x32 tiles over 48x40 inputs): calibrate and save
    --qparams, reload them, export an artifact, and serve it with
    --artifact: every run writes the same masks."""
    _, pth = seg_ckpt
    root, calib = str(tmp_path / "in"), str(tmp_path / "calib")
    _write_pngs(root, _images(2, hw=(48, 40)))
    _write_pngs(calib, _images(3, n=8, hw=(32, 32)))
    qpath, art = str(tmp_path / "q.npz"), str(tmp_path / "art")
    geometry = ["--image_height", "48", "--image_width", "40", "--tile_height", "32",
                "--tile_width", "32", "--tile_overlap", "8", "--quantize", "int8"]
    first = serve_seg.main(["--checkpoint", pth, "--input_dir", root, "--calib_dir", calib,
                            "--qparams", qpath, "--output_dir", str(tmp_path / "a"),
                            "--export_artifact", art, "--bucket_sizes", "1,2"]
                           + geometry + BASE)
    assert os.path.exists(qpath) and first["quantize"] == "int8"
    assert first["image_size_hw"] == [48, 40]
    again = serve_seg.main(["--checkpoint", pth, "--input_dir", root, "--qparams", qpath,
                            "--output_dir", str(tmp_path / "b")] + geometry + BASE)
    served = serve_seg.main(["--artifact", art, "--input_dir", root, "--device", "cpu",
                             "--output_dir", str(tmp_path / "c")])
    assert served["checkpoint"] == art and served["quantize"] == "int8"
    ref = _masks(tmp_path / "a", first)
    for out, payload in (("b", again), ("c", served)):
        m = _masks(tmp_path / out, payload)
        assert all(np.array_equal(m[k], ref[k]) for k in ref)


@pytest.mark.parametrize("flags,error", [
    (["--artifact", "ART", "--batch_size", "8"], SystemExit),        # fixed by the artifact
    (["--artifact", "ART", "--tile_height", "32"], SystemExit),
    (["--artifact", "ART", "--checkpoint", "CKPT"], SystemExit),
    (["--artifact", "ART", "--export_artifact", "X"], SystemExit),
    (["--checkpoint", "CKPT", "--tile_height", "32"], SystemExit),   # without --tile_width
    (["--checkpoint", "CKPT", "--export_artifact", "X", "--artifact_platforms", "tpu,cpu"],
     SystemExit),
    (["--checkpoint", "CKPT", "--n_devices", "3"], ValueError),      # batch 4 over 3 replicas
    (["--checkpoint", "CKPT", "--n_space", "3"], ValueError),        # 3 does not divide 32
    (["--checkpoint", "CKPT", "--n_space", "2", "--export_artifact", "X"], SystemExit),
    (["--checkpoint", "CKPT", "--bucket_sizes", "8"], SystemExit),  # above --batch_size 4
])
def test_serve_seg_flag_checks(seg_ckpt, tmp_path, flags, error):
    _, pth = seg_ckpt
    root = str(tmp_path / "in")
    _write_pngs(root, _images(4, n=1))
    flags = [pth if f == "CKPT" else str(tmp_path / f) if f in ("ART", "X") else f
             for f in flags]
    if "--artifact" in flags:
        os.makedirs(tmp_path / "ART")
    with pytest.raises(error):
        serve_seg.main(flags + ["--input_dir", root, "--image_height", "32",
                                "--image_width", "32", "--output_dir", str(tmp_path / "o")]
                       + (BASE if "--artifact" not in flags else ["--device", "cpu"]))


def test_serve_seg_with_n_space_writes_the_one_device_masks(seg_ckpt, tmp_path):
    """``--n_space 2``: one replica over two CPU "devices", each thread on
    16 of the 32 rows; the same masks and predictions.json as one device."""
    _, pth = seg_ckpt
    root = str(tmp_path / "in")
    _write_pngs(root, _images(6, n=5))
    flags = ["--checkpoint", pth, "--input_dir", root, "--image_height", "32",
             "--image_width", "32", "--precision", "f32"] + BASE
    rows = serve_seg.main(flags + ["--n_space", "2", "--output_dir", str(tmp_path / "rows")])
    one = serve_seg.main(flags + ["--output_dir", str(tmp_path / "one")])
    m_rows, m_one = _masks(tmp_path / "rows", rows), _masks(tmp_path / "one", one)
    assert set(m_rows) == set(m_one) and all(np.array_equal(m_rows[k], m_one[k])
                                             for k in m_one)
    for rel, w in one["predictions"].items():
        g = rows["predictions"][rel]
        assert g["class_pixel_share"] == w["class_pixel_share"]
        assert g["mean_confidence"] == pytest.approx(w["mean_confidence"], rel=2e-5)


def test_serve_seg_n_space_4_at_uneven_levels_writes_the_one_device_masks(seg_ckpt, tmp_path):
    """``--n_space 4`` at 32 rows, once refused: 8-row blocks, then 4, 2, 1
    and a bottleneck of 1/1/0/0 rows; int8, bit for bit one device's
    masks and confidences."""
    _, pth = seg_ckpt
    root, calib = str(tmp_path / "in"), str(tmp_path / "calib")
    _write_pngs(root, _images(4, n=3))
    _write_pngs(calib, _images(5, n=4))
    flags = ["--checkpoint", pth, "--input_dir", root, "--image_height", "32",
             "--image_width", "32", "--quantize", "int8", "--calib_dir", calib] + BASE
    rows = serve_seg.main(flags + ["--n_space", "4", "--output_dir", str(tmp_path / "rows")])
    one = serve_seg.main(flags + ["--output_dir", str(tmp_path / "one")])
    m_rows, m_one = _masks(tmp_path / "rows", rows), _masks(tmp_path / "one", one)
    assert set(m_rows) == set(m_one) and all(np.array_equal(m_rows[k], m_one[k])
                                             for k in m_one)
    assert rows["predictions"] == one["predictions"]


@pytest.fixture(scope="module")
def anomaly_ckpt(tmp_path_factory):
    sd = seeded_state_dict("anomaly_unet", 32, base_features=4)
    pth = str(tmp_path_factory.mktemp("an") / "best_model.pth")
    torch.save({"model_state_dict": sd}, pth)
    return sd, pth


def test_serve_mvtec_export_and_artifact(anomaly_ckpt, tmp_path):
    _, pth = anomaly_ckpt
    root = str(tmp_path / "in")
    _write_pngs(root, _images(5, n=6))
    art = str(tmp_path / "art")
    flags = ["--input_dir", root, "--image_size", "32"]
    first = serve_mvtec.main(["--checkpoint", pth, "--precision", "f32", "--export_artifact",
                              art, "--bucket_sizes", "1,2", "--output",
                              str(tmp_path / "a.json")] + flags + BASE)
    served = serve_mvtec.main(["--artifact", art, "--input_dir", root, "--device", "cpu",
                               "--output", str(tmp_path / "b.json")])
    assert served["scores"] == first["scores"] and served["checkpoint"] == art
    with open(os.path.join(art, "meta.json")) as f:
        assert json.load(f)["bucket_sizes"] == [1, 2, 4]
    with pytest.raises(SystemExit, match="heatmap"):
        serve_mvtec.main(["--artifact", art, "--input_dir", root, "--device", "cpu",
                          "--heatmap_dir", str(tmp_path / "hm")])
    with pytest.raises(SystemExit, match="--precision"):
        serve_mvtec.main(["--artifact", art, "--input_dir", root, "--device", "cpu",
                          "--precision", "f32"])
    with pytest.raises(SystemExit, match="exactly one"):
        serve_mvtec.main(flags + ["--device", "cpu"])
    # --n_devices: one replica per device (here two on the CPU), each batch
    # split between them; a batch that does not split raises.
    two = serve_mvtec.main(["--checkpoint", pth, "--precision", "f32", "--n_devices", "2",
                            "--output", str(tmp_path / "c.json")] + flags + BASE)
    assert list(two["scores"]) == list(first["scores"])
    np.testing.assert_allclose(list(two["scores"].values()), list(first["scores"].values()),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        serve_mvtec.main(["--checkpoint", pth, "--n_devices", "3"] + flags + BASE)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_build_service_from_checkpoint_and_artifact(anomaly_ckpt, seg_ckpt, tmp_path):
    from tpu_unet_torch.serve import AnomalyScorer
    from tpu_unet_torch.serve_artifact import export_artifact

    sd, pth = anomaly_ckpt
    args, parser = serve_daemon.parse_args(
        ["--task", "anomaly", "--checkpoint", pth, "--image_size", "32", "--precision", "f32",
         "--heatmap", "--bucket_sizes", "1,2", "--max_wait_ms", "0"] + BASE)
    svc = serve_daemon.build_service(args, parser)
    img = _images(6, n=1)[0]
    try:
        assert svc.kind == "anomaly_scorer" and svc.heatmap_batcher is not None
        assert svc.engine.bucket_sizes == (1, 2, 4)
        want = float(svc.engine.score_array(img[None])[0])
        assert svc.handle("/v1/score", _png(img))["score"] == want
    finally:
        svc.close()

    scorer = AnomalyScorer.from_state_dict(sd, image_size=32, batch_size=2, base_features=4,
                                           precision="f32", device="cpu")
    art = str(tmp_path / "art")
    export_artifact(scorer, art)
    args, parser = serve_daemon.parse_args(["--artifact", art, "--max_wait_ms", "0",
                                            "--device", "cpu"])
    svc = serve_daemon.build_service(args, parser)
    try:
        assert svc.kind == "anomaly_scorer" and svc.size_hw == (32, 32)
        assert svc.handle("/v1/score", _png(img))["score"] == float(
            scorer.score_array(img[None])[0])
    finally:
        svc.close()

    _, seg_pth = seg_ckpt
    args, parser = serve_daemon.parse_args(
        ["--task", "seg", "--checkpoint", seg_pth, "--image_height", "32", "--image_width",
         "32", "--precision", "f32", "--max_queue", "8"] + BASE)
    svc = serve_daemon.build_service(args, parser)
    try:
        r = svc.handle("/v1/predict", _png(img))
        m, c = svc.engine.predict_array(img[None])
        assert r["mean_confidence"] == float(c[0]) and svc.batcher.max_queue == 8
    finally:
        svc.close()


@pytest.mark.parametrize("flags", [
    ["--checkpoint", "CKPT"],                                    # no --task
    ["--task", "seg", "--checkpoint", "CKPT", "--heatmap"],
    ["--task", "anomaly", "--checkpoint", "CKPT", "--model", "unetpp"],
    ["--task", "anomaly", "--checkpoint", "CKPT", "--max_queue", "-1"],
    ["--task", "anomaly", "--checkpoint", "CKPT", "--request_timeout_s", "0"],
    ["--artifact", "ART", "--task", "seg"],                      # fixed by the artifact
    ["--task", "anomaly", "--checkpoint", "CKPT", "--bucket_sizes", "a,b"],
])
def test_build_service_flag_checks(anomaly_ckpt, tmp_path, flags):
    _, pth = anomaly_ckpt
    os.makedirs(tmp_path / "ART")
    flags = [pth if f == "CKPT" else str(tmp_path / "ART") if f == "ART" else f for f in flags]
    args, parser = serve_daemon.parse_args(flags + ["--image_size", "32", "--device", "cpu"]
                                           + (["--base_features", "4"]
                                              if "--artifact" not in flags else []))
    with pytest.raises(SystemExit):
        serve_daemon.build_service(args, parser)


def test_sigterm_shuts_the_daemon_down_cleanly(anomaly_ckpt):
    """SIGTERM ends serve_until_signal: a request that landed before it is
    answered, the batcher is closed, and the previous handler is back."""
    from tpu_unet_torch.serve import AnomalyScorer
    from tpu_unet_torch.serve_http import ServingService, make_server

    sd, _ = anomaly_ckpt
    scorer = AnomalyScorer.from_state_dict(sd, image_size=32, batch_size=2, base_features=4,
                                           precision="f32", device="cpu")
    svc = ServingService(scorer, max_wait_ms=0)
    server = make_server(svc, port=0)
    port = server.server_address[1]
    results = {}

    def client():
        time.sleep(0.3)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/v1/score", body=_png(np.zeros((32, 32, 3), np.uint8)))
            r = conn.getresponse()
            results["status"], results["body"] = r.status, json.loads(r.read())
        finally:
            conn.close()
        os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=client, daemon=True)
    t.start()
    serve_daemon.serve_until_signal(server, svc)
    t.join(timeout=30)
    assert results.get("status") == 200 and np.isfinite(results["body"]["score"])
    with pytest.raises(RuntimeError, match="closed"):
        svc.batcher.submit(np.zeros((32, 32, 3), np.uint8))
    assert signal.getsignal(signal.SIGTERM) == before
