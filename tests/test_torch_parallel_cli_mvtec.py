"""The port's MVTec CLIs with ``--device cpu --n_devices 2``: two gloo ranks
spawned by the CLI (tpu_unet_torch/parallel/mesh.py::launch), on a synthetic
category (base_features=4, 32 px, a global batch of 4). The trainer writes
its files once (rank 0) and its checkpoint loads at world size 1; the
2-rank test path gathers the same per-image results as one process and as
the JAX test CLI at ``--n_devices 2`` on the same weights."""

import json
import os

import numpy as np
import pytest
import torch

import tpu_unet.cli.test_mvtec as jax_test_cli
import tpu_unet.data.transforms as jax_transforms
import tpu_unet_torch.cli.test_mvtec as test_cli
import tpu_unet_torch.data.transforms as port_transforms
from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_data import make_mvtec
from tpu_unet_torch.cli import train_mvtec, visualize_mvtec
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

SMALL = ["--image_size", "32", "--base_features", "4", "--batch_size", "4",
         "--num_workers", "2", "--precision", "f32"]


@pytest.fixture(autouse=True)
def _pil_resize(monkeypatch):
    """PIL resizes in both packages, here and in the spawned ranks (which
    read the variable at import)."""
    monkeypatch.setenv("TPU_UNET_NATIVE_RESIZE", "0")
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", False)
    monkeypatch.setattr(port_transforms, "_USE_NATIVE", False)


@pytest.fixture(scope="module")
def mvtec_root(tmp_path_factory):
    return make_mvtec(str(tmp_path_factory.mktemp("mvtec")), n_train=8, n_test_good=3,
                      n_broken=4, size=40)


@pytest.fixture(scope="module")
def trained(mvtec_root, tmp_path_factory):
    os.environ["TPU_UNET_NATIVE_RESIZE"] = "0"
    try:
        return train_mvtec.main(["--data_root", mvtec_root, "--category", "bottle",
                                 "--epochs", "2", "--val_freq", "1", "--save_freq", "1",
                                 "--save_dir", str(tmp_path_factory.mktemp("out")),
                                 "--device", "cpu", "--n_devices", "2", *SMALL])
    finally:
        del os.environ["TPU_UNET_NATIVE_RESIZE"]


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def test_two_rank_trainer_writes_its_files_once(trained):
    ckpts = sorted(os.listdir(os.path.join(trained, "checkpoints")))
    assert ckpts == ["best_model.pth", "checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth"]
    with open(os.path.join(trained, "results", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    assert [h["epoch"] for h in history] == [0, 1]  # one line per epoch: rank 0 wrote
    results = _json(trained, "results", "training_results.json")
    assert results["args"]["n_devices"] == 2 and results["interrupted"] is False
    assert all(np.isfinite(results["train_losses"] + results["val_losses"]))
    blob = torch.load(os.path.join(trained, "checkpoints", "checkpoint_epoch_1.pth"),
                      weights_only=True)
    build_model("anomaly_unet", base_features=4).load_state_dict(blob["model_state_dict"],
                                                                 strict=True)
    assert blob["epoch"] == 1
    # 8 train images, a global batch of 4: 2 Adam steps per epoch.
    assert int(blob["optimizer_state_dict"]["state"][0]["step"]) == 4


@pytest.mark.parametrize("mode", [[], ["--quantize", "int8"]])
def test_two_rank_test_path_matches_one_process_and_jax(mvtec_root, trained, tmp_path,
                                                        monkeypatch, mode):
    """The 2-rank test CLI's per-image scores, in the loader's order, equal
    one process's [float: rtol 1e-5; int8: exact] and the JAX test CLI's at
    --n_devices 2 on the same weights (float: scores rtol 1e-4, image
    metrics equal)."""
    best = os.path.join(trained, "checkpoints", "best_model.pth")
    args = ["--data_root", mvtec_root, "--category", "bottle", "--checkpoint", best,
            "--device", "cpu", *SMALL, *mode]
    two = test_cli.main(args + ["--output_dir", str(tmp_path / "two"), "--n_devices", "2"])
    one = test_cli.main(args + ["--output_dir", str(tmp_path / "one")])
    got = _json(tmp_path, "two", "bottle_test_results", "detailed_results.json")
    ref = _json(tmp_path, "one", "bottle_test_results", "detailed_results.json")
    assert got["image_paths"] == ref["image_paths"] and len(got["image_paths"]) == 7
    assert got["labels"] == ref["labels"]
    if mode:
        assert got["anomaly_scores"] == ref["anomaly_scores"]
        assert two["image_metrics"] == one["image_metrics"]
        return
    np.testing.assert_allclose(got["anomaly_scores"], ref["anomaly_scores"], rtol=1e-5)

    sd = torch.load(best, weights_only=True)["model_state_dict"]
    params, stats = jax_trees_from_state_dict(sd)
    monkeypatch.setattr(jax_test_cli, "load_params",
                        lambda state, path: state.replace(params=params, batch_stats=stats))
    jax_test_cli.main(args + ["--output_dir", str(tmp_path / "jax"), "--n_devices", "2"])
    want = _json(tmp_path, "jax", "bottle_test_results", "detailed_results.json")
    assert got["image_paths"] == want["image_paths"]
    np.testing.assert_allclose(got["anomaly_scores"], want["anomaly_scores"], rtol=1e-4)
    jax_metrics = _json(tmp_path, "jax", "bottle_test_results", "test_metrics.json")
    assert set(jax_metrics) == set(_json(tmp_path, "two", "bottle_test_results",
                                         "test_metrics.json"))
    for k, v in jax_metrics["image_metrics"].items():
        assert abs(two["image_metrics"][k] - v) <= 1e-6, k


def test_two_rank_viewer_collects_the_same_records(mvtec_root, trained):
    """visualize_mvtec's collect half on two ranks: each runs its rows of
    the same batches and the records come back in the loader's order, as
    one process collects them (scores rtol 1e-5)."""
    best = os.path.join(trained, "checkpoints", "best_model.pth")
    args = visualize_mvtec.parse_args(["--data_root", mvtec_root, "--category", "bottle",
                                       "--checkpoint", best, "--device", "cpu",
                                       "--max_samples", "6", *SMALL])
    two = launch(visualize_mvtec._collect_rank, (args,), devices=["cpu", "cpu"])
    one = visualize_mvtec.collect_records(args, torch.device("cpu"))
    assert len(two) == len(one) == 6
    assert [r["image_path"] for r in two] == [r["image_path"] for r in one]
    np.testing.assert_allclose([r["score"] for r in two], [r["score"] for r in one],
                               rtol=1e-5)
    for a, b in zip(two, one):
        np.testing.assert_allclose(a["anomaly_map"], b["anomaly_map"], rtol=1e-4, atol=1e-6)
