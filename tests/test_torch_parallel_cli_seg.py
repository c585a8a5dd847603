"""The port's KolektorSDD CLIs with ``--device cpu --n_devices 2``: two gloo
ranks spawned by the CLI, on a synthetic tree (base_features=4, 64 x 32, a
global batch of 4). The trainer writes its files once and resumes; the
2-rank evaluation's metrics equal one process's and the JAX evaluator's at
``--n_devices 2`` on the same weights, at KolektorSDD's class weights."""

import json
import os

import numpy as np
import pytest
import torch

import tpu_unet.cli._seg_common as jax_seg_common
import tpu_unet.cli.test_kolektorsdd as jax_test_ksdd
import tpu_unet.data.transforms as jax_transforms
import tpu_unet_torch.data.transforms as port_transforms
from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_data import make_kolektorsdd
from tpu_unet_torch.cli import test_kolektorsdd, train_kolektorsdd, visualize_seg
from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.mesh import launch
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

KSDD = ["--image_height", "64", "--image_width", "32"]
SMALL = ["--base_features", "4", "--batch_size", "4", "--num_workers", "2",
         "--precision", "f32"]


@pytest.fixture(autouse=True)
def _pil_resize(monkeypatch):
    monkeypatch.setenv("TPU_UNET_NATIVE_RESIZE", "0")
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", False)
    monkeypatch.setattr(port_transforms, "_USE_NATIVE", False)


@pytest.fixture(scope="module")
def ksdd_root(tmp_path_factory):
    return make_kolektorsdd(str(tmp_path_factory.mktemp("ksdd")), n_folders=4, per_folder=4)


@pytest.fixture(scope="module")
def trained(ksdd_root, tmp_path_factory):
    os.environ["TPU_UNET_NATIVE_RESIZE"] = "0"
    try:
        return train_kolektorsdd.main(
            ["--data_root", ksdd_root, "--epochs", "2", "--val_freq", "1", "--save_freq", "1",
             "--save_dir", str(tmp_path_factory.mktemp("out")), "--device", "cpu",
             "--n_devices", "2", "--grad_accum", "2", *KSDD, *SMALL])
    finally:
        del os.environ["TPU_UNET_NATIVE_RESIZE"]


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def test_two_rank_trainer_writes_its_files_once(trained):
    ckpts = set(os.listdir(os.path.join(trained, "checkpoints")))
    assert {"checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth"} <= ckpts
    with open(os.path.join(trained, "results", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    assert [h["epoch"] for h in history] == [0, 1]
    results = _json(trained, "results", "training_results.json")
    assert results["args"]["n_devices"] == 2 and results["args"]["grad_accum"] == 2
    assert all(np.isfinite(results["train_losses"] + results["val_losses"]))
    logs = os.listdir(os.path.join(trained, "logs"))
    assert len(logs) == 1  # rank 0's log only
    blob = torch.load(os.path.join(trained, "checkpoints", "checkpoint_epoch_1.pth"),
                      weights_only=True)
    build_model("seg_unet", n_classes=3, base_features=4).load_state_dict(
        blob["model_state_dict"], strict=True)


def test_two_rank_evaluation_matches_one_process_and_jax(ksdd_root, trained, tmp_path,
                                                         monkeypatch):
    """The confusion matrix [exact], every metric [1e-6] and the loss
    [rtol 1e-5] of the 2-rank evaluator equal one process's and the JAX
    evaluator's on 2 devices."""
    ckpt = os.path.join(trained, "checkpoints", "checkpoint_epoch_1.pth")
    args = ["--data_root", ksdd_root, "--checkpoint", ckpt, "--device", "cpu", *KSDD, *SMALL]
    two = test_kolektorsdd.main(args + ["--output_dir", str(tmp_path / "two"),
                                        "--n_devices", "2"])
    one = test_kolektorsdd.main(args + ["--output_dir", str(tmp_path / "one")])
    sd = torch.load(ckpt, weights_only=True)["model_state_dict"]
    params, stats = jax_trees_from_state_dict(sd, model="seg_unet")
    monkeypatch.setattr(jax_seg_common, "load_params",
                        lambda state, path: state.replace(params=params, batch_stats=stats))
    jax_test_ksdd.main(args + ["--output_dir", str(tmp_path / "jax"), "--n_devices", "2"])
    want = _json(tmp_path, "jax", "evaluation_results.json")
    assert _json(tmp_path, "two", "evaluation_results.json")["loss"] == two["loss"]
    for ref in (one, want):
        assert set(two) == set(ref)
        np.testing.assert_array_equal(two["confusion_matrix"], ref["confusion_matrix"])
        for k, v in ref["overall_metrics"].items():
            assert abs(two["overall_metrics"][k] - v) <= 1e-6, k
        for k, v in ref["loss"].items():
            np.testing.assert_allclose(two["loss"][k], v, rtol=1e-5, err_msg=k)


def test_resume_on_two_ranks_continues_the_epoch_and_adam_step(ksdd_root, trained,
                                                               tmp_path):
    """A 2-rank checkpoint resumes on 2 ranks: the epoch count and the Adam
    step carry on (each rank restores the whole file, then the state is
    placed on the mesh)."""
    ckpt = os.path.join(trained, "checkpoints", "checkpoint_epoch_0.pth")
    exp = train_kolektorsdd.main(
        ["--data_root", ksdd_root, "--epochs", "2", "--val_freq", "1", "--save_freq", "1",
         "--save_dir", str(tmp_path), "--device", "cpu", "--n_devices", "2", "--resume",
         ckpt, *KSDD, *SMALL])
    with open(os.path.join(exp, "results", "history.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [1]
    before = torch.load(ckpt, weights_only=True)["optimizer_state_dict"]["state"][0]["step"]
    after = torch.load(os.path.join(exp, "checkpoints", "checkpoint_epoch_1.pth"),
                       weights_only=True)["optimizer_state_dict"]["state"][0]["step"]
    assert int(after) == 2 * int(before) > 0


def test_two_rank_viewer_collects_the_same_samples(ksdd_root, trained):
    """visualize_seg's collect half on two ranks gathers the samples in the
    loader's order, as one process does (predictions exact here,
    confidences rtol 1e-5)."""
    ckpt = os.path.join(trained, "checkpoints", "checkpoint_epoch_1.pth")
    args = visualize_seg.parse_args(["--dataset", "kolektorsdd", "--data_root", ksdd_root,
                                     "--checkpoint", ckpt, "--device", "cpu",
                                     "--max_samples", "3", "--split", "test", *KSDD, *SMALL])
    two = launch(visualize_seg._collect_rank, (args,), devices=["cpu", "cpu"])
    one = visualize_seg.collect_samples(args, torch.device("cpu"))
    assert [s["stem"] for s in two] == [s["stem"] for s in one] and len(one) == 3
    for a, b in zip(two, one):
        np.testing.assert_array_equal(a["pred"], b["pred"])
        np.testing.assert_allclose(a["conf"], b["conf"], rtol=1e-5)
