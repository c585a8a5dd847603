"""The seg CLIs with ``--n_space`` on gloo CPU ranks spawned by the CLI
(synthetic trees, base_features 4-8, f32).

- ``tests/test_e2e_seg.py``'s case: ``train_kolektorsdd --n_devices 2
  --n_space 2`` (four ranks, 64 x 32 images split into 32-row blocks), its
  checkpoint loading strict at world size 1, then ``test_kolektorsdd
  --n_devices 2 --n_space 2`` on it against the one-process evaluator:
  every metric within 1e-5 and the confusion matrix equal, in float and
  with ``--quantize int8`` (K2's plain version on halo'd rows).
- The JAX package's 3-D mesh CLI case at its own shape
  (``tests/test_tensor_parallel.py::TestCLIWiring``): ``train_gear
  --n_devices 2 --n_space 2 --n_model 2``, eight ranks.
"""

import json
import os

import numpy as np
import pytest
import torch

import tpu_unet_torch.data.transforms as port_transforms
from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_data import make_gear, make_kolektorsdd
from tpu_unet_torch.cli import test_kolektorsdd, train_gear, train_kolektorsdd
from tpu_unet_torch.models import build_model

KSDD = ["--image_height", "64", "--image_width", "32"]
SMALL = ["--base_features", "4", "--batch_size", "4", "--num_workers", "2",
         "--precision", "f32", "--device", "cpu"]
SPACE = ["--n_devices", "2", "--n_space", "2"]


@pytest.fixture(autouse=True)
def _pil_resize(monkeypatch):
    monkeypatch.setenv("TPU_UNET_NATIVE_RESIZE", "0")
    monkeypatch.setattr(port_transforms, "_USE_NATIVE", False)


@pytest.fixture(scope="module")
def ksdd_root(tmp_path_factory):
    return make_kolektorsdd(str(tmp_path_factory.mktemp("ksdd")), n_folders=4, per_folder=4)


@pytest.fixture(scope="module")
def trained(ksdd_root, tmp_path_factory):
    os.environ["TPU_UNET_NATIVE_RESIZE"] = "0"
    try:
        return train_kolektorsdd.main(
            ["--data_root", ksdd_root, "--epochs", "1", "--val_freq", "1", "--save_freq", "1",
             "--save_dir", str(tmp_path_factory.mktemp("out")), *KSDD, *SMALL, *SPACE])
    finally:
        del os.environ["TPU_UNET_NATIVE_RESIZE"]


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def test_space_trainer_writes_a_whole_checkpoint(trained):
    results = _json(trained, "results", "training_results.json")
    assert results["args"]["n_space"] == 2 and results["args"]["n_devices"] == 2
    assert all(np.isfinite(results["train_losses"] + results["val_losses"]))
    assert len(os.listdir(os.path.join(trained, "logs"))) == 1  # rank 0's log only
    blob = torch.load(os.path.join(trained, "checkpoints", "checkpoint_epoch_0.pth"),
                      weights_only=True)
    build_model("seg_unet", n_classes=3, base_features=4).load_state_dict(
        blob["model_state_dict"], strict=True)


@pytest.mark.parametrize("mode", [[], ["--quantize", "int8", "--calib_samples", "4"]],
                         ids=["f32", "int8"])
def test_space_evaluation_matches_one_process(ksdd_root, trained, tmp_path, mode):
    ckpt = os.path.join(trained, "checkpoints", "checkpoint_epoch_0.pth")
    common = ["--data_root", ksdd_root, "--checkpoint", ckpt, *KSDD, *SMALL, *mode]
    rows = test_kolektorsdd.main(common + ["--output_dir", str(tmp_path / "rows"), *SPACE])
    one = test_kolektorsdd.main(common + ["--output_dir", str(tmp_path / "one")])
    assert rows["evaluation_args"]["n_space"] == 2
    np.testing.assert_array_equal(rows["confusion_matrix"], one["confusion_matrix"])
    for k, v in one["overall_metrics"].items():
        np.testing.assert_allclose(rows["overall_metrics"][k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k, v in one["loss"].items():
        np.testing.assert_allclose(rows["loss"][k], v, rtol=1e-5, err_msg=k)
    assert _json(tmp_path / "rows", "evaluation_results.json")["overall_metrics"] == \
        rows["overall_metrics"]


def test_train_gear_on_a_2x2x2_mesh(tmp_path):
    root = make_gear(str(tmp_path / "gear"), n_per_split=8, size=32)
    exp = train_gear.main(["--data_root", root, "--image_size", "32", "--epochs", "1",
                           "--batch_size", "8", "--val_freq", "1", "--num_workers", "2",
                           "--save_dir", str(tmp_path / "out"), "--base_features", "8",
                           "--precision", "f32", "--device", "cpu", "--n_devices", "2",
                           "--n_space", "2", "--n_model", "2"])
    results = _json(exp, "results", "training_results.json")
    assert (results["args"]["n_devices"], results["args"]["n_space"],
            results["args"]["n_model"]) == (2, 2, 2)
    assert all(np.isfinite(results["train_losses"] + results["val_losses"]))
    blob = torch.load(os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth"),
                      weights_only=True)
    build_model("seg_unet", n_classes=4, base_features=8).load_state_dict(
        blob["model_state_dict"], strict=True)
