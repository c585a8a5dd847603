"""The train CLIs with ``--n_model`` on gloo CPU ranks spawned by the CLI
(base_features 4-8, 32 px or 64 x 32, f32).

- The JAX package's 3-D mesh CLI case (tests/test_tensor_parallel.py,
  ``--n_devices 2 --n_space 2 --n_model 2``) as a 2 x 1 x 2 run of
  train_gear (tests/test_torch_parallel_spatial_cli.py runs it at its own
  2 x 2 x 2 shape). Its losses
  and checkpoint against the same CLI at world size 1 under SGD (losses
  1e-5 relative, parameters 1e-5 after an epoch of two steps; Adam's first
  update, about lr * sign(g), turns the reorder noise of a gradient near 0
  into up to 2 lr).
- train_mvtec with ``--n_model 2``: its ``best_model.pth`` loads strict at
  world size 1 and test_mvtec scores it.
- train_kolektorsdd with ``--n_devices 2 --n_model 2 --fsdp`` (four ranks,
  FSDP over 'data' composed with the channel slices): its files written
  once, its checkpoint whole.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_data import make_gear, make_kolektorsdd, make_mvtec
from tpu_unet_torch.cli import test_mvtec as test_cli
from tpu_unet_torch.cli._seg_common import check_train_flags
from tpu_unet_torch.cli import train_gear, train_kolektorsdd, train_mvtec
from tpu_unet_torch.models import build_model


def _results(exp):
    with open(os.path.join(exp, "results", "training_results.json")) as f:
        return json.load(f)


def _checkpoint(exp, name):
    return torch.load(os.path.join(exp, "checkpoints", name), weights_only=True)


def test_train_gear_on_a_2x1x2_mesh_matches_world_size_one(tmp_path):
    root = make_gear(str(tmp_path / "gear"), n_per_split=8, size=32)
    flags = ["--data_root", root, "--image_size", "32", "--epochs", "1", "--batch_size", "4",
             "--val_freq", "1", "--num_workers", "2", "--base_features", "8",
             "--precision", "f32", "--device", "cpu", "--optimizer", "sgd",
             "--learning_rate", "0.05"]
    mesh = train_gear.main(flags + ["--save_dir", str(tmp_path / "mesh"), "--n_devices", "2",
                                    "--n_model", "2"])
    one = train_gear.main(flags + ["--save_dir", str(tmp_path / "one")])
    got, want = _results(mesh), _results(one)
    assert got["args"]["n_model"] == 2 and got["args"]["n_devices"] == 2
    np.testing.assert_allclose(got["train_losses"], want["train_losses"], rtol=1e-5)
    np.testing.assert_allclose(got["val_losses"], want["val_losses"], rtol=1e-5)
    a, b = (_checkpoint(e, "checkpoint_epoch_0.pth")["model_state_dict"] for e in (mesh, one))
    build_model("seg_unet", n_classes=4, base_features=8).load_state_dict(a, strict=True)
    for k, v in b.items():
        np.testing.assert_allclose(a[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


def test_train_mvtec_with_n_model_and_its_test(tmp_path):
    root = make_mvtec(str(tmp_path / "mvtec"), n_train=8, n_test_good=3, n_broken=3)
    small = ["--image_size", "32", "--base_features", "4", "--batch_size", "4",
             "--num_workers", "2", "--device", "cpu"]
    exp = train_mvtec.main(["--data_root", root, "--category", "bottle", "--epochs", "1",
                            "--val_freq", "1", "--precision", "f32", "--n_model", "2",
                            "--save_dir", str(tmp_path / "out"), *small])
    assert _results(exp)["args"]["n_model"] == 2
    best = os.path.join(exp, "checkpoints", "best_model.pth")
    build_model("anomaly_unet", base_features=4).load_state_dict(
        torch.load(best, weights_only=True)["model_state_dict"], strict=True)
    evaluation = test_cli.main(["--data_root", root, "--category", "bottle", "--checkpoint",
                                best, "--output_dir", str(tmp_path / "test"), *small])
    assert np.isfinite(evaluation["image_metrics"]["auroc"])


def test_train_kolektorsdd_with_n_model_and_fsdp(tmp_path):
    root = make_kolektorsdd(str(tmp_path / "ksdd"), n_folders=4, per_folder=4)
    exp = train_kolektorsdd.main(
        ["--data_root", root, "--image_height", "64", "--image_width", "32", "--epochs", "1",
         "--val_freq", "1", "--save_freq", "1", "--base_features", "4", "--batch_size", "4",
         "--num_workers", "2", "--precision", "f32", "--device", "cpu", "--n_devices", "2",
         "--n_model", "2", "--fsdp", "--save_dir", str(tmp_path / "out")])
    results = _results(exp)
    assert results["args"]["fsdp"] and results["args"]["n_model"] == 2
    assert all(np.isfinite(results["train_losses"] + results["val_losses"]))
    assert len(os.listdir(os.path.join(exp, "logs"))) == 1  # rank 0's log only
    blob = _checkpoint(exp, "checkpoint_epoch_0.pth")
    build_model("seg_unet", n_classes=3, base_features=4).load_state_dict(
        blob["model_state_dict"], strict=True)
    assert blob["optimizer_state_dict"]["state"][0]["exp_avg"].shape == (4, 3, 3, 3)


@pytest.mark.parametrize("flags,ranks", [([], 2), (["--n_devices", "2"], 4)])
def test_n_model_plans_its_ranks(flags, ranks):
    """``--n_model 2`` times ``--n_devices``; the batch splits over the data
    ranks only."""
    args = train_gear.parse_args(["--device", "cpu", "--n_model", "2", *flags])
    assert check_train_flags(args) == ranks
    args = train_mvtec.parse_args(["--device", "cpu", "--n_model", "2", "--batch_size", "3",
                                   *flags])
    if ranks == 2:
        assert train_mvtec.check_flags(args) == 2
    else:
        with pytest.raises(SystemExit, match="2 ranks"):
            train_mvtec.check_flags(args)
