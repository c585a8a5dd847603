"""The port's seg CLIs (tpu_unet_torch/cli/train_gear.py, test_gear.py,
train_kolektorsdd.py, test_kolektorsdd.py over cli/_seg_common.py) end to
end with ``--device cpu`` on synthetic trees (base_features=4, KolektorSDD at
64 x 32, Gear at 32 x 32), their files against the JAX CLIs', and the test
path's metrics against the JAX evaluator's on the same weights."""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import tpu_unet.cli._seg_common as jax_seg_common
import tpu_unet.cli.test_kolektorsdd as jax_test_ksdd
import tpu_unet.cli.train_kolektorsdd as jax_train_ksdd
import tpu_unet.data.transforms as jax_transforms
import tpu_unet_torch.data.transforms as port_transforms
from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_data import make_gear, make_kolektorsdd
from tpu_unet.utils.viz import overlay_segmentation as jax_overlay
from tpu_unet_torch.cli import _seg_common as seg
from tpu_unet_torch.cli import test_gear, test_kolektorsdd, train_gear, train_kolektorsdd
from tpu_unet_torch.models import build_model
from tpu_unet_torch.utils.logging import setup_logging
from tpu_unet_torch.utils.viz import overlay_segmentation
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KSDD = ["--image_height", "64", "--image_width", "32"]
SMALL = ["--base_features", "4", "--batch_size", "2", "--num_workers", "2",
         "--device", "cpu", "--precision", "f32"]
HISTORY_KEYS = {"epoch", "train_miou", "total_loss", "ce_loss", "dice_loss", "val_loss",
                "val_miou", "val_dice", "val_pixel_accuracy", "epoch_seconds"}


@pytest.fixture(autouse=True)
def _pil_resize(monkeypatch):
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", False)
    monkeypatch.setattr(port_transforms, "_USE_NATIVE", False)


@pytest.fixture(scope="module")
def ksdd_root(tmp_path_factory):
    return make_kolektorsdd(str(tmp_path_factory.mktemp("ksdd")), n_folders=4, per_folder=4)


@pytest.fixture(scope="module")
def gear_root(tmp_path_factory):
    return make_gear(str(tmp_path_factory.mktemp("gear")), n_per_split=4, size=40)


def _train(root, save_dir, *extra):
    return train_kolektorsdd.main(["--data_root", root, "--epochs", "2", "--val_freq", "1",
                                   "--save_freq", "1", "--save_dir", str(save_dir),
                                   *KSDD, *SMALL, *extra])


def _test(root, checkpoint, out_dir, *extra):
    return test_kolektorsdd.main(["--data_root", root, "--checkpoint", checkpoint,
                                  "--output_dir", str(out_dir), *KSDD, *SMALL, *extra])


@pytest.fixture(scope="module")
def trained(ksdd_root, tmp_path_factory):
    return _train(ksdd_root, tmp_path_factory.mktemp("outputs"), "--progress_every", "1")


def _n_test(ksdd_root):
    """The test split's size at these flags."""
    args = test_kolektorsdd.parse_args(["--data_root", ksdd_root, "--checkpoint", "x", *KSDD])
    return len(test_kolektorsdd.make_workload().make_datasets(args)[2])


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _history(exp):
    with open(os.path.join(exp, "results", "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_the_jax_trainers_files(ksdd_root, trained, tmp_path):
    """The port's experiment directory holds the JAX trainer's files with the
    same keys (the JAX trainer run for one epoch beside it)."""
    name = os.path.basename(trained)
    assert name.startswith("kolektorsdd_seg_unet_") and len(name.rsplit("_", 2)[-2]) == 8
    assert _json(trained, "args.json")["device"] == "cpu"
    for sub in ("checkpoints", "results", "visualizations", "logs"):
        assert os.path.isdir(os.path.join(trained, sub))
    assert glob.glob(os.path.join(trained, "logs", f"{name}_*.log"))
    ckpts = set(os.listdir(os.path.join(trained, "checkpoints")))
    assert {"checkpoint_epoch_0.pth", "checkpoint_epoch_1.pth"} <= ckpts
    history = _history(trained)
    assert [h["epoch"] for h in history] == [0, 1] and set(history[0]) == HISTORY_KEYS
    results = _json(trained, "results", "training_results.json")
    assert results["num_classes"] == 3 and results["interrupted"] is False
    assert len(results["train_losses"]) == len(results["val_losses"]) == 2
    assert results["best_val_miou"] == max([0.0] + [h["val_miou"] for h in history])
    blob = torch.load(os.path.join(trained, "checkpoints", "checkpoint_epoch_1.pth"),
                      weights_only=True)
    assert set(blob) == {"epoch", "model_state_dict", "optimizer_state_dict", "loss"}
    build_model("seg_unet", n_classes=3, base_features=4).load_state_dict(
        blob["model_state_dict"], strict=True)  # reference names

    jax_exp = jax_train_ksdd.main(["--data_root", ksdd_root, "--epochs", "1", "--save_dir",
                                   str(tmp_path), "--device", "cpu", "--n_devices", "1", *KSDD,
                                   *[a for a in SMALL if a not in ("--device", "cpu")]])
    jax_results = _json(jax_exp, "results", "training_results.json")
    assert set(results) == set(jax_results)
    assert set(_history(jax_exp)[0]) == HISTORY_KEYS
    assert set(_json(jax_exp, "args.json")) == set(_json(trained, "args.json"))


@pytest.mark.parametrize("mode", [[], ["--fold_bn"], ["--quantize", "int8"]])
def test_test_cli_modes(ksdd_root, trained, tmp_path, mode):
    ckpt = os.path.join(trained, "checkpoints", "checkpoint_epoch_1.pth")
    summary = _test(ksdd_root, ckpt, tmp_path, *mode)
    saved = _json(tmp_path, "evaluation_results.json")
    assert set(saved) == {"evaluation_args", "overall_metrics", "per_class_metrics",
                          "confusion_matrix", "loss"}
    assert saved["overall_metrics"] == summary["overall_metrics"]
    assert (tmp_path / "confusion_matrix.png").stat().st_size > 0
    n_test = len(test_kolektorsdd.make_workload().make_datasets(
        test_kolektorsdd.parse_args(["--data_root", ksdd_root, "--checkpoint", "x",
                                     *KSDD]))[2])
    assert np.asarray(saved["confusion_matrix"]).sum() == n_test * 64 * 32
    assert all(0.0 <= v <= 1.0 for v in saved["overall_metrics"].values())
    assert set(saved["loss"]) == {"ce_loss", "dice_loss", "total_loss"}
    if mode:  # folded BN gives the float model's metrics; int8 stays close
        plain = _test(ksdd_root, ckpt, tmp_path / "plain")
        for k, v in plain["overall_metrics"].items():
            tol = 1e-6 if mode == ["--fold_bn"] else 0.05
            assert abs(saved["overall_metrics"][k] - v) <= tol, k


def test_test_path_matches_the_jax_evaluator(ksdd_root, trained, tmp_path, monkeypatch):
    """The JAX evaluator on the port checkpoint's weights: the same keys, the
    confusion matrix [exact], every metric [1e-6] and the loss [rtol 1e-5]."""
    ckpt = os.path.join(trained, "checkpoints", "checkpoint_epoch_1.pth")
    got = _test(ksdd_root, ckpt, tmp_path / "port")
    sd = torch.load(ckpt, weights_only=True)["model_state_dict"]
    params, stats = jax_trees_from_state_dict(sd, model="seg_unet")
    monkeypatch.setattr(jax_seg_common, "load_params",
                        lambda state, path: state.replace(params=params, batch_stats=stats))
    jax_test_ksdd.main(["--data_root", ksdd_root, "--checkpoint", ckpt, "--output_dir",
                        str(tmp_path / "jax"), "--device", "cpu", "--n_devices", "1", *KSDD,
                        *[a for a in SMALL if a not in ("--device", "cpu")]])
    want = _json(tmp_path / "jax", "evaluation_results.json")
    assert set(want) == set(got)
    assert set(want["overall_metrics"]) == set(got["overall_metrics"])
    assert set(want["per_class_metrics"]) == set(got["per_class_metrics"])
    np.testing.assert_array_equal(got["confusion_matrix"], want["confusion_matrix"])
    for k, v in want["overall_metrics"].items():
        assert abs(got["overall_metrics"][k] - v) <= 1e-6, k
    for k, v in want["per_class_metrics"].items():
        np.testing.assert_allclose(got["per_class_metrics"][k], v, rtol=0, atol=1e-6, err_msg=k)
    for k, v in want["loss"].items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5, err_msg=k)


def test_resume_continues_the_epoch_and_adam_step(ksdd_root, trained, tmp_path):
    exp = _train(ksdd_root, tmp_path, "--epochs", "3", "--resume",
                 os.path.join(trained, "checkpoints", "checkpoint_epoch_1.pth"))
    assert [h["epoch"] for h in _history(exp)] == [2]
    blob = torch.load(os.path.join(exp, "checkpoints", "checkpoint_epoch_2.pth"),
                      weights_only=True)
    steps_per_epoch = int(0.7 * 16) // 2
    assert blob["epoch"] == 2
    assert int(blob["optimizer_state_dict"]["state"][0]["step"]) == 3 * steps_per_epoch


def test_gear_train_and_test_with_panels(gear_root, tmp_path):
    """Gear: grad_accum 2, the --debug subset, 4 classes; the test CLI's
    prediction panels for the valid rows."""
    small = ["--image_size", "32", *SMALL]
    exp = train_gear.main(["--data_root", gear_root, "--epochs", "1", "--save_dir",
                           str(tmp_path), "--grad_accum", "2", "--debug", "--debug_samples",
                           "3", *small])
    assert os.path.basename(exp).startswith("gear_seg_seg_unet_")
    results = _json(exp, "results", "training_results.json")
    assert results["num_classes"] == 4 and len(results["train_losses"]) == 1
    summary = test_gear.main(["--data_root", gear_root, "--checkpoint",
                              os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth"),
                              "--output_dir", str(tmp_path / "test"), "--save_predictions",
                              "--quantize", "int8", "--calib_samples", "4", *small])
    assert np.asarray(summary["confusion_matrix"]).shape == (4, 4)
    panels = glob.glob(str(tmp_path / "test" / "prediction_batch*_img*_*.png"))
    assert len(panels) == 4  # 4 test images in batches of 2, none padded


def test_sigterm_saves_an_interrupt_checkpoint_and_exits_75(ksdd_root, tmp_path):
    save_dir = tmp_path / "out"
    cmd = [sys.executable, "-m", "tpu_unet_torch.cli.train_kolektorsdd", "--data_root",
           ksdd_root, "--epochs", "100000", "--val_freq", "1000", "--save_freq", "1000",
           "--save_dir", str(save_dir), *KSDD, *SMALL]
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while not glob.glob(str(save_dir / "*" / "results" / "history.jsonl")):
            assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, out
    exp = glob.glob(str(save_dir / "*"))[0]
    blob = torch.load(os.path.join(exp, "checkpoints", "checkpoint_interrupt.pth"),
                      weights_only=True)
    results = _json(exp, "results", "training_results.json")
    assert results["interrupted"] is True
    assert blob["epoch"] == len(results["train_losses"]) - 1
    assert "SIGTERM received" in out


def test_clis_default_to_cuda(ksdd_root, gear_root, tmp_path):
    """Nothing falls back to the CPU: without a GPU the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    for main, root in ((train_kolektorsdd.main, ksdd_root), (train_gear.main, gear_root)):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--data_root", root, "--save_dir", str(tmp_path)])
    for main, root in ((test_kolektorsdd.main, ksdd_root), (test_gear.main, gear_root)):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--data_root", root, "--checkpoint", "x.pth", "--output_dir",
                  str(tmp_path), "--device", "auto"])
    assert not os.listdir(tmp_path)  # raised before writing anything


# The model variants of the JAX package's seg CLIs, each trained for one
# epoch: UNet++ with deep supervision, the attention UNet and a bilinear
# SegmentationUNet.
VARIANTS = {"unetpp_ds": ["--model", "unetpp", "--deep_supervision"],
            "attn_unet": ["--model", "attn_unet"],
            "bilinear": ["--bilinear"]}


@pytest.fixture(scope="module")
def variant_runs(ksdd_root, tmp_path_factory):
    """{variant: its epoch-0 checkpoint}, trained by the CLI on first use."""
    out = tmp_path_factory.mktemp("variants")
    cache = {}

    def get(name):
        if name not in cache:
            exp = _train(ksdd_root, out / name, "--epochs", "1", *VARIANTS[name])
            cache[name] = os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth")
        return cache[name]

    return get


@pytest.mark.parametrize("flag", [
    ["--n_devices", "2"], ["--n_space", "2"], ["--fsdp"], ["--n_model", "2"], ["--multihost"],
    ["--coordinator_address", "localhost:1234"], ["--num_processes", "2"],
    ["--process_id", "0"], ["--bilinear"], ["--deep_supervision"]])
def test_unported_train_flags_raise(ksdd_root, tmp_path, variant_runs, flag):
    """The data-parallel flags are ported (tests/test_torch_parallel_cli_seg.py
    trains on two ranks); here their parsing and refusals, before anything
    is written: ``--n_devices 2`` plans 2 ranks and refuses a global batch
    that does not split over them; ``--fsdp`` on one device warns and
    trains whole; ``--n_space 2`` plans 2 ranks (one data rank times two
    space ranks) and refuses a height that does not split at every level
    (tests/test_torch_parallel_spatial_cli.py trains with it); ``--n_model 2`` plans 2 ranks (one data rank times two model
    ranks) and refuses a batch that does not split over the data ranks and
    ``--grad_accum`` (tests/test_torch_parallel_tensor_cli.py trains with
    it); a half-specified multi-host
    launch and ``--multihost`` outside torchrun or SLURM raise ValueError.
    ``--bilinear`` trains (a checkpoint with no transposed conv and the
    reference's bilinear widths); ``--deep_supervision`` without ``--model
    unetpp`` raises the JAX package's ValueError, also before anything is
    written."""
    if flag == ["--bilinear"]:
        sd = torch.load(variant_runs("bilinear"), weights_only=True)["model_state_dict"]
        assert not any(k.endswith(".up.weight") for k in sd)
        build_model("seg_unet", n_classes=3, base_features=4, bilinear=True).load_state_dict(
            sd, strict=True)
        return
    if flag == ["--fsdp"]:
        with pytest.warns(UserWarning, match="--fsdp requested on one device"):
            exp = _train(ksdd_root, tmp_path, *flag, "--epochs", "1")
        assert "checkpoint_epoch_0.pth" in os.listdir(os.path.join(exp, "checkpoints"))
        return
    if flag[0] == "--n_devices":
        args = train_kolektorsdd.parse_args(["--device", "cpu", *flag])
        assert args.n_devices == 2 and seg.check_train_flags(args) == 2
        with pytest.raises(SystemExit, match="2 ranks"):
            _train(ksdd_root, tmp_path, *flag, "--batch_size", "3")
    elif flag[0] == "--n_space":
        args = train_kolektorsdd.parse_args(["--device", "cpu", *flag])
        assert args.n_space == 2 and seg.check_train_flags(args, 64) == 2
        with pytest.raises(ValueError, match="multiple of n_space x 2\\^4 = 32"):
            _train(ksdd_root, tmp_path, *flag, "--image_height", "48")
    elif flag[0] == "--n_model":
        args = train_kolektorsdd.parse_args(["--device", "cpu", *flag])
        assert args.n_model == 2 and seg.check_train_flags(args) == 2
        with pytest.raises(SystemExit, match="1 ranks x --grad_accum 3"):
            _train(ksdd_root, tmp_path, *flag, "--grad_accum", "3")
    elif flag == ["--deep_supervision"]:
        with pytest.raises(ValueError):
            _train(ksdd_root, tmp_path, *flag)
    else:
        match = "coordinator_address" if flag[0] == "--num_processes" else (
            "torchrun" if flag == ["--multihost"] else "num_processes")
        with pytest.raises(ValueError, match=match):
            _train(ksdd_root, tmp_path, *flag)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flag", [["--n_devices", "2"], ["--n_space", "2"], ["--bilinear"],
                                  ["--heads", "2"], ["--model", "unetpp"]])
def test_unported_test_flags_raise(ksdd_root, tmp_path, variant_runs, flag):
    """``--n_devices`` is ported (tests/test_torch_parallel_cli_seg.py
    evaluates on two ranks): a batch that does not split over the ranks
    raises SystemExit. ``--n_space 2`` plans 2 ranks and refuses a height
    that 2 does not divide with the JAX package's ValueError
    (tests/test_torch_parallel_spatial_cli.py evaluates with it); ``--heads`` without UNet++'s deep supervision raises
    the JAX package's ValueError. The bilinear decoder and UNet++ (pruned
    to head X[0][2]) evaluate their checkpoints end to end."""
    if flag == ["--bilinear"]:
        summary = _test(ksdd_root, variant_runs("bilinear"), tmp_path, *flag)
    elif flag == ["--model", "unetpp"]:
        summary = _test(ksdd_root, variant_runs("unetpp_ds"), tmp_path, *flag,
                        "--deep_supervision", "--heads", "2")
    else:
        if flag[0] == "--n_devices":
            with pytest.raises(SystemExit, match="2 ranks"):
                _test(ksdd_root, "x.pth", tmp_path, *flag, "--batch_size", "3")
        elif flag[0] == "--n_space":
            args = test_kolektorsdd.parse_args(["--device", "cpu", "--checkpoint", "x", *flag])
            assert seg.check_eval_flags(args, 64) == 2
            with pytest.raises(ValueError, match="must divide the image height 63"):
                _test(ksdd_root, "x.pth", tmp_path, *flag, "--image_height", "63")
        else:
            with pytest.raises(ValueError, match="heads"):
                _test(ksdd_root, "x.pth", tmp_path, *flag)
        return
    assert _json(tmp_path, "evaluation_results.json")["overall_metrics"] == \
        summary["overall_metrics"]
    assert np.asarray(summary["confusion_matrix"]).sum() == _n_test(ksdd_root) * 64 * 32


@pytest.mark.parametrize("variant,mode,k2_per_batch", [
    ("unetpp_ds", ["--heads", "4"], 0), ("unetpp_ds", ["--quantize", "int8"], 30),
    ("unetpp_ds", ["--quantize", "int8", "--heads", "1"], 6),
    ("attn_unet", ["--fold_bn"], 0), ("attn_unet", ["--quantize", "int8"], 18),
    ("bilinear", ["--quantize", "int8"], 18)])
def test_model_variants_test_path(ksdd_root, variant_runs, tmp_path, monkeypatch, variant,
                                  mode, k2_per_batch):
    """The test CLI on each variant's checkpoint in f32, folded BN and int8
    (calibrated over every UNet++ node whatever ``--heads``): a confusion
    matrix over every test pixel, metrics in [0, 1]; K2 (the int8 path's
    conv3x3) runs 30 times per batch for UNet++ at heads 4, 6 at heads 1,
    18 for the attention UNet and the bilinear SegmentationUNet. Float
    modes stay within 1e-6 of the plain f32 run's metrics (folded BN)."""
    from tpu_unet_torch.ops import quantize as tq

    calls = []
    real = tq._QuantExec.conv3x3
    monkeypatch.setattr(tq._QuantExec, "conv3x3",
                        staticmethod(lambda *a, **kw: calls.append(1) or real(*a, **kw)))
    flags = [f for f in VARIANTS[variant] if f != "--deep_supervision"] + (
        ["--deep_supervision"] if variant == "unetpp_ds" else [])
    summary = _test(ksdd_root, variant_runs(variant), tmp_path, *flags, *mode)
    n_test = _n_test(ksdd_root)
    assert len(calls) == k2_per_batch * -(-n_test // 2)  # batches of 2, the last padded
    assert np.asarray(summary["confusion_matrix"]).sum() == n_test * 64 * 32
    assert all(0.0 <= v <= 1.0 for v in summary["overall_metrics"].values())
    if mode == ["--fold_bn"]:
        plain = _test(ksdd_root, variant_runs(variant), tmp_path / "plain", *flags)
        for k, v in plain["overall_metrics"].items():
            assert abs(summary["overall_metrics"][k] - v) <= 1e-6, k


@pytest.mark.parametrize("variant,extra", [("unetpp_ds", ["--heads", "2"]),
                                           ("attn_unet", [])])
def test_variant_test_path_matches_the_jax_evaluator(ksdd_root, variant_runs, tmp_path,
                                                     monkeypatch, variant, extra):
    """The JAX evaluator on the same weights (UNet++ pruned to head X[0][2],
    the attention UNet): the confusion matrix [exact], every metric [1e-6]
    and the loss [rtol 1e-5]."""
    ckpt = variant_runs(variant)
    flags = VARIANTS[variant] + extra
    got = _test(ksdd_root, ckpt, tmp_path / "port", *flags)
    sd = torch.load(ckpt, weights_only=True)["model_state_dict"]
    params, stats = jax_trees_from_state_dict(sd, model=flags[1])
    monkeypatch.setattr(jax_seg_common, "load_params",
                        lambda state, path: state.replace(params=params, batch_stats=stats))
    jax_test_ksdd.main(["--data_root", ksdd_root, "--checkpoint", ckpt, "--output_dir",
                        str(tmp_path / "jax"), "--device", "cpu", "--n_devices", "1", *KSDD,
                        *[a for a in SMALL if a not in ("--device", "cpu")], *flags])
    want = _json(tmp_path / "jax", "evaluation_results.json")
    np.testing.assert_array_equal(got["confusion_matrix"], want["confusion_matrix"])
    for k, v in want["overall_metrics"].items():
        assert abs(got["overall_metrics"][k] - v) <= 1e-6, k
    for k, v in want["loss"].items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5, err_msg=k)


def test_grad_accum_and_class_weights_are_checked(ksdd_root, tmp_path):
    with pytest.raises(SystemExit):
        _train(ksdd_root, tmp_path, "--grad_accum", "3")
    assert seg.parse_class_weights(None, 3) is None
    assert seg.parse_class_weights("1,50,50", 3) == (1.0, 50.0, 50.0)
    with pytest.raises(ValueError):
        seg.parse_class_weights("1,2", 3)


def test_overlay_segmentation_matches_jax():
    rng = np.random.default_rng(0)
    image = rng.standard_normal((16, 12, 3)).astype(np.float32)
    mask = rng.integers(0, 4, (16, 12))
    np.testing.assert_array_equal(overlay_segmentation(image, mask),
                                  jax_overlay(image, mask))


def test_setup_logging_writes_a_file_and_replaces_its_handlers(tmp_path, capsys):
    for _ in range(2):
        logger = setup_logging(str(tmp_path), "exp_name")
    logger.info("hello")
    assert len(logger.handlers) == 2 and not logger.propagate
    assert capsys.readouterr().out.count("hello") == 1
    logs = glob.glob(str(tmp_path / "exp_name_*.log"))
    assert logs and any("hello" in open(p).read() for p in logs)
    for h in logger.handlers:
        h.close()
