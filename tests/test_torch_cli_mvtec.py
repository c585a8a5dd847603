"""The port's MVTec CLIs (tpu_unet_torch/cli/train_mvtec.py, test_mvtec.py,
sweep_mvtec.py, demo.py) end to end with ``--device cpu`` on a synthetic
category (base_features=4, 32 px), and the port's test path against the JAX
package's on the same weights."""

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

from _torch_parity import one_torch_thread  # noqa: F401  (an autouse fixture)
import tpu_unet.cli.test_mvtec as jax_test_cli
import tpu_unet.data.transforms as jax_transforms
import tpu_unet.models as jmodels
import tpu_unet_torch.cli.test_mvtec as test_cli
import tpu_unet_torch.data.transforms as port_transforms
from test_data import make_mvtec
from tpu_unet.data.loader import DataLoader as JaxDataLoader
from tpu_unet.data.mvtec import MVTecDataset as JaxMVTec
from tpu_unet.train import make_anomaly_eval_step as jax_eval_step
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.cli import demo, sweep_mvtec, train_mvtec
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.data.mvtec import MVTecDataset
from tpu_unet_torch.models import build_model
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import make_anomaly_eval_step
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--image_size", "32", "--base_features", "4", "--batch_size", "4",
         "--num_workers", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def mvtec_root(tmp_path_factory):
    return make_mvtec(str(tmp_path_factory.mktemp("mvtec")), n_train=8, n_test_good=3,
                      n_broken=3, size=40)


def _train(root, save_dir, *extra):
    return train_mvtec.main(["--data_root", root, "--category", "bottle", "--epochs", "3",
                             "--val_freq", "1", "--save_freq", "2", "--precision", "f32",
                             "--save_dir", str(save_dir), *SMALL, *extra])


def _test(root, checkpoint, out_dir, *extra):
    return test_cli.main(["--data_root", root, "--category", "bottle", "--checkpoint",
                          checkpoint, "--output_dir", str(out_dir), *SMALL, *extra])


@pytest.fixture(scope="module")
def trained(mvtec_root, tmp_path_factory):
    return _train(mvtec_root, tmp_path_factory.mktemp("outputs"), "--progress_every", "1")


def test_train_writes_the_jax_trainers_artifacts(trained):
    name = os.path.basename(trained)
    assert name.startswith("bottle_anomaly_unet_")
    assert len(name.rsplit("_", 2)[-2]) == 8 and len(name.rsplit("_", 1)[-1]) == 6
    with open(os.path.join(trained, "args.json")) as f:
        assert json.load(f)["device"] == "cpu"
    for sub in ("checkpoints", "results", "visualizations", "logs"):
        assert os.path.isdir(os.path.join(trained, sub))
    assert sorted(os.listdir(os.path.join(trained, "checkpoints"))) == [
        "best_model.pth", "checkpoint_epoch_0.pth", "checkpoint_epoch_2.pth"]
    with open(os.path.join(trained, "results", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    assert [h["epoch"] for h in history] == [0, 1, 2]
    assert {"epoch", "lr", "epoch_seconds", "total_loss", "recon_loss", "seg_loss",
            "val_loss", "val_accuracy", "val_auroc", "val_auprc"} <= set(history[0])
    with open(os.path.join(trained, "results", "training_results.json")) as f:
        results = json.load(f)
    assert len(results["train_losses"]) == len(results["val_losses"]) == 3
    assert results["interrupted"] is False and results["total_params"] > 0
    assert results["best_val_loss"] == min(results["val_losses"])
    assert os.path.getsize(os.path.join(trained, "results", "training_curves.png")) > 0
    blob = torch.load(os.path.join(trained, "checkpoints", "checkpoint_epoch_2.pth"),
                      weights_only=True)
    assert set(blob) == {"epoch", "model_state_dict", "optimizer_state_dict", "loss"}
    assert blob["epoch"] == 2
    model = build_model("anomaly_unet", base_features=4)
    model.load_state_dict(blob["model_state_dict"], strict=True)  # reference names


@pytest.mark.parametrize("mode", [[], ["--fold_bn"], ["--quantize", "int8"]])
def test_test_cli_modes(mvtec_root, trained, tmp_path, mode):
    best = os.path.join(trained, "checkpoints", "best_model.pth")
    ev = _test(mvtec_root, best, tmp_path, "--precision", "f32", "--save_visualizations",
               "--max_vis_samples", "3", *mode)
    out = tmp_path / "bottle_test_results"
    for name in ("test_metrics.json", "detailed_results.json", "confusion_matrix.png",
                 "visualizations.png"):
        assert (out / name).is_file(), name
    with open(out / "test_metrics.json") as f:
        saved = json.load(f)
    assert saved["image_metrics"] == ev["image_metrics"]
    assert set(saved["pixel_metrics"]) == {"threshold_0.3", "threshold_0.5", "threshold_0.7"}
    assert set(saved["type_metrics"]) == {"good", "broken"}
    with open(out / "detailed_results.json") as f:
        detailed = json.load(f)
    assert len(detailed["anomaly_scores"]) == len(detailed["image_paths"]) == 6
    assert all(0.0 <= v <= 1.0 for v in ev["image_metrics"].values())
    if mode:  # folded BN [rtol 1e-5] and int8 [rtol 0.1] score as the float model does
        _test(mvtec_root, best, tmp_path / "plain", "--precision", "f32")
        with open(tmp_path / "plain" / "bottle_test_results" / "detailed_results.json") as f:
            plain = json.load(f)["anomaly_scores"]
        rtol = 1e-5 if mode == ["--fold_bn"] else 0.1
        np.testing.assert_allclose(detailed["anomaly_scores"], plain, rtol=rtol)


def test_resume_continues_the_epoch_count(mvtec_root, trained, tmp_path):
    exp = _train(mvtec_root, tmp_path, "--resume",
                 os.path.join(trained, "checkpoints", "checkpoint_epoch_0.pth"))
    with open(os.path.join(exp, "results", "history.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [1, 2]
    blob = torch.load(os.path.join(exp, "checkpoints", "checkpoint_epoch_2.pth"),
                      weights_only=True)
    first = blob["optimizer_state_dict"]["state"][0]
    assert blob["epoch"] == 2 and int(first["step"]) == 3 * 2  # 3 epochs of 2 steps


def test_sigterm_saves_an_interrupt_checkpoint_and_exits_75(mvtec_root, tmp_path):
    save_dir = tmp_path / "out"
    cmd = [sys.executable, "-m", "tpu_unet_torch.cli.train_mvtec", "--data_root", mvtec_root,
           "--category", "bottle", "--epochs", "100000", "--val_freq", "1000",
           "--save_freq", "1000", "--precision", "f32", "--save_dir", str(save_dir), *SMALL]
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
    ck = os.path.join(exp, "checkpoints", "checkpoint_interrupt.pth")
    blob = torch.load(ck, weights_only=True)
    with open(os.path.join(exp, "results", "training_results.json")) as f:
        results = json.load(f)
    assert results["interrupted"] is True
    # The epoch field is the last completed epoch: --resume replays the cut one.
    assert blob["epoch"] == len(results["train_losses"]) - 1
    assert "SIGTERM received" in out


def test_sweep_summary(mvtec_root, tmp_path):
    summary = sweep_mvtec.main(["--data_root", mvtec_root, "--epochs", "1", "--precision",
                                "f32", "--save_dir", str(tmp_path / "runs"),
                                "--output_dir", str(tmp_path / "sweep"), *SMALL])
    assert set(summary) == {"args", "categories", "mean_image_auroc", "mean_image_auprc"}
    cat = summary["categories"]["bottle"]
    assert set(cat) == {"experiment_dir", "image_metrics", "pixel_metrics", "type_metrics"}
    assert summary["mean_image_auroc"] == cat["image_metrics"]["auroc"]
    with open(tmp_path / "sweep" / "sweep_summary.json") as f:
        assert json.load(f)["mean_image_auprc"] == summary["mean_image_auprc"]
    assert (tmp_path / "sweep" / "per_category" / "bottle_test_results"
            / "test_metrics.json").is_file()


def test_demo(tmp_path):
    out = tmp_path / "demo.png"
    assert demo.main(["--device", "cpu", "--output", str(out)]) is True
    assert out.stat().st_size > 0


def test_test_path_matches_jax(mvtec_root, monkeypatch):
    """The port's test_model + evaluate_results against the JAX package's on
    the same weights: scores [rtol 1e-4], the threshold [rtol 1e-4]; on this
    data the predictions and every metric are equal [exact]."""
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", False)
    monkeypatch.setattr(port_transforms, "_USE_NATIVE", False)
    torch.manual_seed(1)
    model = build_model("anomaly_unet", base_features=4)
    with torch.no_grad():  # BN statistics away from their init
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    state = create_train_state(model, "adam", 1e-3, 0.0, device="cpu")
    params, stats = jax_trees_from_state_dict(model.state_dict())
    jstate = JaxTrainState.create(apply_fn=jmodels.AnomalyUNet(base_features=4).apply,
                                  params=params, batch_stats=stats,
                                  tx=jax_optimizer("adam", 1e-3, 0.0))
    kw = dict(batch_size=4, pad_last=True, num_workers=2)
    ref = jax_test_cli.test_model(
        jax_eval_step(), jstate,
        JaxDataLoader(JaxMVTec(mvtec_root, "bottle", "test", 32, is_train=False,
                               disk_cache_dir=None), process_count=1, process_index=0, **kw))
    got = test_cli.test_model(make_anomaly_eval_step(), state,
                              DataLoader(MVTecDataset(mvtec_root, "bottle", "test", 32,
                                                      is_train=False),
                                         transform=lambda b: to_device(b, "cpu"), **kw))
    assert got["anomaly_types"] == ref["anomaly_types"]
    assert got["image_paths"] == ref["image_paths"]
    np.testing.assert_allclose(got["anomaly_scores"], ref["anomaly_scores"], rtol=1e-4)
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_array_equal(got["masks_true"], ref["masks_true"])
    for k in ("anomaly_maps", "reconstructions", "images"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
    ev_got = test_cli.evaluate_results(got, [0.3, 0.5, 0.7])
    ev_ref = jax_test_cli.evaluate_results(ref, [0.3, 0.5, 0.7])
    np.testing.assert_allclose(got["threshold"], ref["threshold"], rtol=1e-4)
    np.testing.assert_array_equal(got["predictions"], ref["predictions"])
    assert ev_got == ev_ref
    assert ev_got["pixel_metrics"] and ev_got["type_metrics"]


def test_clis_default_to_cuda(mvtec_root, tmp_path):
    """Nothing falls back to the CPU: without a GPU the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    args = ["--data_root", mvtec_root, "--category", "bottle"]
    with pytest.raises(RuntimeError, match="cuda"):
        train_mvtec.main(args + ["--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        train_mvtec.main(args + ["--save_dir", str(tmp_path), "--device", "auto"])
    with pytest.raises(RuntimeError, match="cuda"):
        test_cli.main(args + ["--checkpoint", "x.pth", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        demo.main(["--output", str(tmp_path / "d.png")])
    assert not os.listdir(tmp_path)  # raised before writing anything


@pytest.fixture(scope="module")
def bilinear_run(mvtec_root, tmp_path_factory):
    """A bilinear AnomalyUNet trained by the CLI for one epoch; its last
    checkpoint."""
    exp = _train(mvtec_root, tmp_path_factory.mktemp("bilinear"), "--bilinear", "--epochs", "1")
    return os.path.join(exp, "checkpoints", "checkpoint_epoch_0.pth")


@pytest.mark.parametrize("flag", [
    ["--n_devices", "2"], ["--fsdp"], ["--n_model", "2"], ["--multihost"],
    ["--coordinator_address", "localhost:1234"], ["--num_processes", "2"],
    ["--process_id", "0"], ["--bilinear"]])
def test_unported_train_flags_raise(mvtec_root, tmp_path, bilinear_run, flag):
    """The multi-device flags are ported (tests/test_torch_parallel_*.py run
    them on two ranks); here their parsing and refusals, before anything is
    written: ``--n_devices 2`` plans 2 ranks and refuses a global batch
    that does not split over them (and over ``--grad_accum``); ``--fsdp``
    on one device warns and trains whole; ``--n_model 2`` plans 2 ranks
    (one data rank times two model ranks) and refuses a batch that does not
    split over the data ranks and ``--grad_accum``
    (tests/test_torch_parallel_tensor_cli.py trains with it); a
    half-specified multi-host
    launch and ``--multihost`` outside torchrun or SLURM raise ValueError.
    ``--bilinear`` trains an AnomalyUNet whose decoders have no transposed
    conv (the reference's bilinear layout, loaded strict)."""
    if flag == ["--bilinear"]:
        sd = torch.load(bilinear_run, weights_only=True)["model_state_dict"]
        assert not any(k.endswith(".up.weight") for k in sd)
        build_model("anomaly_unet", base_features=4, bilinear=True).load_state_dict(
            sd, strict=True)
        return
    if flag == ["--fsdp"]:
        with pytest.warns(UserWarning, match="--fsdp requested on one device"):
            exp = _train(mvtec_root, tmp_path, *flag, "--epochs", "1")
        assert "checkpoint_epoch_0.pth" in os.listdir(os.path.join(exp, "checkpoints"))
        return
    if flag[0] == "--n_devices":
        args = train_mvtec.parse_args(["--device", "cpu", *flag])
        assert args.n_devices == 2 and train_mvtec.check_flags(args) == 2
        for bad in (["--batch_size", "3"], ["--batch_size", "4", "--grad_accum", "4"]):
            with pytest.raises(SystemExit, match="2 ranks"):
                _train(mvtec_root, tmp_path, *flag, *bad)
    elif flag[0] == "--n_model":
        args = train_mvtec.parse_args(["--device", "cpu", *flag])
        assert args.n_model == 2 and train_mvtec.check_flags(args) == 2
        with pytest.raises(SystemExit, match="1 ranks x --grad_accum 3"):
            _train(mvtec_root, tmp_path, *flag, "--grad_accum", "3")
    else:
        match = "coordinator_address" if flag[0] == "--num_processes" else (
            "torchrun" if flag == ["--multihost"] else "num_processes")
        with pytest.raises(ValueError, match=match):
            _train(mvtec_root, tmp_path, *flag)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flag", [["--n_devices", "2"], ["--bilinear"]])
def test_unported_test_flags_raise(mvtec_root, tmp_path, bilinear_run, flag):
    """``--n_devices`` is ported (tests/test_torch_parallel_cli_mvtec.py
    tests on two ranks): a batch that does not split over the ranks raises
    SystemExit, and on ``cuda`` without a GPU the ranks do not fall back to
    the CPU. ``--bilinear`` evaluates the bilinear checkpoint end to end (6
    test images scored)."""
    if flag[0] == "--n_devices":
        with pytest.raises(SystemExit, match="2 ranks"):
            _test(mvtec_root, "x.pth", tmp_path, *flag, "--batch_size", "3")
        with pytest.raises(RuntimeError, match="cuda"):
            test_cli.main(["--data_root", mvtec_root, "--checkpoint", "x.pth",
                           "--output_dir", str(tmp_path), *flag])
        assert not os.listdir(tmp_path)
        return
    ev = _test(mvtec_root, bilinear_run, tmp_path, "--precision", "f32", *flag)
    with open(tmp_path / "bottle_test_results" / "detailed_results.json") as f:
        assert len(json.load(f)["anomaly_scores"]) == 6
    assert all(0.0 <= v <= 1.0 for v in ev["image_metrics"].values())


@pytest.mark.parametrize("mode", [["--fold_bn"], ["--quantize", "int8"]])
def test_bilinear_test_modes(mvtec_root, bilinear_run, tmp_path, monkeypatch, mode):
    """The bilinear AnomalyUNet's test path with folded BN [rtol 1e-5] and in
    int8 [rtol 0.1, as test_test_cli_modes holds the ladder] scores as the
    f32 model does; the int8 path runs K2 26 times per batch (both
    decoders, the upsamples as float islands)."""
    from tpu_unet_torch.ops import quantize as tq

    calls = []
    real = tq._QuantExec.conv3x3
    monkeypatch.setattr(tq._QuantExec, "conv3x3",
                        staticmethod(lambda *a, **kw: calls.append(1) or real(*a, **kw)))
    scores = {}
    for name, extra in (("plain", []), ("mode", mode)):
        _test(mvtec_root, bilinear_run, tmp_path / name, "--precision", "f32", "--bilinear",
              *extra)
        with open(tmp_path / name / "bottle_test_results" / "detailed_results.json") as f:
            scores[name] = json.load(f)["anomaly_scores"]
    assert len(calls) == (26 * 2 if mode[0] == "--quantize" else 0)  # 6 images, batches of 4
    np.testing.assert_allclose(scores["mode"], scores["plain"],
                               rtol=1e-5 if mode == ["--fold_bn"] else 0.1)


def test_unknown_category_returns_none(mvtec_root, tmp_path):
    assert _train(mvtec_root, tmp_path, "--category", "cable") is None
    assert _test(mvtec_root, "x.pth", tmp_path, "--category", "cable") is None


def test_debug_subset_and_grad_accum(mvtec_root, tmp_path):
    exp = _train(mvtec_root, tmp_path, "--debug", "--debug_samples", "4", "--grad_accum",
                 "2", "--epochs", "1")
    with open(os.path.join(exp, "results", "history.jsonl")) as f:
        assert len(f.readlines()) == 1
    with pytest.raises(SystemExit):
        _train(mvtec_root, tmp_path, "--grad_accum", "3")
    subset = train_mvtec._Subset(list(range(10)), 4, 0)
    assert len(subset) == 4 and len(set(subset.indices)) == 4


def test_profile_dir_and_debug_nans(mvtec_root, tmp_path):
    """--profile_dir writes a torch.profiler trace of the only epoch;
    --debug_nans turns on autograd's anomaly mode."""
    try:
        _train(mvtec_root, tmp_path / "out", "--epochs", "1", "--profile_dir",
               str(tmp_path / "prof"), "--debug_nans")
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
