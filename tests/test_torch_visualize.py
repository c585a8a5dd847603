"""The port's viewers (tpu_unet_torch/cli/visualize_mvtec.py and
visualize_seg.py) on the CPU, on tiny ``.pth`` checkpoints (base 4, 32 px),
rendered headless with matplotlib's Agg backend: the PNGs they write,
checkpoint discovery, the interactive browser's navigation, UNet++'s pruned
head; and their collect halves against the functions the JAX viewers call,
with the same weights (carried by ``utils/weights.py::state_dict_from_jax``):
``make_anomaly_eval_step``'s outputs, and ``eval_transform``, apply, softmax
and argmax for Gear and KolektorSDD [rtol 1e-4, atol 1e-5; the argmax equal
wherever the top two probabilities are more than 1e-5 apart]."""

import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.data.transforms as jax_transforms
import tpu_unet.models as jmodels
import tpu_unet_torch.data.transforms as port_transforms
from _torch_parity import jax_variables, one_torch_thread, seeded_state_dict  # noqa: F401
from test_data import make_gear, make_kolektorsdd, make_mvtec
from tpu_unet.ops.augment import eval_transform as jax_eval_transform
from tpu_unet.train import make_anomaly_eval_step as jax_eval_step
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.cli import visualize_mvtec, visualize_seg
from tpu_unet_torch.models import build_model
from tpu_unet_torch.train.checkpoint import save_checkpoint
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.utils.weights import state_dict_from_jax

BASE = 4
CPU = ["--device", "cpu", "--num_workers", "2", "--base_features", str(BASE)]


@pytest.fixture(autouse=True)
def _native_resize(monkeypatch):
    monkeypatch.setattr(jax_transforms, "_USE_NATIVE", True)
    monkeypatch.setattr(port_transforms, "_USE_NATIVE", True)


def _checkpoint(path, name, seed=0, **kw):
    """A port ``.pth`` at ``path`` whose weights are seeded JAX variables
    carried by ``state_dict_from_jax``; returns the JAX variables."""
    variables = jax_variables(seeded_state_dict(name, seed, base_features=BASE, **kw), name)
    model = build_model(name, base_features=BASE, **kw)
    model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], model=name,
        deep_supervision=kw.get("deep_supervision", False)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_checkpoint(create_train_state(model, "adam", 1e-3, 0.0, device="cpu"), 0, 1.0, path)
    return variables


@pytest.fixture(scope="module")
def mvtec_root(tmp_path_factory):
    return make_mvtec(str(tmp_path_factory.mktemp("mv")), n_train=2, n_test_good=2,
                      n_broken=3, size=48)


@pytest.fixture(scope="module")
def gear_root(tmp_path_factory):
    return make_gear(str(tmp_path_factory.mktemp("gear")), n_per_split=3, size=48)


@pytest.fixture(scope="module")
def ksdd_root(tmp_path_factory):
    return make_kolektorsdd(str(tmp_path_factory.mktemp("ksdd")), n_folders=4, per_folder=4)


def test_visualize_mvtec_discovers_and_renders(mvtec_root, tmp_path):
    outputs = tmp_path / "outputs"
    ckpt = str(outputs / "bottle_anomaly_unet_20260101_000000" / "checkpoints"
               / "best_model.pth")
    _checkpoint(ckpt, "anomaly_unet")
    assert visualize_mvtec.discover_checkpoint(str(outputs), "bottle") == ckpt
    # Newest by mtime, and the model's own experiments first: an older plain
    # UNet experiment sorts after 'anomaly_unet' by name but must not win.
    stale = outputs / "bottle_unet_20250101_000000"
    shutil.copytree(outputs / "bottle_anomaly_unet_20260101_000000", stale)
    old = time.time() - 3600
    os.utime(stale, (old, old))
    stale_ckpt = str(stale / "checkpoints" / "best_model.pth")
    assert visualize_mvtec.discover_checkpoint(str(outputs), "bottle") == ckpt
    assert visualize_mvtec.discover_checkpoint(str(outputs), "bottle", "anomaly_unet") == ckpt
    assert visualize_mvtec.discover_checkpoint(str(outputs), "bottle", "unet") == stale_ckpt
    assert visualize_mvtec.discover_checkpoint(str(tmp_path / "none"), "bottle") is None

    out = visualize_mvtec.main([
        "--data_root", mvtec_root, "--category", "bottle", "--image_size", "32",
        "--outputs_dir", str(outputs), "--output_dir", str(tmp_path / "viz"),
        "--batch_size", "2", "--max_samples", "3", "--precision", "f32", *CPU])
    assert out == str(tmp_path / "viz")
    assert os.listdir(out) == ["bottle_panel_000.png"]
    assert os.path.getsize(os.path.join(out, "bottle_panel_000.png")) > 0
    assert visualize_mvtec.main([
        "--data_root", mvtec_root, "--outputs_dir", str(tmp_path / "empty"), *CPU]) is None


def test_visualize_mvtec_interactive_browser(mvtec_root, tmp_path):
    ckpt = str(tmp_path / "exp" / "checkpoints" / "best_model.pth")
    _checkpoint(ckpt, "anomaly_unet")
    browser = visualize_mvtec.main([
        "--data_root", mvtec_root, "--category", "bottle", "--image_size", "32",
        "--checkpoint", ckpt, "--batch_size", "2", "--max_samples", "3",
        "--precision", "f32", "--interactive", *CPU])
    assert len(browser.records) == 3 and browser.idx == 0
    browser.next()
    assert browser.idx == 1
    browser.prev()
    browser.prev()
    assert browser.idx == 2  # wraps backwards
    browser.next()
    assert browser.idx == 0  # and forwards
    title = browser.fig._suptitle.get_text()
    assert "Sample 1/3" in title and "score=" in title
    browser._on_key(type("E", (), {"key": "right"})())
    assert browser.idx == 1
    browser.info()
    assert set(browser.records[0]) == {"image", "mask", "anomaly_map", "reconstruction",
                                       "error_map", "score", "label", "anomaly_type",
                                       "image_path"}


def test_visualize_mvtec_records_match_the_jax_eval_step(mvtec_root, tmp_path):
    ckpt = str(tmp_path / "exp" / "checkpoints" / "best_model.pth")
    variables = _checkpoint(ckpt, "anomaly_unet", seed=3)
    args = visualize_mvtec.parse_args([
        "--data_root", mvtec_root, "--image_size", "32", "--checkpoint", ckpt,
        "--batch_size", "2", "--max_samples", "5", "--precision", "f32", *CPU])
    records = visualize_mvtec.collect_records(args, torch.device("cpu"))
    assert len(records) == 5  # the last batch padded: its pad row dropped
    from tpu_unet_torch.data.mvtec import MVTecDataset
    ds = MVTecDataset(mvtec_root, "bottle", "test", 32, is_train=False)
    samples = [ds.load(i) for i in range(5)]
    jstate = JaxTrainState.create(apply_fn=jmodels.AnomalyUNet(base_features=BASE).apply,
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  tx=jax_optimizer("adam", 1e-3, 0.0))
    out = jax_eval_step()(jstate, jnp.asarray(np.stack([s["image"] for s in samples])),
                          jnp.asarray(np.stack([s["mask"] for s in samples])))
    for i, r in enumerate(records):
        assert r["image_path"] == samples[i]["image_path"]
        assert r["label"] == int(samples[i]["label"])
        np.testing.assert_array_equal(r["mask"], samples[i]["mask"][..., 0])
        for k in ("image", "anomaly_map", "reconstruction", "error_map"):
            np.testing.assert_allclose(r[k], np.asarray(out[k])[i], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(r["score"], float(out["score"][i]), rtol=1e-4, atol=1e-5)


def _seg_flags(dataset, root):
    size = (["--image_size", "32"] if dataset == "gear"
            else ["--image_height", "32", "--image_width", "16"])
    return ["--dataset", dataset, "--data_root", root, *size]


def test_visualize_seg_gear_renders_every_figure(gear_root, tmp_path):
    ckpt = str(tmp_path / "exp" / "checkpoints" / "best_model.pth")
    _checkpoint(ckpt, "seg_unet", n_classes=4)
    out = visualize_seg.main([*_seg_flags("gear", gear_root), "--checkpoint", ckpt,
                              "--batch_size", "2", "--max_samples", "3",
                              "--precision", "f32", "--show_confidence",
                              "--grid_size", "1", "2", *CPU])
    assert out == str(tmp_path / "exp" / "visualizations")  # beside the checkpoints
    files = sorted(os.listdir(out))
    assert sum(f.startswith("prediction_") and f.endswith(".png") for f in files) == 3
    assert "predictions_grid.png" in files and "class_distribution.png" in files


@pytest.mark.parametrize("selectors,individual,grid", [
    (["--save_grid"], False, True), (["--save_individual"], True, False),
    (["--save_grid", "--always_save"], True, True)])
def test_visualize_seg_output_selection(ksdd_root, tmp_path, selectors, individual, grid):
    ckpt = str(tmp_path / "exp" / "checkpoints" / "best_model.pth")
    _checkpoint(ckpt, "seg_unet", n_classes=3)
    out = visualize_seg.main([*_seg_flags("kolektorsdd", ksdd_root), "--checkpoint", ckpt,
                              "--output_dir", str(tmp_path / "v"), "--batch_size", "2",
                              "--max_samples", "2", *selectors, *CPU])
    files = os.listdir(out)
    assert any(f.startswith("prediction_") for f in files) == individual
    assert ("predictions_grid.png" in files) == grid
    assert "class_distribution.png" in files


def test_visualize_seg_unetpp_deep_supervision_pruned_head(gear_root, tmp_path):
    ckpt = str(tmp_path / "exp" / "checkpoints" / "best_model.pth")
    _checkpoint(ckpt, "unetpp", n_classes=4, deep_supervision=True)
    out = visualize_seg.main([*_seg_flags("gear", gear_root), "--checkpoint", ckpt,
                              "--model", "unetpp", "--deep_supervision", "--heads", "1",
                              "--batch_size", "2", "--max_samples", "2",
                              "--precision", "f32", *CPU])
    assert "predictions_grid.png" in os.listdir(out)
    with pytest.raises(ValueError):  # --heads needs UNet++ with deep supervision
        visualize_seg.main([*_seg_flags("gear", gear_root), "--checkpoint", ckpt,
                            "--heads", "1", *CPU])


def test_viewers_default_to_cuda(gear_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    assert visualize_seg.parse_args(_seg_flags("gear", gear_root)
                                    + ["--checkpoint", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        visualize_seg.main([*_seg_flags("gear", gear_root), "--checkpoint", "x.pth"])
    with pytest.raises(RuntimeError, match="cuda"):
        visualize_mvtec.main(["--checkpoint", "x.pth"])
    with pytest.raises(NotImplementedError):
        visualize_mvtec.main(["--n_devices", "2", *CPU])


@pytest.mark.parametrize("dataset", ["gear", "kolektorsdd"])
def test_visualize_seg_samples_match_the_jax_inference(gear_root, ksdd_root, tmp_path,
                                                       dataset):
    root, c = (gear_root, 4) if dataset == "gear" else (ksdd_root, 3)
    ckpt = str(tmp_path / "exp" / "checkpoints" / "best_model.pth")
    variables = _checkpoint(ckpt, "seg_unet", seed=5, n_classes=c)
    args = visualize_seg.parse_args([*_seg_flags(dataset, root), "--checkpoint", ckpt,
                                     "--batch_size", "2", "--max_samples", "3",
                                     "--precision", "f32", *CPU])
    ds, num_classes, _, _ = visualize_seg.build_dataset(args)
    assert num_classes == c
    samples = visualize_seg.collect_samples(args, torch.device("cpu"), ds)
    assert len(samples) == 3
    images = np.stack([ds.load(i)["image"] for i in range(3)])
    model = jmodels.build_model("seg_unet", n_classes=c, base_features=BASE)

    @jax.jit
    def infer(images_u8):
        img = jax_eval_transform(images_u8)
        logits = model.apply(variables, img, train=False)
        probs = jax.nn.softmax(logits, axis=-1)
        return jnp.argmax(logits, axis=-1), jnp.max(probs, axis=-1), img, probs

    preds, conf, img, probs = (np.asarray(t) for t in infer(jnp.asarray(images)))
    for i, s in enumerate(samples):
        np.testing.assert_array_equal(s["mask"], ds.load(i)["mask"])
        np.testing.assert_allclose(s["image"], img[i], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(s["conf"], conf[i], rtol=1e-4, atol=1e-5)
        top2 = np.sort(probs[i], axis=-1)[..., -2:]
        decided = top2[..., 1] - top2[..., 0] > 1e-5
        np.testing.assert_array_equal(s["pred"][decided], preds[i][decided])
        assert decided.mean() > 0.99
