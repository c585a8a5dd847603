"""The port's seg epoch drivers (tpu_unet_torch/train/loop.py::train_seg_epoch,
validate_seg_epoch) and int8 seg eval step
(ops/quantize.py::make_quantized_seg_eval_step) against the JAX package's,
on the CPU at base_features=4, KolektorSDD-like 64 x 32 batches of 2-3.

Both packages start from the same seeded weights, read the same in-memory
split through their own loaders, and the port's step is fed the augment
draws and dropout masks of ``fold_in(fold_in(key(seed), epoch), i)``, the
keys of JAX's loop.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_unet.models as jmodels
from _torch_parity import (jax_draws, jax_dropout_keep, one_torch_thread,  # noqa: F401
                           seg_batch)
from tpu_unet.data.loader import DataLoader as JaxDataLoader
from tpu_unet.losses.segmentation import combined_segmentation_loss as jax_loss
from tpu_unet.ops import quantize as jq
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train import make_seg_eval_step as jax_eval_step
from tpu_unet.train import make_seg_train_step as jax_train_step
from tpu_unet.train.loop import train_seg_epoch as jax_train_epoch
from tpu_unet.train.loop import validate_seg_epoch as jax_validate
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops import quantize as tq
from tpu_unet_torch.ops.quantize import make_quantized_seg_eval_step
from tpu_unet_torch.train import loop
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (AugmentConfig, SegLossConfig, make_seg_eval_step,
                                        make_seg_train_step)
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict, qparams_from_numpy

BASE, C, LR, SEED = 4, 3, 0.05, 5
AUG = AugmentConfig(degrees=5.0, brightness=0.1, contrast=0.1, saturation=0.1, hue=0.05)
LOSS = SegLossConfig(class_weights=(1.0, 50.0, 50.0))


class _Split:
    """An in-memory KolektorSDD-like split with the datasets' load(idx) contract."""

    def __init__(self, n, seed):
        self.images, self.labels = seg_batch(seed, n=n, h=64, w=32, num_classes=C)

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return {"image": self.images[i], "mask": self.labels[i], "image_path": f"{i:03d}.jpg"}


@functools.lru_cache(maxsize=None)
def _init_sd():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return build_model("seg_unet", n_classes=C, base_features=BASE).state_dict()


def _jax_variables():
    params, stats = jax_trees_from_state_dict(_init_sd(), model="seg_unet")
    return {"params": params, "batch_stats": stats}


def _jax_state():
    v = _jax_variables()
    return JaxTrainState.create(apply_fn=jmodels.SegmentationUNet(n_classes=C,
                                                                  base_features=BASE).apply,
                                params=v["params"], batch_stats=v["batch_stats"],
                                tx=jax_optimizer("sgd", LR, 1e-4))


def _port_state():
    model = build_model("seg_unet", n_classes=C, base_features=BASE)
    model.load_state_dict(_init_sd())
    return create_train_state(model, "sgd", LR, 1e-4, device="cpu")


def _to_cpu(batch):
    """The loaders' transform, as the trainer's: the batch on the state's device."""
    return to_device(batch, "cpu")


class _JaxKeyedStep:
    """The port's seg train step fed the augment draws and dropout masks of
    JAX's loop keys; it also checks that the loop hands it device tensors."""

    def __init__(self, seed):
        self.step = make_seg_train_step(C, LOSS, AUG)
        self.base = jax.random.key(seed)
        self.apply = jmodels.SegmentationUNet(n_classes=C, base_features=BASE).apply
        self.epoch, self.i, self.seen = 0, 0, []

    def start(self, epoch):
        self.epoch, self.i = epoch, 0

    def __call__(self, state, images, labels, generator):
        self.seen.append((type(images), type(labels), labels.dtype, generator.device))
        key = jax.random.fold_in(jax.random.fold_in(self.base, self.epoch), self.i)
        self.i += 1
        k_aug, k_drop = jax.random.split(key)
        keep = jax_dropout_keep(self.apply, _jax_variables(), tuple(images.shape), k_drop)
        return self.step.with_draws(state, images, labels, jax_draws(k_aug, len(images), AUG),
                                    keep)


@pytest.fixture(scope="module")
def trained():
    """2 epochs x 3 steps of f32 SGD in both packages, with progress lines."""
    ds = _Split(7, 1)
    kw = dict(batch_size=2, shuffle=True, seed=SEED, drop_last=True, num_workers=2)
    jloader = JaxDataLoader(ds, process_count=1, process_index=0, **kw)
    loader = DataLoader(ds, transform=_to_cpu, **kw)
    jstate = _jax_state()
    jstep = jax_train_step(C, LOSS, AUG, donate_state=False)
    state, step = _port_state(), _JaxKeyedStep(SEED)
    out = {"jax": [], "port": [], "jax_lines": [], "port_lines": []}
    for epoch in range(2):
        jstate, jm, jcm = jax_train_epoch(jstate, jstep, jloader, jax.random.key(SEED), epoch,
                                          C, progress_fn=out["jax_lines"].append,
                                          progress_every=1)
        step.start(epoch)
        tm, tcm = loop.train_seg_epoch(state, step, loader, SEED, epoch, C,
                                       progress_fn=out["port_lines"].append, progress_every=1)
        out["jax"].append((jm, jcm))
        out["port"].append((tm, tcm))
    return dict(out, jstate=jstate, state=state, step=step)


def test_train_epochs_match_jax(trained):
    """The step-weighted epoch losses [rtol 1e-5] and the epoch's confusion
    matrix, fetched once as a host int64 array. A single step's matrix is
    exact (tests/test_torch_seg_steps.py); over 6 SGD steps the two
    packages' parameters drift apart by about 1e-6, enough to flip a pixel
    whose top two logits nearly tie, so at most 2 of the 12,288 pixels of an
    epoch may move to a neighbouring cell."""
    assert trained["step"].i == 3 and trained["state"].step == 6
    for (jm, jcm), (tm, tcm) in zip(trained["jax"], trained["port"]):
        assert set(tm) == set(jm) == {"ce_loss", "dice_loss", "total_loss"}
        for k in tm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
        assert tcm.confusion_matrix.dtype == np.int64
        assert tcm.confusion_matrix.sum() == jcm.confusion_matrix.sum() == 3 * 2 * 64 * 32
        np.testing.assert_array_equal(tcm.confusion_matrix.sum(1), jcm.confusion_matrix.sum(1))
        assert np.abs(tcm.confusion_matrix - jcm.confusion_matrix).sum() <= 4


def test_progress_lines_carry_the_lagged_running_miou(trained):
    """One line per step after the first, each with the loss and running
    mIoU of the step before it: JAX's figures [to the printed 4 decimals]."""
    def numbers(lines):
        return [tuple(float(v) for v in re.findall(r"(?:loss|mIoU) ([0-9.]+)", line))
                for line in lines]
    got, want = numbers(trained["port_lines"]), numbers(trained["jax_lines"])
    assert len(got) == len(want) == 4 and all(len(g) == 2 for g in got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4)


def test_steps_receive_device_tensors(trained):
    """The loop passes on the loader's to_device batches (uint8 labels, cast
    inside the step) and the epoch's generator on the state's device."""
    for img_t, lbl_t, lbl_dtype, gen_dev in trained["step"].seen:
        assert img_t is torch.Tensor and lbl_t is torch.Tensor
        assert lbl_dtype == torch.uint8 and gen_dev == trained["state"].device


@pytest.fixture(scope="module")
def validated(trained):
    """Validation of the trained weights: 7 images in batches of 3, the last
    padded (1 valid row)."""
    ds = _Split(7, 2)
    kw = dict(batch_size=3, pad_last=True, num_workers=2)
    ref = jax_validate(trained["jstate"], jax_eval_step(C, LOSS),
                       JaxDataLoader(ds, process_count=1, process_index=0, **kw), C)
    got = loop.validate_seg_epoch(trained["state"], make_seg_eval_step(C, LOSS),
                                  DataLoader(ds, transform=_to_cpu, **kw), C)
    return ref, got


def test_validation_matches_jax(validated):
    """Losses weighted by valid rows [rtol 1e-5]; the matrix, padded rows
    left out on the device, equals JAX's host-side one [exact]."""
    (jl, jm), (tl, tm) = validated
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-5, err_msg=k)
    assert tm.confusion_matrix.sum() == 7 * 64 * 32
    np.testing.assert_array_equal(tm.confusion_matrix, jm.confusion_matrix)
    assert tm.compute_all_metrics()["mean_iou"] == jm.compute_all_metrics()["mean_iou"]


def test_validation_loss_covers_valid_rows_only(trained, validated):
    """The padded batch's rows count nowhere: the loss is the mean of the
    three real sub-batches' losses weighted 3, 3, 1 [rtol 1e-6], and the
    matrix that of the 7 images in one batch [exact]."""
    _, (tl, tm) = validated
    ds, step = _Split(7, 2), make_seg_eval_step(C, LOSS)
    parts = [step(trained["state"], ds.images[a:b], ds.labels[a:b])[0]["total_loss"]
             for a, b in ((0, 3), (3, 6), (6, 7))]
    want = (3 * float(parts[0]) + 3 * float(parts[1]) + float(parts[2])) / 7
    np.testing.assert_allclose(tl["total_loss"], want, rtol=1e-6)
    whole = loop.validate_seg_epoch(trained["state"], step,
                                    DataLoader(ds, batch_size=7, num_workers=1,
                                               transform=_to_cpu), C)
    np.testing.assert_array_equal(tm.confusion_matrix, whole[1].confusion_matrix)


def test_should_stop_empty_validation_and_no_confusion():
    state = _port_state()
    step = make_seg_train_step(C, LOSS, AUG, with_confusion=False)
    loader = DataLoader(_Split(6, 3), batch_size=2, shuffle=True, seed=0, drop_last=True)
    calls = []
    out, metrics = loop.train_seg_epoch(state, step, loader, 0, 0,
                                        C, should_stop=lambda: calls.append(1) or len(calls) > 2)
    assert state.step == 2 and np.isfinite(out["total_loss"])
    assert metrics.confusion_matrix.sum() == 0  # the step made none
    out, _ = loop.train_seg_epoch(state, step, loader, 0, 1, C, should_stop=lambda: True)
    assert out == {} and state.step == 2
    empty = loop.validate_seg_epoch(state, make_seg_eval_step(C, LOSS),
                                    DataLoader(_Split(0, 3), batch_size=3), C)
    assert empty[0] == {} and empty[1].confusion_matrix.sum() == 0


def _confusion(preds, labels, c):
    return np.bincount(labels.ravel() * c + preds.ravel(), minlength=c * c).reshape(c, c)


def test_quantized_seg_eval_step_matches_the_op_by_op_path(monkeypatch):
    """The int8 seg eval step on JAX-calibrated qparams: its predictions and
    matrix equal those of JAX's op-by-op int8 forward (``_QuantExec``, which
    the port follows bit for bit) [exact]; the losses within 1e-5; 18 3x3
    convs per batch."""
    c = C
    jstate = _jax_state()
    images, labels = seg_batch(7, num_classes=c)
    calib = seg_batch(8, n=8, num_classes=c)[0]
    jqp = jax.device_get(jq.quantize_from_train_state("seg_unet", jstate.params,
                                                      jstate.batch_stats,
                                                      jq.chunk_calibration(calib, 8)))
    logits = np.asarray(jq._run(jq._QuantExec(jqp), jq.eval_transform(jnp.asarray(images)),
                                jq.build_plan("seg_unet")))
    preds = logits.argmax(-1)
    valid = np.asarray([1, 1, 0, 1], np.float32)
    calls = []
    real = tq._QuantExec.conv3x3

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tq._QuantExec, "conv3x3", staticmethod(counting))
    tl, tp, tcm = make_quantized_seg_eval_step(c, LOSS)(qparams_from_numpy(jqp), images,
                                                             labels, valid)
    assert len(calls) == 18
    np.testing.assert_array_equal(tp.numpy(), preds)
    keep = valid.astype(bool)
    np.testing.assert_array_equal(tcm.numpy(), _confusion(preds[keep], labels[keep], c))
    want = jax_loss(jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
                 sample_weight=jnp.asarray(valid), **LOSS.kwargs())
    for k in want:
        np.testing.assert_allclose(float(tl[k]), float(want[k]), rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="heads"):  # JAX's check of UNet++'s head
        make_quantized_seg_eval_step(c, arch="unetpp", deep_supervision=True, heads=5)
