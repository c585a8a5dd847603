"""The port's epoch drivers (tpu_unet_torch/train/loop.py) and int8 eval step
(ops/quantize.py::make_quantized_anomaly_eval_step) against the JAX
package's, on the CPU at base_features=4, 32 px, batches of 2-3.

Both packages start from the same seeded weights (the port's init carried
over by ``utils/weights.py::jax_trees_from_state_dict``), read the same
in-memory dataset through their own loaders, and the port's step is fed the
draws of ``fold_in(fold_in(key(seed), epoch), i)``, the keys of JAX's loop.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tpu_unet.models as jmodels
from _torch_parity import jax_draws, one_torch_thread  # noqa: F401  (an autouse fixture)
from tpu_unet.data.loader import DataLoader as JaxDataLoader
from tpu_unet.ops.quantize import chunk_calibration as jax_chunks
from tpu_unet.ops.quantize import make_quantized_anomaly_eval_step as jax_qstep
from tpu_unet.ops.quantize import quantize_from_train_state as jax_ptq
from tpu_unet.train import make_anomaly_eval_step as jax_eval_step
from tpu_unet.train import make_anomaly_train_step as jax_train_step
from tpu_unet.train import make_optimizer as jax_optimizer
from tpu_unet.train.loop import train_anomaly_epoch as jax_train_epoch
from tpu_unet.train.loop import validate_anomaly_epoch as jax_validate
from tpu_unet.train.state import TrainState as JaxTrainState
from tpu_unet_torch.data.loader import DataLoader, to_device
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.quantize import make_quantized_anomaly_eval_step
from tpu_unet_torch.train import loop
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (AnomalyLossConfig, AugmentConfig,
                                        make_anomaly_eval_step, make_anomaly_train_step)
from tpu_unet_torch.utils.weights import jax_trees_from_state_dict, qparams_from_numpy

BASE, HW, LR, SEED = 4, 32, 0.05, 11
AUG, LOSS = AugmentConfig(), AnomalyLossConfig()


class _Split:
    """An in-memory MVTec-like split with the dataset's load(idx) contract."""

    def __init__(self, n, seed, anomalous=()):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)
        self.masks = np.zeros((n, HW, HW, 1), np.float32)
        self.labels = np.zeros(n, np.int32)
        for i in anomalous:
            y, x = rng.integers(2, HW - 12, 2)
            self.masks[i, y:y + 10, x:x + 8] = 1.0
            self.labels[i] = 1

    def __len__(self):
        return len(self.images)

    def load(self, i):
        return {"image": self.images[i], "mask": self.masks[i], "label": self.labels[i],
                "anomaly_type": "good" if self.labels[i] == 0 else "blob",
                "image_path": f"{i:03d}.png"}


@functools.lru_cache(maxsize=None)
def _init_sd():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return build_model("anomaly_unet", base_features=BASE).state_dict()


def _jax_state():
    params, stats = jax_trees_from_state_dict(_init_sd())
    return JaxTrainState.create(apply_fn=jmodels.AnomalyUNet(base_features=BASE).apply,
                                params=params, batch_stats=stats,
                                tx=jax_optimizer("sgd", LR, 1e-4))


def _to_cpu(batch):
    """The loaders' transform, as the trainer's: the batch on the state's device."""
    return to_device(batch, "cpu")


def _port_state():
    model = build_model("anomaly_unet", base_features=BASE)
    model.load_state_dict(_init_sd())
    return create_train_state(model, "sgd", LR, 1e-4, device="cpu")


class _JaxKeyedStep:
    """The port's train step fed the draws of JAX's loop keys; it also checks
    what the loop hands it: device tensors and the epoch's generator."""

    def __init__(self, seed):
        self.step = make_anomaly_train_step(LOSS, AUG)
        self.base = jax.random.key(seed)
        self.epoch, self.i, self.seen = 0, 0, []

    def start(self, epoch):
        self.epoch, self.i = epoch, 0

    def __call__(self, state, images, masks, generator):
        self.seen.append((type(images), images.device, type(masks), masks.device,
                          generator.device))
        key = jax.random.fold_in(jax.random.fold_in(self.base, self.epoch), self.i)
        self.i += 1
        return self.step.with_draws(state, images, masks, jax_draws(key, len(images), AUG))


@pytest.fixture(scope="module")
def trained():
    """2 epochs x 3 steps of f32 SGD in both packages, then both states."""
    ds = _Split(7, 1)
    kw = dict(batch_size=2, shuffle=True, seed=SEED, drop_last=True, num_workers=2)
    jloader = JaxDataLoader(ds, process_count=1, process_index=0, **kw)
    loader = DataLoader(ds, transform=_to_cpu, **kw)
    jstate, jstep = _jax_state(), jax_train_step(LOSS, AUG, donate_state=False)
    state, step = _port_state(), _JaxKeyedStep(SEED)
    jax_losses, port_losses = [], []
    for epoch in range(2):
        jstate, jm = jax_train_epoch(jstate, jstep, jloader, jax.random.key(SEED), epoch)
        step.start(epoch)
        port_losses.append(loop.train_anomaly_epoch(state, step, loader, SEED, epoch))
        jax_losses.append(jm)
    return dict(jax_losses=jax_losses, port_losses=port_losses, jstate=jstate,
                state=state, step=step)


def test_train_epochs_match_jax(trained):
    """The step-weighted epoch losses [rtol 1e-5]."""
    assert trained["step"].i == 3
    for jm, tm in zip(trained["jax_losses"], trained["port_losses"]):
        assert set(tm) == {"total_loss", "recon_loss", "seg_loss"}
        for k in tm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    assert trained["state"].step == 6


def test_steps_receive_device_tensors(trained):
    """No step is handed a numpy batch: the loop passes on the loader's
    to_device batches, and the generator lives on the state's device."""
    for img_t, img_dev, msk_t, msk_dev, gen_dev in trained["step"].seen:
        assert img_t is torch.Tensor and msk_t is torch.Tensor
        assert img_dev == msk_dev == gen_dev == trained["state"].device


def test_epoch_generator_is_seeded_by_seed_and_epoch():
    a = torch.rand(3, generator=loop.epoch_generator(1, 2, "cpu"))
    assert torch.equal(a, torch.rand(3, generator=loop.epoch_generator(1, 2, "cpu")))
    assert not torch.equal(a, torch.rand(3, generator=loop.epoch_generator(1, 3, "cpu")))
    assert not torch.equal(a, torch.rand(3, generator=loop.epoch_generator(2, 2, "cpu")))


@pytest.fixture(scope="module")
def validated(trained):
    """Validation on the trained weights, 7 images in batches of 3: the last
    batch is padded (1 valid row)."""
    ds = _Split(7, 2, anomalous=(1, 4, 6))
    kw = dict(batch_size=3, pad_last=True, num_workers=2)
    ref = jax_validate(trained["jstate"], jax_eval_step(LOSS),
                       JaxDataLoader(ds, process_count=1, process_index=0, **kw))
    loader = DataLoader(ds, transform=_to_cpu, **kw)
    got = loop.validate_anomaly_epoch(trained["state"], make_anomaly_eval_step(LOSS), loader)
    return ref, got


def test_validation_matches_jax(validated):
    """Losses [rtol 1e-5], scores [rtol 1e-4]; on this data the threshold
    [rtol 1e-4], the image and pixel metrics are equal [exact]."""
    ref, got = validated
    for k in ("total_loss", "recon_loss", "seg_loss"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    gp, rp = got["predictions"], ref["predictions"]
    assert gp["scores"].dtype == np.float32 and len(gp["scores"]) == 7
    np.testing.assert_allclose(gp["scores"], rp["scores"], rtol=1e-4)
    np.testing.assert_array_equal(gp["labels"], rp["labels"])
    np.testing.assert_array_equal(gp["masks_true"], rp["masks_true"])
    np.testing.assert_allclose(gp["masks_pred"], rp["masks_pred"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.percentile(gp["scores"], 95),
                               np.percentile(rp["scores"], 95), rtol=1e-4)
    assert got["image_metrics"] == ref["image_metrics"]
    assert got["pixel_metrics"] == ref["pixel_metrics"] and got["pixel_metrics"]


def test_validation_loss_covers_valid_rows_only(trained, validated):
    _, got = validated
    ds = _Split(7, 2, anomalous=(1, 4, 6))
    one_batch = DataLoader(ds, batch_size=7, num_workers=1, transform=_to_cpu)
    whole = loop.validate_anomaly_epoch(trained["state"], make_anomaly_eval_step(LOSS),
                                        one_batch)
    np.testing.assert_allclose(got["total_loss"], whole["total_loss"], rtol=1e-6)
    np.testing.assert_allclose(got["predictions"]["scores"], whole["predictions"]["scores"],
                               rtol=1e-6)


def test_all_normal_and_empty_validation(trained):
    step = make_anomaly_eval_step(LOSS)
    normal = loop.validate_anomaly_epoch(
        trained["state"], step,
        DataLoader(_Split(4, 3), batch_size=3, pad_last=True, transform=_to_cpu))
    assert normal["image_metrics"] == {"accuracy": 1.0, "precision": 0.0, "recall": 0.0,
                                       "specificity": 1.0, "f1_score": 0.0, "auroc": 0.0,
                                       "auprc": 0.0}
    assert normal["pixel_metrics"] == {} and len(normal["predictions"]["labels"]) == 4
    empty = loop.validate_anomaly_epoch(trained["state"], step,
                                        DataLoader(_Split(0, 3), batch_size=3,
                                                   transform=_to_cpu))
    assert empty["total_loss"] == 0.0 and empty["image_metrics"] == {}
    assert empty["predictions"]["scores"].shape == (0,)


def test_should_stop_ends_the_epoch_early():
    state = _port_state()
    step = make_anomaly_train_step(LOSS, AUG)
    loader = DataLoader(_Split(8, 4), batch_size=2, shuffle=True, seed=0, drop_last=True)
    calls = []
    out = loop.train_anomaly_epoch(state, step, loader, 0, 0,
                                   should_stop=lambda: calls.append(1) or len(calls) > 2)
    assert state.step == 2 and np.isfinite(out["total_loss"])
    out = loop.train_anomaly_epoch(state, step, loader, 0, 1, should_stop=lambda: True)
    assert out == {"total_loss": 0.0, "recon_loss": 0.0, "seg_loss": 0.0} and state.step == 2


def test_progress_reads_only_lagged_steps():
    for every in (1, 2, 3):
        lines = []
        prog = loop._Progress(lines.append, every, n_total=7)
        counts = []
        for i in range(7):
            prog.record(i, torch.tensor(float(i)))
            counts.append(2)
            prog.tick(i, counts)
        ticks = [i for i in range(7) if (i + 1) % every == 0 and min(i + 1 - every, i - 1) >= 0]
        read = [float(line.split("loss ")[1].split()[0]) for line in lines]
        assert read == [float(min(i + 1 - every, i - 1)) for i in ticks]
        assert all(r < i for r, i in zip(read, ticks))  # never the step just launched
        assert all(line.startswith(f"  step {i + 1}/7:") for line, i in zip(lines, ticks))
        assert all(j % every == 0 for j in prog._losses)  # only steps a line reads
    quiet = loop._Progress(lines.append, 0, None)
    quiet.record(0, torch.tensor(1.0))
    assert quiet.fn is None and quiet._losses == {}


def test_progress_lines_from_the_epoch_driver():
    lines = []
    loop.train_anomaly_epoch(_port_state(), make_anomaly_train_step(LOSS, AUG),
                             DataLoader(_Split(6, 5), batch_size=2, drop_last=True), 0, 0,
                             progress_fn=lines.append, progress_every=1,
                             log_fn=lines.append)
    assert [line.split(":")[0] for line in lines[:2]] == ["  step 2/3", "  step 3/3"]
    assert lines[-1].startswith("Epoch 0: loss")


def test_fetch_scalars_is_one_float64_table():
    per_batch = [{"total_loss": torch.tensor(0.5), "seg_loss": torch.tensor(0.25)},
                 {"total_loss": torch.tensor(1.5), "seg_loss": torch.tensor(0.75)}]
    out = loop._fetch_scalars(per_batch)
    assert out["total_loss"].dtype == np.float64
    np.testing.assert_array_equal(out["total_loss"], [0.5, 1.5])
    np.testing.assert_array_equal(out["seg_loss"], [0.25, 0.75])


def test_quantized_eval_step_matches_jax(trained):
    """The int8 eval step on qparams calibrated by the JAX package: scores
    [rtol 1e-4, as tests/test_torch_serve.py: JAX's jit flips about 0.5% of
    int8 activations by one step], losses [rtol 1e-3], the full two-decoder
    outputs and padded rows kept out of the loss."""
    jstate = trained["jstate"]
    ds = _Split(8, 6, anomalous=(2, 5))
    calib = ds.images[:8]
    jq = jax.device_get(jax_ptq("anomaly_unet", jstate.params, jstate.batch_stats,
                                jax_chunks(calib, 4)))
    images, masks = ds.images[:4], ds.masks[:4]
    valid = np.asarray([1, 1, 1, 0], np.float32)
    ref = jax_qstep()(jq, images, masks, valid)
    qp = qparams_from_numpy(jq)
    step = make_quantized_anomaly_eval_step()
    got = step(qp, images, masks, valid)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(ref["score"]), rtol=1e-4)
    for k in ("total_loss", "recon_loss", "seg_loss"):
        np.testing.assert_allclose(float(got["losses"][k]), float(ref["losses"][k]),
                                   rtol=1e-3, err_msg=k)
    for k in ("error_map", "anomaly_map", "reconstruction", "image"):
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
    # XLA fuses the jitted normalize into other arithmetic: ulps [atol 1e-6].
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref["image"]), rtol=0,
                               atol=1e-6)
    again = step(qp, torch.from_numpy(images[:3]), torch.from_numpy(masks[:3]))
    np.testing.assert_allclose(float(again["losses"]["total_loss"]),
                               float(got["losses"]["total_loss"]), rtol=1e-6)
