"""The port's checkpoints (tpu_unet_torch/train/checkpoint.py) and SIGTERM
latch (train/interrupt.py), on the CPU at base_features=4, 32 px: the
reference's ``.pth`` layout, exact round trips of parameters, BatchNorm
statistics and optimizer state, the async writer and checkpoint lookup."""

import os
import signal

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, u8_batch  # noqa: F401  (an autouse fixture)
from tpu_unet_torch.models import build_model
from tpu_unet_torch.train.checkpoint import (CheckpointWriter, find_best_checkpoint,
                                             load_checkpoint, load_params, save_checkpoint)
from tpu_unet_torch.train.interrupt import (INTERRUPT_EXIT_CODE, GracefulInterrupt,
                                            interrupt_checkpoint_path)
from tpu_unet_torch.train.optim import make_optimizer
from tpu_unet_torch.train.state import TrainState, create_train_state
from tpu_unet_torch.train.steps import make_anomaly_train_step

BASE = 4


def _state(opt="adam", seed=0):
    torch.manual_seed(seed)
    return create_train_state(build_model("anomaly_unet", base_features=BASE), opt,
                              1e-3, 1e-4, device="cpu")


def _steps(state, n, seed=0):
    img, mask = u8_batch(0, n=2)
    step = make_anomaly_train_step()
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        step(state, img, mask, g)


def _assert_same(a, b):
    """Two states hold the same parameters, buffers and optimizer state, bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k])), (i, k)
    assert [{k: v for k, v in g.items() if k != "params"} for g in oa["param_groups"]] == \
        [{k: v for k, v in g.items() if k != "params"} for g in ob["param_groups"]]


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd"])
def test_round_trip_then_one_step_is_exact(tmp_path, opt):
    """Save after 2 steps, load into a state with other weights: the same
    parameters, BN statistics and optimizer state, and one more step from
    either gives the same bits [exact]."""
    a = _state(opt)
    _steps(a, 2)
    path = str(tmp_path / "ck.pth")
    save_checkpoint(a, 3, 0.25, path)
    blob = torch.load(path, weights_only=True)
    assert set(blob) == {"epoch", "model_state_dict", "optimizer_state_dict", "loss"}
    assert (blob["epoch"], blob["loss"]) == (3, 0.25)
    b = _state(opt, seed=1)
    _, epoch, loss = load_checkpoint(b, path)
    assert (epoch, loss) == (3, 0.25)
    _assert_same(a, b)
    _steps(a, 1, seed=5)
    _steps(b, 1, seed=5)
    _assert_same(a, b)
    if opt != "sgd":
        assert int(b.optimizer.state[next(b.model.parameters())]["step"]) == 3


def test_async_writer_snapshots_before_returning(tmp_path):
    a = _state()
    _steps(a, 1)
    before = {k: v.clone() for k, v in a.model.state_dict().items()}
    path = str(tmp_path / "best_model.pth")
    with CheckpointWriter() as w:
        w.save(a, 0, 1.5, path)
        _steps(a, 1)  # updates the state in place while the write may run
        w.save(a, 1, 1.0, str(tmp_path / "checkpoint_epoch_1.pth"))
        w.wait()
        assert [os.path.basename(x["path"]) for x in w.writes] == [
            "best_model.pth", "checkpoint_epoch_1.pth"]
        assert all(x["bytes"] == os.path.getsize(x["path"]) and x["seconds"] >= 0
                   for x in w.writes)
    saved = torch.load(path, weights_only=True)["model_state_dict"]
    for k, v in before.items():
        assert torch.equal(saved[k], v), k
    assert not torch.equal(saved["inc.double_conv.0.weight"],
                           a.model.state_dict()["inc.double_conv.0.weight"])
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".staging")]
    c = _state(seed=2)
    load_checkpoint(c, str(tmp_path / "checkpoint_epoch_1.pth"))
    _assert_same(a, c)


def test_failed_write_raises_on_close(tmp_path):
    a = _state()
    w = CheckpointWriter()
    w.save(a, 0, 0.0, str(tmp_path / "missing_dir" / "x.pth"))
    with pytest.raises(RuntimeError, match="missing_dir"):  # torch.save's error
        w.close()


def test_find_best_checkpoint_order(tmp_path):
    exp = tmp_path / "exp"
    assert find_best_checkpoint(str(exp)) is None
    ck = exp / "checkpoints"
    ck.mkdir(parents=True)
    assert find_best_checkpoint(str(exp)) is None
    a = _state()
    for name in ("checkpoint_epoch_2.pth", "checkpoint_epoch_10.pth"):
        save_checkpoint(a, 0, 0.0, str(ck / name))
    # Leftovers of an interrupted write and unrelated files are never picked.
    (ck / "checkpoint_epoch_99.pth.staging").write_bytes(b"partial")
    (ck / "best_model.pth.staging").write_bytes(b"partial")
    (ck / "checkpoint_epoch_x.pth").write_bytes(b"")
    assert find_best_checkpoint(str(exp)) == str(ck / "checkpoint_epoch_10.pth")
    save_checkpoint(a, 0, 0.0, str(ck / "best_model.pth"))
    assert find_best_checkpoint(str(exp)) == str(ck / "best_model.pth")


def test_load_params_takes_a_bare_reference_state_dict(tmp_path):
    ref = _state(seed=3)
    _steps(ref, 1)
    path = str(tmp_path / "bare.pth")
    torch.save(ref.model.state_dict(), path)  # the reference's model file
    b = _state(seed=4)
    opt_before = b.optimizer.state_dict()
    load_params(b, path)
    for k, v in ref.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    _, epoch, loss = load_checkpoint(b, path)  # no optimizer state: kept as is
    assert (epoch, loss) == (-1, 0.0) and b.optimizer.state_dict() == opt_before
    sd = ref.model.state_dict()
    sd.pop("inc.double_conv.1.running_var")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="running_var"):  # strict=True
        load_params(b, path)


def test_load_keeps_the_optimizer_implementation(tmp_path):
    """A file written by fused Adam (on the card) loads into the CPU's Adam
    without switching it to the fused implementation, and back."""
    a = _state()
    _steps(a, 1)
    path = str(tmp_path / "ck.pth")
    save_checkpoint(a, 0, 0.0, path)
    blob = torch.load(path, weights_only=True)
    for g in blob["optimizer_state_dict"]["param_groups"]:
        g["fused"] = True
    torch.save(blob, path)
    b = _state(seed=1)
    flags = {k: b.optimizer.param_groups[0].get(k) for k in ("fused", "foreach")}
    load_checkpoint(b, path)
    assert {k: b.optimizer.param_groups[0].get(k) for k in ("fused", "foreach")} == flags
    _steps(a, 1, seed=2)
    _steps(b, 1, seed=2)
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k


def test_graceful_interrupt_latches_sigterm(tmp_path):
    previous = signal.getsignal(signal.SIGTERM)
    with GracefulInterrupt() as intr:
        stop = intr.step_poll()
        assert not stop() and not intr.poll_global()
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop() and intr.poll_global() and intr.triggered
    assert signal.getsignal(signal.SIGTERM) == previous
    assert INTERRUPT_EXIT_CODE == 75
    assert interrupt_checkpoint_path(str(tmp_path)) == str(tmp_path / "checkpoint_interrupt.pth")
    assert np.isfinite(INTERRUPT_EXIT_CODE)


def test_loaded_moments_take_their_parameters_strides(tmp_path):
    """Fused Adam refuses a moment laid out unlike its parameter. On CUDA the
    port's model is channels_last while a file holds contiguous tensors, so
    the loaded moments get their parameters' strides back."""
    def channels_last_state(seed):
        torch.manual_seed(seed)
        model = build_model("anomaly_unet", base_features=BASE).to(
            memory_format=torch.channels_last)
        return TrainState(model, make_optimizer(model.parameters(), "adam", 1e-3, 1e-4))

    a = channels_last_state(0)
    _steps(a, 1)
    path = str(tmp_path / "ck.pth")
    save_checkpoint(a, 0, 0.0, path)
    # Contiguous moments, as in a reference file or the writer's CUDA snapshot.
    blob = torch.load(path, weights_only=True)
    for st in blob["optimizer_state_dict"]["state"].values():
        st.update({k: v.contiguous() for k, v in st.items()})
    torch.save(blob, path)
    b = channels_last_state(1)
    load_checkpoint(b, path)
    params = list(b.model.parameters())
    assert any(not p.is_contiguous() for p in params)  # the 4-D conv kernels
    for p in params:
        for k in ("exp_avg", "exp_avg_sq"):
            assert b.optimizer.state[p][k].stride() == p.stride(), k
    _steps(a, 1, seed=4)
    _steps(b, 1, seed=4)
    _assert_same(a, b)
