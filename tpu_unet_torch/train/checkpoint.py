"""Checkpoints in the reference's ``.pth`` layout (counterpart of
``tpu_unet/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file holding ``{epoch, model_state_dict,
optimizer_state_dict, loss}``, the reference trainer's layout, so its files
and this port's load in either. The trainer keeps:

- ``best_model.pth``, saved whenever the validation loss improves;
- ``checkpoint_epoch_{N}.pth`` every ``--save_freq`` epochs;
- ``checkpoint_interrupt.pth`` on SIGTERM (``train/interrupt.py``);

and ``--resume <path>`` restores the model, its BatchNorm statistics and the
optimizer, and continues at epoch + 1. Loading maps every tensor to the
state's device, so a file written on the card loads on the CPU and back.
The optimizer keeps its own implementation flags across a load (fused Adam on
CUDA, the plain one on the CPU): ``Optimizer.load_state_dict`` would
otherwise take them from the file.

Under a data-parallel process group rank 0 writes and barriers surround the
write; under FSDP every rank first joins the gather of each sharded tensor
(:func:`_whole`), and under tensor parallelism the gather of each
channel slice over 'model' (``parallel/tensor.py::full_tensors``), so the
file holds whole tensors in the reference layout. A checkpoint thus
restores at any world size and mesh: every rank loads the whole file before
the state is placed on the mesh (``parallel/fsdp.py::shard_state``), which
shards the parameters and the moments again; a tensor-parallel state
already placed takes its slices of the file (``local_tensors``).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import re
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_unet_torch.parallel.mesh import barrier, is_main_process
from tpu_unet_torch.parallel.tensor import full_tensors, local_tensors
from tpu_unet_torch.train.state import TrainState

_IMPL_FLAGS = ("fused", "foreach", "capturable", "differentiable")
_EPOCH_FILE = re.compile(r"^checkpoint_epoch_(\d+)\.pth$")


def _whole(t) -> torch.Tensor:
    """A DTensor's whole tensor: each rank's shard of a 1-D mesh (FSDP2's
    placement), or of the shard dim of a (space, data) mesh whose other dim
    replicates (FSDP2's hybrid placement under 'space'), gathered with c10d's
    all_gather over that dim's group. (Its ``full_tensor()`` runs a
    functional collective, which dies of SIGSEGV under gloo with CUDA
    tensors: torch 2.11, two ranks sharing an H100.)"""
    from torch.distributed.tensor import Replicate, Shard

    local = t.to_local()
    shards = [i for i, p in enumerate(t.placements) if isinstance(p, Shard)]
    if len(shards) != 1 or not all(isinstance(p, (Shard, Replicate)) for p in t.placements):
        return t.full_tensor()
    placement = t.placements[shards[0]]
    group = t.device_mesh.get_group(shards[0])
    d, size, n = placement.dim, t.shape[placement.dim], dist.get_world_size(group)
    chunk = -(-size // n)  # torch.chunk's split: ceil, the last ranks short or empty
    if local.shape[d] < chunk:
        pad = list(local.shape)
        pad[d] = chunk - local.shape[d]
        local = torch.cat([local, local.new_zeros(pad)], d)
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, d).narrow(d, 0, size)


def _full(obj):
    """Every DTensor of a nested dict/list replaced by its whole tensor (a
    collective that every rank joins, in the same order); plain tensors as
    they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(obj, DTensor):
        return _whole(obj)
    if isinstance(obj, dict):
        return {k: _full(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_full(v) for v in obj)
    return obj


def _payload(state: TrainState, epoch: int, loss: float) -> dict:
    model_sd, opt_sd = full_tensors(state, _full(state.model.state_dict()),
                                    _full(state.optimizer.state_dict()))
    return {"epoch": int(epoch), "model_state_dict": model_sd,
            "optimizer_state_dict": opt_sd, "loss": float(loss)}


def _write(payload: dict, path: str) -> int:
    """``torch.save`` into ``<path>.staging``, then an atomic rename into
    place; returns the file's size in bytes."""
    staging = path + ".staging"
    torch.save(payload, staging)
    os.replace(staging, path)
    return os.path.getsize(path)


def save_checkpoint(state: TrainState, epoch: int, loss: float, path: str) -> None:
    """Save a training checkpoint to ``path`` (replaced if present); under a
    process group every rank calls it and rank 0 writes."""
    path = os.path.abspath(path)
    payload = _payload(state, epoch, loss)
    barrier()
    if is_main_process():
        _write(payload, path)
        print(f"Checkpoint saved to {path}")
    barrier()


def _to_host(obj):
    """Copy every tensor of a nested dict/list/tuple to host memory: CUDA
    tensors into fresh pinned tensors with non-blocking copies, CPU tensors
    into clones. Other values are shared (they are immutable or rebuilt)."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach()
        if obj.is_cuda:
            host = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
            return host.copy_(obj, non_blocking=True)
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointWriter:
    """Asynchronous checkpoint writer: ``save()`` snapshots the state to host
    memory and returns; ``torch.save`` runs on one background thread while
    training goes on.

    The snapshot is taken before ``save()`` returns, because the next train
    step updates the state in place: on CUDA, non-blocking copies into pinned
    tensors are queued on the current stream ahead of any later step, and an
    event recorded after them is waited on by the writer thread before
    ``torch.save`` reads the tensors. The file is written to
    ``<path>.staging`` and renamed into place with ``os.replace``, which is
    atomic, so ``path`` always holds a complete checkpoint (the last one or
    the new one) and no ``.old`` sibling is needed. At most one write is in
    flight: a new ``save()`` first waits for the previous one, as do
    ``wait()`` and ``close()``, which re-raise a failed write.

    ``writes`` lists each finished write's ``path``, ``bytes`` and
    ``seconds`` (its time on the writer thread, event wait included).

    Under a process group every rank calls ``save`` at the same points;
    each gathers the state (FSDP), rank 0 writes, and every rank passes a
    barrier once the write in flight has finished.
    """

    def __init__(self):
        self._pool: Optional[cf.ThreadPoolExecutor] = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None
        self.writes: List[dict] = []

    def _finish_pending(self) -> None:
        if self._pending is not None:
            fut, self._pending = self._pending, None
            try:
                fut.result()
            finally:
                barrier()

    def _run(self, payload: dict, ready: Optional[torch.cuda.Event], path: str) -> None:
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        size = _write(payload, path)
        self.writes.append({"path": path, "bytes": size,
                            "seconds": time.perf_counter() - t0})
        print(f"Checkpoint saved to {path}")

    def save(self, state: TrainState, epoch: int, loss: float, path: str) -> None:
        path = os.path.abspath(path)
        self._finish_pending()
        payload = _payload(state, epoch, loss)
        if not is_main_process():
            self._pending = self._pool.submit(lambda: None)
            return
        payload = _to_host(payload)
        ready = None
        if state.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._pending = self._pool.submit(self._run, payload, ready, path)
        print(f"Checkpoint save started (async): {path}")

    def wait(self) -> None:
        self._finish_pending()

    def close(self) -> None:
        try:
            self._finish_pending()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_checkpoint(state: TrainState, path: str,
                    restore_optimizer: bool = True) -> Tuple[TrainState, int, float]:
    """Restore ``state`` in place from ``path``; returns (state, epoch, loss).

    The model loads with ``strict=True``, before the state is placed on a
    mesh (or after, under tensor parallelism: each rank takes its slices).
    ``path`` may also hold a bare
    state_dict (a reference model file): then epoch is -1 (no epoch
    completed), loss 0.0, and the optimizer is left as it is.
    """
    blob = torch.load(path, map_location=state.device, weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        model_sd, opt_sd = blob["model_state_dict"], blob.get("optimizer_state_dict")
        epoch, loss = int(blob.get("epoch", -1)), float(blob.get("loss", 0.0))
    else:
        model_sd, opt_sd, epoch, loss = blob, None, -1, 0.0
    model_sd, opt_sd = local_tensors(state, model_sd, opt_sd)
    state.model.load_state_dict(model_sd, strict=True)
    if restore_optimizer and opt_sd is not None:
        flags = [{k: g[k] for k in _IMPL_FLAGS if k in g}
                 for g in state.optimizer.param_groups]
        state.optimizer.load_state_dict(opt_sd)
        for group, kept in zip(state.optimizer.param_groups, flags):
            group.update(kept)
        _match_param_strides(state.optimizer)
    if is_main_process():
        print(f"Checkpoint loaded from {path}, epoch {epoch}, loss {loss:.4f}")
    return state, epoch, loss


def _match_param_strides(optimizer: torch.optim.Optimizer) -> None:
    """Give each per-parameter state tensor (Adam's moments, SGD's momentum)
    its parameter's strides. A file holds contiguous tensors, the parameters
    of a channels_last model on CUDA are not, and fused Adam refuses a
    moment whose layout differs from its parameter's."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            for k, v in st.items():
                if torch.is_tensor(v) and v.shape == p.shape and v.stride() != p.stride():
                    st[k] = torch.empty_like(p, dtype=v.dtype).copy_(v)


def load_params(state: TrainState, path: str) -> TrainState:
    """Restore the model's parameters and statistics only (test CLIs)."""
    state, _, _ = load_checkpoint(state, path, restore_optimizer=False)
    return state


def find_best_checkpoint(experiment_dir: str) -> Optional[str]:
    """``checkpoints/best_model.pth`` under an experiment directory, else the
    newest ``checkpoint_epoch_N.pth``; None if neither exists. Unfinished
    ``.staging`` files are never returned."""
    ckpt_dir = os.path.join(experiment_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    best = os.path.join(ckpt_dir, "best_model.pth")
    if os.path.isfile(best):
        return best
    epochs = [(int(m.group(1)), name) for name in os.listdir(ckpt_dir)
              if (m := _EPOCH_FILE.match(name))]
    if epochs:
        return os.path.join(ckpt_dir, max(epochs)[1])
    return None
