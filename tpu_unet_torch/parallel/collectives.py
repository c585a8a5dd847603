"""Cross-rank aggregation on the host side (counterpart of
``tpu_unet/parallel/collectives.py``).

Inside a step the collectives are explicit (``train/steps.py``,
``models/blocks.py``, ``losses/reduction.py``). These helpers cover the
seams of the epoch drivers and the CLIs: each rank holds its rows of every
batch, and the epoch's arrays are gathered so that every rank computes the
same global metrics. Without a process group (or at world size 1) each is
a passthrough. Under the 'space' axis the eval steps hand back whole
images (``parallel/spatial.py::gather_rows``), so these gather over
'data' alone, as under tensor parallelism.

Host values travel as tensors on the group's device: the rank's GPU under
NCCL, the CPU under gloo. Under tensor parallelism every model rank of a
data index holds the same rows, so the gathers and sums run over the 'data'
group (``parallel/mesh.py::data_group``) and count each row once.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist

from tpu_unet_torch.parallel.mesh import data_group, data_size, world_size


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_host_values(values) -> np.ndarray:
    """Concatenate a per-rank (batch-leading) array across the data ranks,
    rank-major.

    Every rank must pass the same shape (the padded eval batches guarantee
    it). Returns ``values`` as a numpy array at world size 1.
    """
    values = np.asarray(values)
    w = data_size()
    if w == 1:
        return values
    is_bool = values.dtype == np.bool_
    local = torch.from_numpy(np.ascontiguousarray(
        values.astype(np.uint8) if is_bool else values)).to(_comm_device())
    out = torch.empty((w * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local, group=data_group())
    out = out.cpu().numpy()
    return out.astype(bool) if is_bool else out


def gather_batches(values, n_batches: int) -> np.ndarray:
    """Gather the concatenation of a rank's ``n_batches`` equal blocks (its
    rows of each batch, in batch order) into the global batch order: batch
    0's rows of rank 0, rank 1, ..., then batch 1's."""
    values = np.asarray(values)
    w = data_size()
    if w == 1:
        return values
    g = all_gather_host_values(values)
    per = values.shape[0] // max(n_batches, 1)
    g = g.reshape((w, n_batches, per) + g.shape[1:]).swapaxes(0, 1)
    return g.reshape((-1,) + g.shape[3:])


def gather_objects(items: List[Any], n_batches: int) -> List[Any]:
    """:func:`gather_batches` for a list of picklable items (paths, anomaly
    types), in the global batch order."""
    w = data_size()
    if w == 1:
        return list(items)
    parts: List[Any] = [None] * w
    dist.all_gather_object(parts, list(items), group=data_group())
    per = len(items) // max(n_batches, 1)
    return [x for b in range(n_batches) for part in parts
            for x in part[b * per:(b + 1) * per]]


def psum_scalar(x) -> float:
    """Global sum of a per-rank vector: each rank sums its own shard and one
    all-reduce over the data ranks adds their sums (float32, as the JAX
    package's psum)."""
    local = torch.as_tensor(np.asarray(x, np.float32)).sum().reshape(1)
    if data_size() == 1:
        return float(local)
    local = local.to(_comm_device())
    dist.all_reduce(local, group=data_group())
    return float(local.cpu())


def local_rows(x) -> np.ndarray:
    """This rank's rows of a batch as a host array: a rank's tensors hold
    its rows only, so this is the host copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def broadcast_from_host0(obj: Any) -> Any:
    """Rank 0's picklable ``obj`` on every rank (thresholds, decisions)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
