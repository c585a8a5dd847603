"""Placing a train state on the data mesh: replicated (plain data
parallelism) or FSDP-sharded (counterpart of ``tpu_unet/parallel/fsdp.py``).

The JAX package shards every large state leaf (parameters, Adam moments)
over ``'data'`` and lets GSPMD all-gather the weights for the forward and
backward and reduce-scatter the gradients. The port does the same with
FSDP2 (``torch.distributed.fsdp.fully_shard``): each parameter becomes a
DTensor sharded on one dim, all-gathered around the forward and backward,
its gradient reduce-scattered (averaged) into the shard, and the optimizer
updates each rank's shard only. The moments follow the parameters: the
optimizer is rebuilt over the sharded parameters, and any state it held
(a resumed run) is sharded the same way.

Leaf policy (:func:`leaf_partition_spec`, the JAX package's pure shape
logic): shard the largest dim divisible by the axis size, ties going to the
trailing dim, and keep leaves under ``2**13`` elements replicated. The dim
it picks in the JAX layout (a conv kernel's HWIO, a transposed conv's
(kh, kw, in, out)) is mapped to the PyTorch layout through
``utils/weights.py::jax_axes``. One difference: FSDP2 keeps no parameter
replicated that it should reduce (``ignored_params`` leaves a parameter's
gradient unreduced, and fused Adam refuses a group that mixes DTensors and
plain tensors), so the leaves JAX replicates are sharded on dim 0 here,
unevenly where the dim does not divide (FSDP2 pads such shards). The update
is the same; each rank holds 1/W of those small leaves instead of all of
them (:func:`jax_placement_bytes` gives JAX's per-device bytes).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

from tpu_unet_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SPACE_AXIS, group_of, replicate

# Leaves below this many ELEMENTS stay replicated in the JAX package: the BN
# vectors and biases fall under it; every conv kernel from the second block
# up (3*3*64*128 = 73k) clears it.
DEFAULT_MIN_SIZE = 2 ** 13


def leaf_partition_spec(shape, n_shards: int, axis: str = DATA_AXIS,
                        min_size: int = DEFAULT_MIN_SIZE) -> Tuple:
    """The JAX package's PartitionSpec of one leaf of ``shape`` (JAX
    layout), as a tuple: ``()`` replicated, else one entry per dim with
    ``axis`` on the largest ``n_shards``-divisible dim (ties trailing)."""
    size = 1
    for d in shape:
        size *= d
    if n_shards <= 1 or size < min_size:
        return ()
    best = -1
    best_extent = 0
    for i, d in enumerate(shape):
        if d % n_shards == 0 and d >= best_extent:  # >=: ties go trailing
            best, best_extent = i, d
    if best < 0 or best_extent == 0:
        return ()
    spec: list = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def fsdp_dims(model: torch.nn.Module, n_shards: int,
              min_size: int = DEFAULT_MIN_SIZE) -> Dict[str, Optional[int]]:
    """Each parameter's shard dim in the PyTorch layout under the JAX
    policy, or None where the JAX package replicates the leaf."""
    from tpu_unet_torch.utils.weights import jax_axes

    axes = jax_axes(model)
    out: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        perm = axes[name]
        spec = leaf_partition_spec(tuple(p.shape[a] for a in perm), n_shards,
                                   min_size=min_size)
        out[name] = perm[spec.index(DATA_AXIS)] if spec else None
    return out


def shard_state(mesh, state, fsdp: bool = False, min_size: int = DEFAULT_MIN_SIZE,
                tp: bool = False):
    """Place ``state`` (a ``TrainState``) on ``mesh``, in place; returns it.

    No mesh (one process): unchanged. ``tp``: tensor parallelism over the
    mesh's 'model' axis, composed with ``fsdp`` over 'data'
    (``parallel/tensor.py::shard_state``). Otherwise the model's BatchNorms
    take the global batch's statistics over the mesh's group
    (``models/blocks.py::sync_batchnorm``) and then either every rank gets
    rank 0's parameters and buffers (plain data parallelism; the train step
    all-reduces the gradients), or with ``fsdp`` on a mesh wider than 1 the
    parameters are sharded by FSDP2 under the leaf policy and the optimizer
    is rebuilt over the shards. ``fsdp`` on a 1-wide mesh warns and
    replicates, as the JAX package does. Under a 'space' axis the group is
    the batch group (data x space) and FSDP2 shards over 'data' and
    replicates over 'space' (:func:`fsdp_mesh`), as the JAX package's
    leaf policy does.
    """
    if tp:
        from tpu_unet_torch.parallel import tensor
        return tensor.shard_state(mesh, state, fsdp=fsdp, min_size=min_size)
    if mesh is None:
        if fsdp:
            warnings.warn("--fsdp requested on one device: the state stays whole",
                          stacklevel=2)
        return state
    from tpu_unet_torch.models.blocks import sync_batchnorm

    group = group_of(mesh)
    sync_batchnorm(state.model, group)
    replicate(state.model, group)
    if fsdp:
        fully_shard_state(fsdp_mesh(mesh), state, min_size)
    return state


def fsdp_mesh(mesh):
    """The mesh FSDP2 places the state on: the 'data' ranks (of this
    rank's 'model' index), or with a 'space' axis wider than 1 the 2-D
    ``('space', 'data')`` mesh of this rank's model index, FSDP2's hybrid
    form: shard over 'data' (the last dim), replicate over 'space'. Its
    gradient reduction divides by both dims' ranks: the mean over the batch
    group."""
    names = mesh.mesh_dim_names or ()
    if SPACE_AXIS not in names or mesh[SPACE_AXIS].size() == 1:
        return mesh[DATA_AXIS] if MODEL_AXIS in names else mesh
    from torch.distributed.device_mesh import DeviceMesh

    d, s, m = (mesh[a].size() for a in (DATA_AXIS, SPACE_AXIS, MODEL_AXIS))
    ranks = torch.arange(d * s * m).reshape(d, s, m).permute(1, 0, 2)
    full = DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=(SPACE_AXIS, DATA_AXIS, MODEL_AXIS))
    return full[SPACE_AXIS, DATA_AXIS]


def fully_shard_state(mesh, state, min_size: int = DEFAULT_MIN_SIZE) -> None:
    """FSDP2 over ``mesh`` (:func:`fsdp_mesh`; ranks whose states are
    already equal): every parameter sharded over its last dim under the
    leaf policy, the optimizer rebuilt over the shards. A 1-wide shard dim
    warns and leaves the state whole, as the JAX package does."""
    n = mesh.size(mesh.ndim - 1)
    if n == 1:
        warnings.warn(f"--fsdp requested but the '{DATA_AXIS}' mesh axis is 1-wide; "
                      "state stays fully replicated", stacklevel=3)
        return
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    model = state.model
    # FSDP2 shards contiguous parameters only: an FSDP model runs NCHW.
    model.to(memory_format=torch.contiguous_format)
    dims = fsdp_dims(model, n, min_size)
    by_param = {p: (0 if dims[name] is None else dims[name])
                for name, p in model.named_parameters()}
    old = list(model.parameters())
    fully_shard(model, mesh=mesh, reshard_after_forward=True,
                shard_placement_fn=lambda p: Shard(by_param[p]))
    state.optimizer = _rebuild_optimizer(state.optimizer, old, list(model.parameters()))


def _rebuild_optimizer(opt: torch.optim.Optimizer, old, new) -> torch.optim.Optimizer:
    """``opt``'s class and hyperparameters over the sharded parameters
    ``new`` (the same order as ``old``), its per-parameter state sharded as
    each parameter is."""
    from torch.distributed.tensor import distribute_tensor

    index = {p: i for i, p in enumerate(old)}
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [new[index[p]] for p in g["params"]]}
              for g in opt.param_groups]
    rebuilt = type(opt)(groups, **opt.defaults)
    for p_old, st in opt.state.items():
        p = new[index[p_old]]
        rebuilt.state[p] = {
            k: (distribute_tensor(v.detach(), p.device_mesh, p.placements)
                if torch.is_tensor(v) and v.shape == p.shape else v)
            for k, v in st.items()}
    return rebuilt


def _state_tensors(state):
    yield from state.model.parameters()
    yield from state.model.buffers()
    for st in state.optimizer.state.values():
        yield from (v for v in st.values() if torch.is_tensor(v))


def _is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(t, DTensor) and any(isinstance(p, Shard) for p in t.placements)


def sharded_fraction(state) -> float:
    """Fraction of the state's elements (parameters, buffers, optimizer
    state) held on sharded tensors."""
    total = sharded = 0
    for t in _state_tensors(state):
        total += t.numel()
        sharded += t.numel() if _is_sharded(t) else 0
    return sharded / total if total else 0.0


def per_device_state_bytes(state) -> int:
    """Bytes of the state held by this rank: each sharded tensor's local
    shard, every other tensor whole."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _state_tensors(state):
        local = t.to_local() if isinstance(t, DTensor) else t
        total += local.numel() * local.element_size()
    return total


def jax_placement_bytes(state, n_shards: int, min_size: int = DEFAULT_MIN_SIZE) -> int:
    """The per-device bytes of the same state under the JAX package's
    placement (leaves under ``min_size`` or with no divisible dim kept
    whole), beside :func:`per_device_state_bytes`."""
    total = 0
    for t in _state_tensors(state):
        whole = not leaf_partition_spec(tuple(t.shape), n_shards, min_size=min_size)
        total += (t.numel() if whole else t.numel() // n_shards) * t.element_size()
    return total
