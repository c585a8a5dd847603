"""Tensor (model) parallelism: Megatron channel sharding for the UNet
(counterpart of ``tpu_unet/parallel/tensor.py``).

The JAX package shards the channel dim of chosen leaves over a 'model' mesh
axis and lets GSPMD insert the collectives. The port holds each rank's
slice of those leaves as plain (smaller) parameters and buffers and puts
the collectives in the forward by hand, as Megatron-LM does:

- a **column** conv (a DoubleConv's ``conv1``, an attention gate's W_g and
  W_x, a transposed conv ``up``/``up{i}_{j}``) computes its slice of the
  output channels. Its input is replicated, so its gradient is this rank's
  part of a sum: :func:`copy_to_model` (identity forward, all-reduce over
  'model' backward) goes before it. Without it the loss is right and every
  gradient upstream of a column conv is wrong;
- ``bn1`` (and the gate's ``bn1``) normalizes its slice: BatchNorm is per
  channel;
- a **row** conv (``conv2``, the gate's psi) contracts its slice of the
  input channels: :func:`reduce_from_model` (all-reduce forward, identity
  backward) adds the ranks' partial sums, so ``bn2`` and everything after it
  see whole activations. In the bf16 policy the all-reduce runs on the
  conv's output after its cast to the norm dtype (float32,
  ``models/blocks.py::conv_bn``), where the JAX package's GSPMD sums the
  bf16 partials: the port's sum is the more exact one;
- a column transposed conv's slices meet the skip in a concat:
  :func:`gather_channels` (all-gather over channels forward, this rank's
  slice of the gradient backward) goes after it.

Which leaves are sharded is the JAX package's rule, kept as shape logic on
JAX paths (:func:`tp_leaf_spec`), and mapped onto the torch module through
``utils/weights.py::layout_of`` and ``jax_axes`` (:func:`tp_dims`): an OIHW
kernel's C_out is dim 0 and C_in dim 1, a ``ConvTranspose2d`` kernel's C_out
is dim 1 (its spatial flip is untouched: slicing channels commutes with it).
Heads and widths the axis does not divide stay replicated.

:func:`shard_state` places a state: the parameters, BN statistics and any
optimizer state become each rank's slices, the BatchNorms take their
statistics over the 'data' group (none when it is 1 wide), and with
``fsdp`` FSDP2 shards the state over 'data' as well. The JAX package
applies FSDP only to the leaves tensor parallelism leaves replicated; FSDP2
keeps no parameter replicated that it should reduce, and fused Adam refuses
a group that mixes DTensors and plain tensors, so the port shards the
tensor-parallel slices over 'data' too (a parity note:
:func:`jax_placement_bytes` gives the JAX package's per-device bytes).

Checkpoints hold whole tensors: :func:`full_tensors` gathers the slices over
'model' (``train/checkpoint.py``), and :func:`local_tensors` slices whole
tensors for a state already placed.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_unet_torch.parallel.fsdp import (DEFAULT_MIN_SIZE, fsdp_mesh, fully_shard_state,
                                          leaf_partition_spec)
from tpu_unet_torch.parallel.mesh import (MODEL_AXIS, group_of, model_group, model_rank,
                                          model_size, replicate)

# Level-up ConvTranspose names: 'up' (blocks.Up) and 'up{i}_{j}' (UNet++).
_UP_NAME = re.compile(r"up(\d+_\d+)?")


def tp_leaf_spec(names: Sequence[str], shape, n_model: int) -> Tuple:
    """The JAX package's tensor-parallel PartitionSpec of one leaf, as a
    tuple (``()`` replicated, else ``'model'`` on the sharded dim of the JAX
    layout), from the names of its tree path (the last two decide) and its
    JAX shape."""
    if n_model <= 1 or not shape:
        return ()
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    if parent == "conv1" and leaf == "kernel" and len(shape) == 4:
        if shape[3] % n_model == 0:
            return (None, None, None, MODEL_AXIS)        # column: C_out
    elif parent == "conv2" and leaf == "kernel" and len(shape) == 4:
        if shape[2] % n_model == 0:
            return (None, None, MODEL_AXIS, None)        # row: C_in
    elif parent == "bn1":
        if len(shape) == 1 and shape[0] % n_model == 0:
            return (MODEL_AXIS,)
    elif _UP_NAME.fullmatch(parent):
        if leaf == "kernel" and len(shape) == 4 and shape[3] % n_model == 0:
            return (None, None, None, MODEL_AXIS)
        if leaf == "bias" and len(shape) == 1 and shape[0] % n_model == 0:
            return (MODEL_AXIS,)
    return ()


def model_name(model: torch.nn.Module) -> str:
    """The layout name (``utils/weights.py::model_layout``) of a model."""
    from tpu_unet_torch.models.attention import AttentionUNet
    from tpu_unet_torch.models.unet import AnomalyUNet, SegmentationUNet, UNet
    from tpu_unet_torch.models.unetpp import UNetPlusPlus

    for cls, name in ((UNetPlusPlus, "unetpp"), (AttentionUNet, "attn_unet"),
                      (AnomalyUNet, "anomaly_unet"), (SegmentationUNet, "seg_unet"),
                      (UNet, "unet")):
        if isinstance(model, cls):
            return name
    raise TypeError(f"no tensor-parallel layout for {type(model).__name__}")


# (JAX leaf, torch leaf) of a BatchNorm's parameters and statistics.
_BN_LEAVES = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
              ("var", "running_var"))


def tp_dims(model: torch.nn.Module, n_model: int) -> Dict[str, int]:
    """The torch dim that each sharded parameter and buffer of ``model``
    (whole, not yet placed) splits over 'model', by state_dict name; leaves
    the JAX rule keeps replicated are absent."""
    from tpu_unet_torch.utils.weights import CONV_BN, jax_axes, layout_of

    sd = model.state_dict()
    axes = jax_axes(model)
    out: Dict[str, int] = {}

    def leaf(path: str, name: str) -> None:
        if name not in sd:
            return
        perm = axes.get(name, tuple(range(sd[name].dim())))
        spec = tp_leaf_spec(path.split("/"), tuple(sd[name].shape[a] for a in perm), n_model)
        if spec:
            out[name] = perm[spec.index(MODEL_AXIS)]

    for path, prefix, kind in layout_of(model_name(model), sd):
        if kind in CONV_BN:
            for jconv, jbn, tconv, tbn in CONV_BN[kind]:
                leaf(f"{path}/{jconv}/kernel", f"{prefix}.{tconv}.weight")
                for jl, tl in _BN_LEAVES:
                    leaf(f"{path}/{jbn}/{jl}", f"{prefix}.{tbn}.{tl}")
        else:  # 'up' and 'head'
            leaf(f"{path}/kernel", f"{prefix}.weight")
            leaf(f"{path}/bias", f"{prefix}.bias")
    return out


# ---------------------------------------------------------------------------
# The forward's collectives
# ---------------------------------------------------------------------------

def _channels_last_view(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The NHWC view of a channels_last NCHW tensor (dense, so a collective
    can work on it in place); None for any other layout."""
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1)
    return None


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in float32 (a new tensor, ``t``'s dtype
    and layout)."""
    out = t.to(torch.float32, copy=True)
    view = _channels_last_view(out)
    if view is None:
        out = out.contiguous()
        view = out
    dist.all_reduce(view, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.slice = (dist.get_rank(group) * x.shape[1], x.shape[1])
        view = _channels_last_view(x)
        dim = 3 if view is not None else 1
        view = x.contiguous() if view is None else view
        # Bytes travel as they are, as uint8 (gloo's CUDA path takes no
        # 2-byte integer type); the last dim holds each element's bytes.
        wire = view.view(torch.uint8)
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts, dim).view(view.dtype)
        return out.permute(0, 3, 1, 2) if dim == 3 else out

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(1, *ctx.slice), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Before a column conv: ``x`` forward; the gradient all-reduced over
    ``group`` (in float32, cast back) backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """After a row conv: the ranks' partial sums all-reduced over ``group``
    forward; the gradient as it is backward."""
    return _ReduceFromModel.apply(x, group)


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """After a column transposed conv: every rank's channel slice
    concatenated in rank order forward; this rank's slice of the gradient
    backward."""
    return _GatherChannels.apply(x, group)


# ---------------------------------------------------------------------------
# Placing a state
# ---------------------------------------------------------------------------

def _slice(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    """Rank ``r``'s slice of ``t`` on ``dim``, a new tensor in ``t``'s
    memory format."""
    fmt = torch.contiguous_format if _channels_last_view(t) is None else torch.channels_last
    return t.detach().chunk(n, dim)[r].clone(memory_format=fmt)


def _mark_convs(model: torch.nn.Module, dims: Dict[str, int], group) -> None:
    """Tag each sharded conv with its role for the forward
    (``models/blocks.py``): ``tp`` 'column' or 'row', and ``tp_group``."""
    for name, mod in model.named_modules():
        dim = dims.get(f"{name}.weight")
        if dim is None or not isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            continue
        if isinstance(mod, torch.nn.ConvTranspose2d):
            mod.tp = "column"
        else:
            mod.tp = "column" if dim == 0 else "row"
        mod.tp_group = group


def shard_state(mesh, state, fsdp: bool = False, min_size: int = DEFAULT_MIN_SIZE):
    """Place ``state`` (a ``TrainState`` of whole tensors, the same on every
    rank after rank 0's broadcast) on a tensor-parallel ``mesh``, in place;
    returns it (module docstring)."""
    from tpu_unet_torch.models.blocks import sync_batchnorm

    if mesh is None or MODEL_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"tensor parallelism needs a '{MODEL_AXIS}' mesh axis; build the "
                         f"mesh with make_mesh(..., n_model=K) (got "
                         f"{None if mesh is None else mesh.mesh_dim_names})")
    model = state.model
    replicate(model)  # every rank starts from rank 0's whole state
    n, r, group = model_size(), model_rank(), model_group()
    dims = tp_dims(model, n)
    by_name = dict(model.named_parameters())
    with torch.no_grad():
        for name, t in list(model.state_dict(keep_vars=True).items()):
            dim = dims.get(name)
            if dim is None:
                continue
            p = by_name.get(name)
            if p is not None:
                st = state.optimizer.state.get(p, {})
                for k, v in list(st.items()):
                    if torch.is_tensor(v) and v.shape == p.shape:
                        st[k] = _slice(v, dim, n, r)
            t.data = _slice(t, dim, n, r)
    model.tp_dims, model.tp_size = dims, n
    _mark_convs(model, dims, group)
    sync_batchnorm(model, group_of(mesh))
    if fsdp:
        fully_shard_state(fsdp_mesh(mesh), state, min_size)
    return state


# ---------------------------------------------------------------------------
# Whole tensors (checkpoints) and slices of them
# ---------------------------------------------------------------------------

def _param_names(state) -> Dict[int, str]:
    """The optimizer state_dict's parameter indices -> parameter names."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    order = [p for g in state.optimizer.param_groups for p in g["params"]]
    return {i: names[id(p)] for i, p in enumerate(order)}


def _gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    group = model_group()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def full_tensors(state, model_sd: dict, opt_sd: dict) -> Tuple[dict, dict]:
    """A tensor-parallel state's model and optimizer state_dicts (FSDP's
    DTensors already whole) with every slice gathered over 'model' into the
    whole tensor of the reference layout; a collective every rank joins.
    Other states' dicts pass through."""
    dims = getattr(state.model, "tp_dims", None)
    if not dims:
        return model_sd, opt_sd
    model_sd = {k: _gather(v, dims[k]) if k in dims else v for k, v in model_sd.items()}
    names = _param_names(state)
    opt_sd = {**opt_sd, "state": {
        i: {k: (_gather(v, dims[names[i]]) if names[i] in dims and torch.is_tensor(v)
                and v.dim() else v) for k, v in st.items()}
        for i, st in opt_sd["state"].items()}}
    return model_sd, opt_sd


def local_tensors(state, model_sd: dict, opt_sd: Optional[dict]) -> Tuple[dict, Optional[dict]]:
    """Whole-tensor state_dicts (a ``.pth``) cut to this rank's slices of a
    tensor-parallel state; other states' dicts pass through."""
    dims = getattr(state.model, "tp_dims", None)
    if not dims:
        return model_sd, opt_sd
    n, r = model_size(), model_rank()
    cut = lambda v, d: v.chunk(n, d)[r].contiguous()  # noqa: E731
    model_sd = {k: cut(v, dims[k]) if k in dims else v for k, v in model_sd.items()}
    if opt_sd is not None:
        names = _param_names(state)
        opt_sd = {**opt_sd, "state": {
            i: {k: (cut(v, dims[names[i]]) if names[i] in dims and torch.is_tensor(v)
                    and v.dim() else v) for k, v in st.items()}
            for i, st in opt_sd["state"].items()}}
    return model_sd, opt_sd


def _named_state_tensors(state):
    """(name, tensor) of the state's parameters, buffers and optimizer
    state, each optimizer tensor under its parameter's name ('' for a
    scalar)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    yield from state.model.named_parameters()
    yield from state.model.named_buffers()
    for p, st in state.optimizer.state.items():
        for v in st.values():
            if torch.is_tensor(v):
                yield (names[id(p)] if v.shape == p.shape else ""), v


def sharded_fraction(state) -> float:
    """Fraction of the whole state's elements (parameters, buffers and
    optimizer state) that tensor parallelism holds in slices."""
    dims, n = getattr(state.model, "tp_dims", {}), getattr(state.model, "tp_size", 1)
    total = sharded = 0
    for name, t in _named_state_tensors(state):
        whole = t.numel() * (n if name in dims else 1)
        total += whole
        sharded += whole if name in dims else 0
    return sharded / total if total else 0.0


def jax_placement_bytes(state, n_data: int = 1, fsdp: bool = False,
                        min_size: int = DEFAULT_MIN_SIZE) -> int:
    """The per-device bytes of a placed tensor-parallel ``state`` under the
    JAX package's placement (``tp_state_sharding``): the leaves the rule
    shards hold their 'model' slice only (as here); with ``fsdp`` the others
    follow the FSDP leaf policy over ``n_data`` ranks, and the others are
    whole. Beside ``parallel/fsdp.py::per_device_state_bytes``."""
    from tpu_unet_torch.utils.weights import jax_axes

    dims = state.model.tp_dims
    axes = jax_axes(state.model)
    total = 0
    for name, t in _named_state_tensors(state):
        share = t.numel()  # a DTensor's shape is its whole (tensor-parallel) shape
        if fsdp and name not in dims:
            perm = axes.get(name, tuple(range(t.dim())))
            if leaf_partition_spec(tuple(t.shape[a] for a in perm), n_data,
                                   min_size=min_size):
                share //= n_data
        total += share * t.element_size()
    return total


__all__ = ["tp_leaf_spec", "tp_dims", "model_name", "copy_to_model", "reduce_from_model",
           "gather_channels", "shard_state", "full_tensors", "local_tensors",
           "jax_placement_bytes", "sharded_fraction"]
