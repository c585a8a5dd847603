"""Rank functions of the port's tensor-parallel tests. Each runs on every
rank of a ``tpu_unet_torch.parallel.mesh.launch`` over CPU ranks (gloo) on
a ('data', 'space', 'model') mesh and returns what rank 0 gathered; the
module imports the port and nothing of JAX, so a rank never starts JAX."""

import os

import numpy as np
import torch
import torch.distributed as dist

from tpu_unet_torch.models import build_model
from tpu_unet_torch.parallel.collectives import gather_batches
from tpu_unet_torch.parallel.fsdp import per_device_state_bytes, shard_state
from tpu_unet_torch.parallel.mesh import group_of, make_mesh, model_rank, shard_batch, world_size
from tpu_unet_torch.parallel.tensor import (full_tensors, jax_placement_bytes,
                                            sharded_fraction)
from tpu_unet_torch.train.checkpoint import CheckpointWriter, _full, load_checkpoint
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (make_anomaly_eval_step, make_anomaly_train_step,
                                        make_seg_eval_step, make_seg_train_step)


def _state(name, sd, opt, lr, wd, model_kw, n_model, fsdp=False, resume=None):
    """The model from ``sd`` (or, with ``resume``, from a ``.pth`` loaded
    before placing, as the CLIs do) on the mesh of ``n_model`` model ranks."""
    torch.set_num_threads(1)
    model = build_model(name, **model_kw)
    model.load_state_dict(sd)
    state = create_train_state(model, opt, lr, wd, device="cpu")
    if resume:
        load_checkpoint(state, resume)
    mesh = make_mesh(world_size() // n_model, n_model=n_model)
    return shard_state(mesh, state, fsdp=fsdp, tp=n_model > 1), group_of(mesh)


def _whole(state):
    """The state's model and optimizer state_dicts, whole, as numpy (every
    rank joins the gathers)."""
    msd, osd = full_tensors(state, _full(state.model.state_dict()),
                            _full(state.optimizer.state_dict()))
    names = [n for n, _ in state.model.named_parameters()]
    moments = {names[i]: {k: v.numpy().copy() for k, v in st.items()
                          if torch.is_tensor(v) and v.dim()}
               for i, st in osd["state"].items()}
    return {k: v.numpy().copy() for k, v in msd.items()}, moments


def _replicas_agree(state) -> bool:
    """Every rank holds the same replicated leaves, and every rank of a
    model index the same slices, bit for bit."""
    if world_size() == 1:
        return True
    dims = getattr(state.model, "tp_dims", {})
    local = {k: v.detach().numpy().copy() for k, v in _full(state.model.state_dict()).items()}
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (model_rank(), local))
    return all(np.array_equal(p[k], local[k]) for m, p in parts for k in local
               if k not in dims or m == model_rank())


def _local_shapes(state):
    """This rank's parameter and buffer shapes, and its Adam moments'."""
    params = dict(state.model.named_parameters())
    moments = {n: tuple(state.optimizer.state[p]["exp_avg"].shape) for n, p in params.items()
               if "exp_avg" in state.optimizer.state.get(p, {})}
    return ({k: tuple(v.shape) for k, v in state.model.state_dict().items()}, moments)


def anomaly_cases(sd, base, n_model, cases, images, masks, loss_cfg, aug_cfg, lr, wd):
    """Per case ``(opt, fsdp, draws_per_step)``: that many train steps from
    ``sd`` on this data rank's rows; the losses of each, the whole state,
    the moments, whether the replicas agree after the steps, the local
    shapes and the bytes per rank."""
    out = []
    n_data = dist.get_world_size() // n_model
    for opt, fsdp, draws_per_step in cases:
        state, group = _state("anomaly_unet", sd, opt, lr, wd, {"base_features": base},
                              n_model, fsdp)
        step = make_anomaly_train_step(loss_cfg, aug_cfg, group=group)
        img, msk = shard_batch((images, masks))
        losses = [{k: float(v) for k, v in step.with_draws(state, img, msk, d).items()}
                  for d in draws_per_step]
        whole, moments = _whole(state)
        out.append({"losses": losses, "state": whole, "moments": moments,
                    "agree": _replicas_agree(state), "shapes": _local_shapes(state),
                    "bytes": per_device_state_bytes(state),
                    "jax_bytes": jax_placement_bytes(state, n_data, fsdp),
                    "sharded_fraction": sharded_fraction(state)})
    return out


def anomaly_eval(sd, base, n_model, images, masks, valid, loss_cfg):
    """The eval step on a tensor-parallel state, this data rank's rows of a
    padded batch: the global loss scalars and the gathered per-row outputs."""
    state, group = _state("anomaly_unet", sd, "sgd", 0.0, 0.0, {"base_features": base},
                          n_model)
    out = make_anomaly_eval_step(loss_cfg, group=group)(
        state, *shard_batch((images, masks, valid)))
    rows = {k: gather_batches(out[k].numpy(), 1)
            for k in ("score", "error_map", "anomaly_map", "reconstruction")}
    return {"losses": {k: float(v) for k, v in out["losses"].items()}, **rows}


def seg_step(name, sd, model_kw, n_model, images, labels, draws, keep, loss_cfg, aug_cfg,
             lr, wd, eval_images=None, eval_labels=None, valid=None):
    """One seg SGD step on this data rank's rows (dropout under ``keep``),
    then optionally the eval step on a padded batch; rank 0's losses,
    matrices and whole state."""
    state, group = _state(name, sd, "sgd", lr, wd, model_kw, n_model)
    step = make_seg_train_step(model_kw["n_classes"], loss_cfg, aug_cfg, group=group)
    img, lbl = shard_batch((images, labels))
    losses, cm = step.with_draws(state, img, lbl, draws, keep)
    whole, _ = _whole(state)
    out = {"losses": {k: float(v) for k, v in losses.items()}, "cm": cm.numpy(),
           "state": whole, "agree": _replicas_agree(state),
           "dims": dict(getattr(state.model, "tp_dims", {}))}
    if eval_images is not None:
        ev_losses, preds, ev_cm = make_seg_eval_step(model_kw["n_classes"], loss_cfg,
                                                     group=group)(
            state, *shard_batch((eval_images, eval_labels, valid)))
        out.update(eval_losses={k: float(v) for k, v in ev_losses.items()},
                   eval_cm=ev_cm.numpy(), preds=gather_batches(preds.numpy(), 1))
    return out


def placement(models, n_model):
    """Each ``(name, state_dict, model_kw)`` placed on a mesh of ``n_model``
    model ranks: this rank's parameter and buffer shapes."""
    return {name: _local_shapes(_state(name, sd, "adam", 0.0, 0.0, kw, n_model)[0])[0]
            for name, sd, kw in models}


def checkpoint_round_trip(sd, base, n_model, images, masks, draws, loss_cfg, aug_cfg, lr, wd,
                          work):
    """A tensor-parallel Adam step written to ``work/tp.pth`` (rank 0
    writes the whole tensors); then that file and ``work/ws1.pth`` (a
    world-size-1 checkpoint) resumed on the mesh, once loaded before the
    state is placed (as the CLIs do) and once after (each rank takes its
    slices): the local tensors of each, and one more step's losses."""
    state, group = _state("anomaly_unet", sd, "adam", lr, wd, {"base_features": base}, n_model)
    step = make_anomaly_train_step(loss_cfg, aug_cfg, group=group)
    img, msk = shard_batch((images, masks))
    step.with_draws(state, img, msk, draws)
    path = os.path.join(work, "tp.pth")
    with CheckpointWriter() as writer:
        writer.save(state, 4, 0.5, path)
    out = {"written": _whole(state)}
    for name in ("tp.pth", "ws1.pth"):
        before, _ = _state("anomaly_unet", sd, "adam", lr, wd, {"base_features": base},
                           n_model, resume=os.path.join(work, name))
        after, _ = _state("anomaly_unet", sd, "adam", lr, wd, {"base_features": base}, n_model)
        _, epoch, _ = load_checkpoint(after, os.path.join(work, name))
        local = lambda s: {k: v.numpy().copy() for k, v in s.model.state_dict().items()}  # noqa: E731
        moments = lambda s: {n: s.optimizer.state[p]["exp_avg"].numpy().copy()  # noqa: E731
                             for n, p in s.model.named_parameters()}
        out[name] = {"before": local(before), "after": local(after), "epoch": epoch,
                     "moments_after": moments(after), "rank": model_rank(),
                     "dims": dict(before.model.tp_dims)}
        again = make_anomaly_train_step(loss_cfg, aug_cfg, group=group)
        out[name]["loss"] = float(again.with_draws(before, img, msk, draws)["total_loss"])
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {k: out[k] for k in ("tp.pth", "ws1.pth")})
    out["ranks"] = parts
    return out
