"""Rank functions of the port's data-parallel tests. Each runs on every rank
of a ``tpu_unet_torch.parallel.mesh.launch`` over CPU ranks (gloo) and
returns what rank 0 gathered; the module imports the port and nothing of
JAX, so a rank never starts JAX."""

import os
import signal

import numpy as np
import torch
import torch.distributed as dist

from tpu_unet_torch.models import build_model
from tpu_unet_torch.models.blocks import sync_batchnorm
from tpu_unet_torch.parallel.collectives import gather_batches
from tpu_unet_torch.parallel.fsdp import (jax_placement_bytes, per_device_state_bytes,
                                          shard_state, sharded_fraction)
from tpu_unet_torch.parallel.mesh import group_of, make_mesh, rank, shard_batch
from tpu_unet_torch.train.checkpoint import CheckpointWriter, _full
from tpu_unet_torch.train.interrupt import GracefulInterrupt
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import (make_anomaly_eval_step, make_anomaly_train_step,
                                        make_seg_eval_step, make_seg_train_step)


def _numpy_state(state):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in _full(state.model.state_dict()).items()}


def _rank_states_equal(sd) -> bool:
    """Every rank holds the same state (plain data parallelism's invariant)."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, sd)
    return all(np.array_equal(p[k], sd[k]) for p in parts for k in sd)


def _state(name, sd, opt, lr, wd, model_kw, fsdp=False):
    model = build_model(name, **model_kw)
    model.load_state_dict(sd)
    state = create_train_state(model, opt, lr, wd, device="cpu")
    mesh = make_mesh(dist.get_world_size())
    return shard_state(mesh, state, fsdp=fsdp), group_of(mesh)


def anomaly_steps(sd, base, cases, images, masks, loss_cfg, aug_cfg, lr, wd):
    """One train step per case ``(opt, grad_accum, draws)`` from ``sd``, on
    this rank's rows of the global batch; rank 0's losses and state after
    each, and whether the ranks' states agree."""
    torch.set_num_threads(1)
    out = []
    for opt, ga, draws in cases:
        state, group = _state("anomaly_unet", sd, opt, lr, wd, {"base_features": base})
        step = make_anomaly_train_step(loss_cfg, aug_cfg, grad_accum=ga, group=group)
        img, msk = shard_batch((images, masks), ga)
        losses = step.with_draws(state, img, msk, draws)
        new = _numpy_state(state)
        out.append({"losses": {k: float(v) for k, v in losses.items()}, "state": new,
                    "ranks_equal": _rank_states_equal(new),
                    "bn_steps": int(state.model.inc.double_conv[1].num_batches_tracked)})
    return out


def anomaly_eval(sd, base, images, masks, valid, loss_cfg):
    """The eval step on this rank's rows of a padded batch; the global loss
    scalars and the gathered per-row outputs."""
    torch.set_num_threads(1)
    state, group = _state("anomaly_unet", sd, "sgd", 0.0, 0.0, {"base_features": base})
    out = make_anomaly_eval_step(loss_cfg, group=group)(
        state, *shard_batch((images, masks, valid)))
    rows = {k: gather_batches(out[k].numpy(), 1)
            for k in ("score", "error_map", "anomaly_map", "reconstruction", "image")}
    return {"losses": {k: float(v) for k, v in out["losses"].items()}, **rows}


def seg_step_and_eval(sd, base, n_classes, images, labels, draws, keeps, loss_cfg, aug_cfg, lr,
                      wd, eval_images, eval_labels, valid):
    """One seg SGD step on this rank's rows, then the eval step on a padded
    batch; rank 0's losses, matrices and state."""
    torch.set_num_threads(1)
    state, group = _state("seg_unet", sd, "sgd", lr, wd,
                          {"n_classes": n_classes, "base_features": base})
    step = make_seg_train_step(n_classes, loss_cfg, aug_cfg, group=group)
    img, lbl = shard_batch((images, labels))
    losses, cm = step.with_draws(state, img, lbl, draws, keeps)
    new = _numpy_state(state)
    ev_losses, preds, ev_cm = make_seg_eval_step(n_classes, loss_cfg, group=group)(
        state, *shard_batch((eval_images, eval_labels, valid)))
    return {"losses": {k: float(v) for k, v in losses.items()}, "cm": cm.numpy(),
            "state": new, "ranks_equal": _rank_states_equal(new),
            "eval_losses": {k: float(v) for k, v in ev_losses.items()},
            "eval_cm": ev_cm.numpy(), "preds": gather_batches(preds.numpy(), 1)}


def sync_bn_grads(sd, base, images, masks, draws, loss_cfg, aug_cfg):
    """The gradients of one anomaly step (SGD, lr 0: nothing moves) on this
    rank's rows, averaged over the ranks; and rank 0's gradients of the same
    step on the whole batch, alone in a group of one (the same BatchNorm
    arithmetic without the exchange)."""
    torch.set_num_threads(1)
    solo = dist.new_group([0])
    state, group = _state("anomaly_unet", sd, "sgd", 0.0, 0.0, {"base_features": base})
    step = make_anomaly_train_step(loss_cfg, aug_cfg, group=group)
    step.with_draws(state, *shard_batch((images, masks)), draws)
    out = {"ranks": {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()}}
    if rank() == 0:
        model = build_model("anomaly_unet", base_features=base)
        model.load_state_dict(sd)
        one = create_train_state(sync_batchnorm(model, solo), "sgd", 0.0, 0.0, device="cpu")
        make_anomaly_train_step(loss_cfg, aug_cfg, group=solo).with_draws(
            one, images, masks, draws)
        out["one"] = {n: p.grad.numpy().copy() for n, p in one.model.named_parameters()}
    return out


def fsdp_against_dp(sd, base, images, masks, draws_per_step, loss_cfg, aug_cfg, lr, wd,
                    ckpt_dir):
    """Three Adam steps under plain data parallelism and under FSDP from the
    same state; each one's state, losses and per-rank bytes. The FSDP run
    then writes a checkpoint (every rank joins the gather, rank 0 writes)."""
    torch.set_num_threads(1)
    out = {}
    for fsdp in (False, True):
        state, group = _state("anomaly_unet", sd, "adam", lr, wd, {"base_features": base},
                              fsdp=fsdp)
        step = make_anomaly_train_step(loss_cfg, aug_cfg, group=group)
        losses = [float(step.with_draws(state, *shard_batch((images, masks)), d)["total_loss"])
                  for d in draws_per_step]
        key = "fsdp" if fsdp else "dp"
        out[key] = {"state": _numpy_state(state), "losses": losses,
                    "bytes": per_device_state_bytes(state),
                    "jax_bytes": jax_placement_bytes(state, dist.get_world_size()),
                    "sharded_fraction": sharded_fraction(state),
                    "exp_avg": {k: v.numpy() for k, v in _full(
                        state.optimizer.state_dict())["state"][0].items()
                        if torch.is_tensor(v) and v.dim()},
                    "fused_flags": {k: state.optimizer.param_groups[0].get(k)
                                    for k in ("fused", "foreach")}}
        if fsdp:
            path = os.path.join(ckpt_dir, "fsdp.pth")
            with CheckpointWriter() as writer:
                writer.save(state, 7, losses[-1], path)
            out["ckpt"] = path
            out["opt_steps"] = int(_full(state.optimizer.state_dict())["state"][0]["step"])
    return out


def interrupt_epochs(n_epochs, signal_rank, signal_epoch):
    """Epochs run under a GracefulInterrupt on every rank, SIGTERM raised on
    ``signal_rank`` during ``signal_epoch``; each rank's last epoch and its
    step_poll."""
    torch.set_num_threads(1)
    with GracefulInterrupt() as intr:
        polls = intr.step_poll()
        last = None
        for epoch in range(n_epochs):
            if rank() == signal_rank and epoch == signal_epoch:
                os.kill(os.getpid(), signal.SIGTERM)
            last = epoch
            if intr.poll_global():
                break
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {"last": last, "triggered": intr.triggered,
                                   "step_poll": polls})
    return parts



def state_checks(sd, base, images, masks, draws, draws_per_step, loss_cfg, grad_aug,
                 aug_cfg, lr, wd, ckpt_dir):
    """:func:`sync_bn_grads` (under ``grad_aug``), :func:`fsdp_against_dp`
    and :func:`interrupt_epochs` in one launch."""
    return {"grads": sync_bn_grads(sd, base, images, masks, draws, loss_cfg, grad_aug),
            "fsdp": fsdp_against_dp(sd, base, images, masks, draws_per_step, loss_cfg,
                                    aug_cfg, lr, wd, ckpt_dir),
            "interrupt": interrupt_epochs(4, 1, 1)}
