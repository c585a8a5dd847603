"""Rank functions of the port's 'space' axis tests. Each runs on every rank
of a ``tpu_unet_torch.parallel.mesh.launch`` over CPU ranks (gloo) on a
('data', 'space', 'model') mesh and returns what rank 0 gathered; the
module imports the port and nothing of JAX, so a rank never starts JAX."""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.quantize import make_quantized_seg_eval_step, quantize_from_train_state
from tpu_unet_torch.ops.resize import resize_bilinear_align_corners
from tpu_unet_torch.parallel import spatial
from tpu_unet_torch.parallel.fsdp import shard_state
from tpu_unet_torch.parallel.mesh import (data_coords, data_rank, data_size, group_of,
                                          make_mesh, model_rank, rank, shard_batch,
                                          space_rank, space_size, world_size)
from tpu_unet_torch.train.checkpoint import _full
from tpu_unet_torch.train.state import create_train_state
from tpu_unet_torch.train.steps import make_seg_eval_step, make_seg_train_step


def _gather_objects(obj):
    if world_size() == 1:
        return [obj]
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, obj)
    return parts


def mesh_coords(n_space, n_model):
    """Every rank's (rank, data, space, model) coordinates and sizes, and
    the ranks of its batch and space groups."""
    torch.set_num_threads(1)
    mesh = make_mesh(world_size() // (n_space * n_model), n_space=n_space, n_model=n_model)
    batch, space = group_of(mesh), spatial.mesh_exchanger(mesh)
    mine = {"rank": rank(), "data": data_rank(), "space": space_rank(),
            "model": model_rank(), "sizes": (data_size(), space_size()),
            "mesh_data": data_coords(mesh),
            "names": tuple(mesh.mesh_dim_names), "shape": tuple(mesh.shape),
            "batch": dist.get_process_group_ranks(batch),
            "space_group": dist.get_process_group_ranks(space.group),
            "space_index": space.index}
    return _gather_objects(mine)


def primitives(n_space):
    """On a (1, n_space) mesh: a float64 3x3 conv through ``halo_rows``
    (forward, input and weight gradients), the sharded align-corners
    resizes (2x upsample, the gate's) in float32 and bfloat16, and a
    ``gather_rows``/``split_rows`` round trip, each gathered over the space
    ranks; ``spatial.COUNTERS`` of rank 0."""
    torch.set_num_threads(1)
    mesh = make_mesh(1, n_space=n_space)
    ex = spatial.mesh_exchanger(mesh)
    s, n = ex.index, ex.size
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8 * n, 8, dtype=torch.float64, generator=gen)
    w = torch.randn(5, 3, 3, 3, dtype=torch.float64, generator=gen)
    gy = torch.randn(2, 5, 8 * n, 8, dtype=torch.float64, generator=gen)
    h = 8
    xl = x[:, :, s * h:(s + 1) * h].clone().requires_grad_()
    wl = w.clone().requires_grad_()
    yl = F.conv2d(spatial.halo_rows(xl, ex), wl, padding=(0, 1))
    (yl * gy[:, :, s * h:(s + 1) * h]).sum().backward()
    out = {"conv": spatial.gather_rows(yl.detach(), ex, dim=2),
           "dx": spatial.gather_rows(xl.grad, ex, dim=2),
           "dw": ex.all_reduce(wl.grad), "x": x, "w": w, "gy": gy}
    with spatial.scope(ex):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn(2, 4, 4 * n, 6, generator=gen).to(dt)
            g = torch.randn(2, 1, 4 * n, 3, generator=gen).to(dt)
            up = resize_bilinear_align_corners(a[:, :, 4 * s:4 * (s + 1)], 8, 12)
            gate = resize_bilinear_align_corners(g[:, :, 4 * s:4 * (s + 1)], 8, 6)
            out[f"up_{dt}"] = (a, spatial.gather_rows(up, ex, dim=2))
            out[f"gate_{dt}"] = (g, spatial.gather_rows(gate, ex, dim=2))
    whole = torch.arange(2 * 4 * n * 3).reshape(2, 4 * n, 3)
    out["round_trip"] = torch.equal(
        spatial.gather_rows(spatial.split_rows(whole, ex), ex), whole)
    out["counters"] = dict(spatial.COUNTERS)
    return out


def _state(name, sd, model_kw, lr, wd, n_space, n_model, fsdp):
    model = build_model(name, **model_kw)
    model.load_state_dict(sd)
    state = create_train_state(model, "sgd", lr, wd, device="cpu")
    mesh = make_mesh(world_size() // (n_space * n_model), n_space=n_space, n_model=n_model)
    state = shard_state(mesh, state, fsdp=fsdp, tp=n_model > 1)
    return state, group_of(mesh), spatial.mesh_exchanger(mesh)


def _whole_state(state):
    from tpu_unet_torch.parallel.tensor import full_tensors

    msd, _ = full_tensors(state, _full(state.model.state_dict()),
                          _full(state.optimizer.state_dict()))
    return {k: v.numpy().copy() for k, v in msd.items()}


def seg_cases(name, sd, model_kw, n_space, n_model, cases, images, labels, loss_cfg,
              aug_cfg, lr, wd):
    """Per case ``(draws, keep, grad_accum, fsdp, eval)``: one seg SGD step
    from ``sd`` on this data rank's images (split over 'space' by the step),
    its losses, confusion matrix and whole state, whether every rank holds
    the same state, and with ``eval`` (images, labels, valid) the eval
    step's losses, gathered predictions and matrix on the updated state."""
    torch.set_num_threads(1)
    out = []
    for draws, keep, grad_accum, fsdp, ev in cases:
        state, group, space = _state(name, sd, model_kw, lr, wd, n_space, n_model, fsdp)
        step = make_seg_train_step(model_kw["n_classes"], loss_cfg, aug_cfg,
                                   grad_accum=grad_accum, group=group, space=space)
        img, lbl = shard_batch((images, labels), grad_accum)
        spatial.COUNTERS.update(exchanges=0, bytes=0)
        losses, cm = step.with_draws(state, img, lbl, draws, keep)
        res = {"losses": {k: float(v) for k, v in losses.items()}, "cm": cm.numpy(),
               "halo": dict(spatial.COUNTERS)}
        whole = _whole_state(state)
        res["state"] = whole
        res["agree"] = all(all(np.array_equal(p[k], whole[k]) for k in whole)
                           for p in _gather_objects(whole))
        if ev is not None:
            eval_step = make_seg_eval_step(model_kw["n_classes"], loss_cfg, group=group,
                                           space=space)
            ev_losses, preds, ev_cm = eval_step(state, *shard_batch(ev))
            res.update(eval_losses={k: float(v) for k, v in ev_losses.items()},
                       eval_cm=ev_cm.numpy(), preds=_data_rows(preds.numpy()))
        out.append(res)
    return out


def _data_rows(local):
    """The data ranks' rows in the global batch order (every space and
    model rank of a data index holds the same rows)."""
    parts = _gather_objects((data_rank(), space_rank(), model_rank(), local))
    return np.concatenate([p[3] for p in sorted(parts, key=lambda p: p[0])
                           if p[1] == 0 and p[2] == 0])


def int8_eval(arch, sd, model_kw, n_space, calib, images, labels, valid, loss_cfg):
    """The int8 seg eval step on this data rank's images of a padded batch,
    split over 'space' (K2's plain version on the CPU): the global losses,
    the gathered predictions and the matrix."""
    torch.set_num_threads(1)
    mesh = make_mesh(world_size() // n_space, n_space=n_space)
    qparams = quantize_from_train_state(arch, sd, [calib], device="cpu")
    step = make_quantized_seg_eval_step(model_kw["n_classes"], loss_cfg, arch=arch,
                                        group=group_of(mesh),
                                        space=spatial.mesh_exchanger(mesh))
    spatial.COUNTERS.update(exchanges=0, bytes=0)
    losses, preds, cm = step(qparams, *shard_batch((images, labels, valid)))
    return {"losses": {k: float(v) for k, v in losses.items()}, "cm": cm.numpy(),
            "preds": _data_rows(preds.numpy()), "halo": dict(spatial.COUNTERS)}
