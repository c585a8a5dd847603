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
    with spatial.scope(ex, 8 * n):
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


def _whole_ops(plan, level):
    """Per row operation at ``level`` (1..4): (name, the whole image's op,
    the rank's op under the scope, the input's rows and the output's, as
    functions of the rank's index). float64 throughout."""
    from tpu_unet_torch.ops.resize import interp_axis

    t0, t1 = plan.totals[level - 1], plan.totals[level]
    dh = t0 - 2 * t1
    pad = (0, 0, dh // 2, dh - dh // 2)
    up, prev = plan.levels[level], plan.levels[level - 1]
    return [
        ("pool", t0, lambda x: F.max_pool2d(x, 2),
         lambda x: spatial.empty_safe(lambda t: F.max_pool2d(t, 2),
                                      spatial.pool_rows(x, level), 2), prev, up),
        ("pad", 2 * t1, lambda x: F.pad(x, pad), lambda x: spatial.pad_rows(x, level - 1),
         tuple((2 * a, 2 * b) for a, b in up), prev),
        ("stride2", t0, lambda x: x[:, :, ::2],
         lambda x: spatial.stride2_rows(x, level - 1)[:, :, ::2], prev,
         tuple((-(-a // 2), -(-b // 2)) for a, b in prev)),
        ("resize", t1, lambda x: interp_axis(x, t0, 2),
         lambda x: spatial.resize_rows(x, level - 1, 2), up, prev),
        ("upsample", t1, lambda x: F.pad(interp_axis(x, 2 * t1, 2), pad),
         lambda x: spatial.upsample_rows(x, level - 1, 2), up, prev),
    ]


def moves(n_space, heights):
    """On a (1, n_space) mesh, for each image height: every row operation
    of every level (the max-pool, the transposed conv's pad, the gate's
    stride 2, the gate's resize, the bilinear upsample and its pad, and a
    3x3 conv through the halo) on the rank's rows of the scope's plan,
    forward and input gradient, against the same op on the whole tensor
    sliced to the rank's rows (the plan's blocks; the pool's and the
    stride's output blocks are the plan's and the stride's ceil). Returns
    rank 0's list of mismatches from all ranks and the count of checks."""
    torch.set_num_threads(1)
    ex = spatial.mesh_exchanger(make_mesh(1, n_space=n_space))
    i = ex.index
    failures, checked = [], 0

    def compare(what, got, want, exact):
        if got.shape != want.shape or not (
                torch.equal(got, want) if exact else
                torch.allclose(got, want, rtol=0, atol=1e-12)):
            failures.append(f"{what} on rank {i}: {tuple(got.shape)} vs {tuple(want.shape)}")

    for height in heights:
        plan = spatial.row_plan(height, n_space)
        gen = torch.Generator().manual_seed(height)
        cases = []
        for level in range(1, 5):
            if plan.totals[level]:
                cases += [(level, *op) for op in _whole_ops(plan, level)]
        for level in range(5):
            if plan.totals[level]:
                w = torch.randn(4, 3, 3, 3, dtype=torch.float64, generator=gen)
                blocks = plan.levels[level]
                cases.append((level, "halo_conv", plan.totals[level],
                              lambda x, w=w: F.conv2d(x, w, padding=1),
                              lambda x, w=w, lv=level: spatial.empty_safe(
                                  lambda t: F.conv2d(t, w, padding=(0, 1)),
                                  spatial.halo(x, lv), 3), blocks, blocks))
        for level, name, rows, whole, local, have, want in cases:
            x = torch.randn(2, 3, rows, 5, dtype=torch.float64, generator=gen)
            xw = x.clone().requires_grad_()
            y = whole(xw)
            gy = torch.randn(y.shape, dtype=torch.float64, generator=gen)
            (y * gy).sum().backward()
            (a, b), (c, d) = have[i], want[i]
            xl = x[:, :, a:b].clone().requires_grad_()
            with spatial.scope(ex, height):
                yl = local(xl)
            (yl * gy[:, :, c:d]).sum().backward()
            exact = name in ("pool", "pad", "stride2")
            what = f"H={height} level {level} {name}"
            compare(what, yl.detach(), y.detach()[:, :, c:d], exact)
            compare(what + " grad", xl.grad, xw.grad[:, :, a:b], exact)
            checked += 1
    parts = _gather_objects((failures, checked))
    return {"failures": [f for p in parts for f in p[0]], "checked": parts[0][1]}


def _state(name, sd, model_kw, lr, wd, n_space, n_model, fsdp, remat="none"):
    model = build_model(name, **model_kw)
    if remat == "full_res":  # the blocks SegmentationUNet(remat_full_res=True) tags
        model._tag_full_res([""])
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
    """Per case ``(draws, keep, grad_accum, fsdp, eval[, remat])``: one seg
    SGD step from ``sd`` on this data rank's images (split over 'space' by
    the step), its losses, confusion matrix and whole state, whether every
    rank holds the same state, and with ``eval`` (images, labels, valid) the
    eval step's losses, gathered predictions and matrix on the updated
    state. ``remat`` 'full_res' tags the SegmentationUNet's blocks."""
    torch.set_num_threads(1)
    out = []
    for draws, keep, grad_accum, fsdp, ev, *remat in cases:
        remat = remat[0] if remat else "none"
        state, group, space = _state(name, sd, model_kw, lr, wd, n_space, n_model, fsdp,
                                     remat)
        step = make_seg_train_step(model_kw["n_classes"], loss_cfg, aug_cfg,
                                   grad_accum=grad_accum, remat=remat, group=group,
                                   space=space)
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
