"""Train and eval steps of the MVTec anomaly task and of the segmentation
task (counterpart of ``tpu_unet/train/steps.py``).

A train step takes a uint8 NHWC batch and its masks, runs the device
augment (``ops/augment.py::train_transform``), the model in train mode on
the NCHW view of the batch (channels_last in memory), the combined loss on
NHWC views of the outputs, the backward pass and one optimizer update. It
updates the :class:`TrainState` in place and returns the loss scalars as
device tensors, so the host waits for nothing inside a run of steps.

Each train step's call is one ``train.step`` span, over ``train.augment``,
``train.forward``, ``train.loss``, ``train.backward``, ``train.optimizer``
and, in the seg step, ``train.confusion`` (``utils/spans.py``; recorded
only under a profiler or ``spans.recording()``). The backward's kernels,
which the autograd thread launches, fall in the calling thread's
``train.backward``.

The epoch drivers (``train/loop.py``) hand the steps the loader's batches,
tensors already on the state's device, copied from pinned memory by the
loader's ``data/loader.py::to_device`` transform.
The steps also take numpy arrays, at the cost described in :func:`_as_tensor`.

The JAX step draws its augmentation (and the seg model's dropout) from a
key. Here ``step(state, images_u8, masks, generator)`` makes the draws from
a ``torch.Generator`` on the state's device, and
``step.with_draws(state, images_u8, masks, draws[, dropout])`` takes them as
given.

Data parallelism (``group``, a ``torch.distributed`` process group of W
ranks, the JAX step on a W-device 'data' mesh): each rank passes its rows
of the global batch (``parallel/mesh.py::shard_batch``; under
``grad_accum`` its block of each microbatch in turn), and every rank draws
the global batch's augment draws and dropout masks from a generator seeded
alike, then takes its rows, so per-batch draws (one shear angle, the
jitter order) are the same everywhere. BatchNorm takes the global
statistics once the state is placed on the mesh
(``parallel/fsdp.py::shard_state``), the losses divide by global
denominators, and after the microbatch loop one all-reduce per gradient
dtype averages the gradients (FSDP's sharded gradients come averaged by
its reduce-scatter). The returned loss scalars and confusion matrices are
the global batch's, the same on every rank. The eval steps take the group
for their loss scalars (and the seg matrix) and return per-row outputs of
the rank's rows.

Under tensor parallelism (``parallel/tensor.py``) ``group`` is the mesh's
'data' group (``parallel/mesh.py::group_of``; None when it is 1 wide):
every model rank of a data index holds the same rows and draws, the
gradients are averaged and the denominators summed over 'data' only, and
the model's forward runs the collectives over 'model' itself, so the
replicated leaves stay equal on every rank.

The 'space' axis (the seg steps' ``space``, an exchanger of
``parallel/spatial.py``; ``group`` is then the batch group, data x space,
whose rank index is d * n_space + s): every space rank of data index d
takes the same images and draws, runs the augment on its block's whole
images (rotation moves rows between ranks and the contrast jitter takes
each image's mean), then keeps its block of the rows of the images and
labels; under ``grad_accum`` the batch splits over N first, then over H.
The model runs under ``spatial.scope(space, H)`` (halo rows for the 3x3
convs and the row moves of the pools, level-ups and gates on every level's
blocks of the image's rows, however uneven), Dice adds its sums over the space
ranks, and the gradient mean, BatchNorm, the denominators and the confusion
matrix reduce over the batch group. The eval steps take the data rank's
whole images too, run K1 and the model on the rank's rows and return the
predictions' rows gathered over 'space', whole images.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from tpu_unet_torch.losses.anomaly import combined_anomaly_loss
from tpu_unet_torch.losses.segmentation import combined_segmentation_loss
from tpu_unet_torch.metrics.anomaly import anomaly_error_map, anomaly_score
from tpu_unet_torch.metrics.confusion import confusion_matrix_batch
from tpu_unet_torch.models.blocks import (checkpoint, graph_replay, refuse_train_only,
                                          remat_scope)
from tpu_unet_torch.ops.augment import (AugmentDraws, eval_transform,
                                        sample_augment_draws, train_transform)
from tpu_unet_torch.ops.seg_head import sliced_argmax
from tpu_unet_torch.parallel import spatial
from tpu_unet_torch.train.state import TrainState
from tpu_unet_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    degrees: float = 10.0
    p_flip: float = 0.5
    brightness: float = 0.1
    contrast: float = 0.1
    saturation: float = 0.1
    hue: float = 0.05
    # 'per_batch_shear' (default): one angle drawn per batch; 'per_sample_shear':
    # one angle drawn per image; both rotate by three shears
    # (ops/rotate_shear.py). 'per_sample': one angle drawn per image, rotated
    # by the 4-corner gather (reference semantics).
    rotation_mode: str = "per_batch_shear"
    # torchvision draws the ColorJitter order per call; True does so per batch.
    color_jitter_random_order: bool = False

    def kwargs(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def transform_kwargs(self) -> Dict[str, Any]:
        """The keywords of ``train_transform``: all but ``p_flip``, which
        only the draws use."""
        kw = self.kwargs()
        del kw["p_flip"]
        return kw


@dataclasses.dataclass(frozen=True)
class AnomalyLossConfig:
    recon_weight: float = 1.0
    seg_weight: float = 1.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    recon_loss_type: str = "mse"  # 'mse' | 'ssim'

    def kwargs(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SegLossConfig:
    ce_weight: float = 1.0
    dice_weight: float = 1.0
    focal_weight: float = 0.0
    class_weights: Optional[Tuple[float, ...]] = None
    ignore_index: Optional[int] = None

    def kwargs(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) on ``device``. A numpy array is
    copied from pageable memory, and on CUDA such a copy first waits for the
    stream to drain; a tensor already on ``device`` costs nothing."""
    return torch.as_tensor(x).to(device)


REMAT_MODES = ("none", "full_res", "full")


def _remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the step's ``remat`` mode: 'full_res' checkpoints
    the blocks the model tagged 'full_res' (``models/blocks.py``; a model
    without tags runs as under 'none'), 'full' checkpoints the whole of
    ``fn`` (JAX's plain ``jax.checkpoint``). Recomputed BatchNorms leave
    their running statistics alone, so they move once, as in the plain step."""
    if remat == "full":
        return checkpoint(fn, *args)
    with remat_scope("full_res" if remat == "full_res" else None):
        return fn(*args)


def _data_coords(group, space=None) -> Tuple[int, int]:
    """``(n_data, d)``: the data ranks of the batch ``group`` and this
    rank's index among them (a group's rank index is d * n_space + s)."""
    if group is None:
        return 1, 0
    n_space = 1 if space is None else space.size
    return dist.get_world_size(group) // n_space, dist.get_rank(group) // n_space


def _rows(x: torch.Tensor, group, m: int, space=None) -> torch.Tensor:
    """This data rank's ``m`` rows of a global microbatch's per-row draw."""
    d = _data_coords(group, space)[1]
    return x[d * m:(d + 1) * m]


Keep = Union[None, torch.Tensor, Tuple[torch.Tensor, ...]]


def _map_keep(fn, keep: Keep) -> Keep:
    """``fn`` of each mask of a model's dropout draw: None, one keep mask
    (SegmentationUNet's) or a tuple of them (TransUNet's, SegFormer's)."""
    if keep is None:
        return None
    return fn(keep) if isinstance(keep, torch.Tensor) else tuple(fn(k) for k in keep)


def _local_draws(d: AugmentDraws, group, m: int, space=None) -> AugmentDraws:
    """This data rank's rows of a global microbatch's draws; a per-batch
    angle and the jitter order are shared."""
    if group is None:
        return d
    rows = lambda x: _rows(x, group, m, space)  # noqa: E731
    return dataclasses.replace(
        d, flip=rows(d.flip), fb=rows(d.fb), fc=rows(d.fc), fs=rows(d.fs), fh=rows(d.fh),
        angle=d.angle if d.angle.dim() == 0 else rows(d.angle))


def _group_mean(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each scalar averaged over the ranks, in one all-reduce: the ranks'
    losses are numerators over global denominators times W, so the mean is
    the global batch's loss."""
    if group is None:
        return values
    names = list(values)
    v = torch.stack([values[k].detach().to(torch.float32) for k in names])
    dist.all_reduce(v, group=group)
    v = v / dist.get_world_size(group)
    return dict(zip(names, v.unbind()))


def _group_sum(t: Optional[torch.Tensor], group) -> Optional[torch.Tensor]:
    if group is None or t is None:
        return t
    dist.all_reduce(t, group=group)
    return t


def _finish_gradients(model, grad_accum: int, group) -> None:
    """Divide the accumulated gradients by ``grad_accum`` and, under a
    group, average them over its ranks: one all-reduce of the flattened
    gradients per dtype. FSDP's sharded (DTensor) gradients come averaged
    over the ranks already."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if group is None:
        if grad_accum > 1:
            for g in grads:
                g.div_(grad_accum)
        return
    from torch.distributed.tensor import DTensor

    w = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        if isinstance(g, DTensor):
            if grad_accum > 1:
                g.div_(grad_accum)
        else:
            by_dtype.setdefault(g.dtype, []).append(g)
    for bucket in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(w * grad_accum)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()


def _forward_anomaly(model, img: torch.Tensor, dual_decoder: bool):
    """Model on NHWC ``img`` -> NHWC (reconstruction, anomaly map).
    ``dual_decoder=False``: a plain UNet's sigmoid(logits) is the map and the
    input stands in as the reconstruction."""
    out = model(img.permute(0, 3, 1, 2))
    if dual_decoder:
        recon, amap = out
        return recon.permute(0, 2, 3, 1), amap.permute(0, 2, 3, 1)
    return img, torch.sigmoid(out).permute(0, 2, 3, 1)


class AnomalyTrainStep:
    """``step(state, images_u8, masks, generator) -> losses`` and
    ``step.with_draws(state, images_u8, masks, draws) -> losses``; built by
    :func:`make_anomaly_train_step`."""

    def __init__(self, loss_cfg: AnomalyLossConfig, aug_cfg: AugmentConfig,
                 dual_decoder: bool, grad_accum: int, remat: str = "none", group=None):
        self.loss_cfg = loss_cfg
        self.aug_cfg = aug_cfg
        self.dual_decoder = dual_decoder
        self.grad_accum = grad_accum
        self.remat = remat
        self.group = group

    def draws(self, n: int, generator: torch.Generator) -> List[AugmentDraws]:
        """One draw set per microbatch of the global batch, whose rows this
        rank's ``n`` are."""
        self._check_batch(n)
        m = n * _data_coords(self.group)[0] // self.grad_accum
        return [sample_augment_draws(m, self.aug_cfg, generator)
                for _ in range(self.grad_accum)]

    def __call__(self, state: TrainState, images_u8, masks,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return self.with_draws(state, images_u8, masks,
                               self.draws(len(images_u8), generator))

    def _check_batch(self, n: int) -> None:
        if n % self.grad_accum:
            raise ValueError(f"anomaly train step: batch size {n} is not divisible "
                             f"by grad_accum={self.grad_accum}")

    def with_draws(self, state: TrainState, images_u8, masks,
                   draws: Union[AugmentDraws, List[AugmentDraws]]
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer update from the batch under the given draws (one
        :class:`AugmentDraws`, or a list of ``grad_accum`` of them, each for
        a microbatch of the global batch)."""
        with span("train.step"):
            device = state.device
            images_u8, masks = _as_tensor(images_u8, device), _as_tensor(masks, device)
            draws = [draws] if isinstance(draws, AugmentDraws) else list(draws)
            g = self.grad_accum
            self._check_batch(len(images_u8))
            if len(draws) != g:
                raise ValueError(f"{len(draws)} draw sets for grad_accum={g}")
            model = state.model.train()
            with span("train.optimizer"):
                state.optimizer.zero_grad(set_to_none=True)
            losses: List[Dict[str, torch.Tensor]] = []
            rows = len(images_u8) // g
            # Microbatches in sequence; BN running statistics chain through them
            # and the gradients add up in .grad.
            for img_u8, msk, d in zip(images_u8.chunk(g), masks.chunk(g), draws):
                with span("train.augment"):
                    img, m = train_transform(img_u8, msk,
                                             _local_draws(d.to(device), self.group, rows),
                                             **self.aug_cfg.transform_kwargs())
                    # Masks may ship as uint8; the geometric step is nearest on
                    # masks, so the cast after it is exact.
                    m = m.to(torch.float32)
                with span("train.forward"):
                    recon, amap = _remat_call(
                        self.remat, lambda x: _forward_anomaly(model, x, self.dual_decoder),
                        img)
                with span("train.loss"):
                    ld = combined_anomaly_loss(recon, amap, img, m, group=self.group,
                                               **self.loss_cfg.kwargs())
                with span("train.backward"):
                    ld["total_loss"].backward()
                losses.append({k: v.detach() for k, v in ld.items()})
            with span("train.optimizer"):
                _finish_gradients(model, g, self.group)
                state.optimizer.step()
            state.step += 1
            with span("train.loss"):
                return _group_mean({k: torch.stack([ld[k] for ld in losses]).mean()
                                    for k in losses[0]}, self.group)


def make_anomaly_train_step(loss_cfg: AnomalyLossConfig = AnomalyLossConfig(),
                            aug_cfg: AugmentConfig = AugmentConfig(),
                            dual_decoder: bool = True, grad_accum: int = 1,
                            remat: str = "none", group=None) -> AnomalyTrainStep:
    """The anomaly train step.

    images_u8: (N, H, W, 3) uint8; masks: (N, H, W, 1) float32 in [0, 1] or
    uint8 {0, 1}. ``dual_decoder=False`` trains a plain UNet as a focal-loss
    segmenter (the recon term is then 0).

    ``grad_accum=G`` runs G microbatches of N/G in sequence, each with its own
    draws and its own batch statistics (the running statistics chain through
    them); the gradient sum is divided by G and one update runs. The losses
    are the mean over microbatches.

    ``remat`` trades compute for activation memory: 'full_res' recomputes
    in the backward the blocks that the model tagged (``AnomalyUNet(...,
    remat_full_res=True)``: the full- and half-resolution rows), 'full' the
    whole forward; 'none' keeps every activation. The losses, the BN running
    statistics and, up to the backward's own rounding, the update are the
    plain step's.

    ``group``: data parallelism over a process group (module docstring);
    ``images_u8`` and ``masks`` are then this rank's rows.
    """
    _check_step_flags(grad_accum, remat)
    return AnomalyTrainStep(loss_cfg, aug_cfg, dual_decoder, grad_accum, remat, group)


def _check_step_flags(grad_accum: int, remat: str) -> None:
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be 'none'|'full_res'|'full', got {remat!r}")


def make_anomaly_eval_step(loss_cfg: AnomalyLossConfig = AnomalyLossConfig(),
                           dual_decoder: bool = True, group=None):
    """``step(state, images_u8, masks, valid=None) -> outputs``.

    The model runs in eval mode (running statistics, no update) on
    ``eval_transform``'s output (K1 on CUDA tensors). ``valid`` (optional
    (N,) bool or float) marks the real rows of a padded batch; the loss
    scalars cover those rows only; under a data-parallel ``group`` they are
    the global batch's (the same on every rank), the rest the rank's rows.
    The outputs, all NHWC or per image:
    ``losses``, ``score`` (N,), ``error_map`` (N, H, W), ``anomaly_map``
    (N, H, W), ``reconstruction`` and ``image``.
    """

    def step(state: TrainState, images_u8, masks, valid=None) -> Dict[str, Any]:
        device = state.device
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                img = eval_transform(_as_tensor(images_u8, device))
                m = _as_tensor(masks, device).to(torch.float32)
                if valid is not None:
                    valid = _as_tensor(valid, device)
                recon, amap = _forward_anomaly(model, img, dual_decoder)
                losses = combined_anomaly_loss(recon, amap, img, m, sample_weight=valid,
                                               group=group, **loss_cfg.kwargs())
                return {
                    "losses": _group_mean(losses, group),
                    "score": anomaly_score(recon, img),
                    "error_map": anomaly_error_map(recon, img),
                    "anomaly_map": amap[..., 0],
                    "reconstruction": recon,
                    "image": img,
                }
        finally:
            model.train(was_training)

    return step


# ---------------------------------------------------------------------------
# Semantic segmentation (SegmentationUNet on Gear / KolektorSDD)
# ---------------------------------------------------------------------------

def _seg_logits(model, img: torch.Tensor, keep: Optional[torch.Tensor] = None):
    """Model on NHWC ``img`` -> NHWC logits (a view of the NCHW output), or
    a tuple of them (UNet++'s deep supervision heads in train mode).
    ``keep`` is the bottleneck dropout's draw; models without one take none."""
    x = img.permute(0, 3, 1, 2)
    out = model(x) if keep is None else model(x, keep=keep)
    if isinstance(out, tuple):
        return tuple(t.permute(0, 2, 3, 1) for t in out)
    return out.permute(0, 2, 3, 1)


def _seg_train_losses(logits, labels: torch.Tensor, loss_cfg: SegLossConfig, group=None,
                      space=None):
    """The loss dict of a train-mode forward, and the logits the predictions
    come from. Deep supervision (a tuple of head logits): one loss per head,
    averaged key by key, and the deepest head's logits."""
    if not isinstance(logits, tuple):
        return combined_segmentation_loss(logits, labels, group=group, space=space,
                                          **loss_cfg.kwargs()), logits
    per = [combined_segmentation_loss(t, labels, group=group, space=space,
                                      **loss_cfg.kwargs())
           for t in logits]
    return {k: sum(p[k] for p in per) / len(per) for k in per[0]}, logits[-1]


def seg_eval_outputs(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                     loss_cfg: SegLossConfig, valid=None, group=None, space=None):
    """``(losses, preds, cm)`` of an eval batch from its NHWC logits: the
    loss over the ``valid`` rows, ``sliced_argmax`` predictions and the
    batch's confusion matrix, all left on the device. The matrix, too,
    counts the ``valid`` rows only; the JAX package drops a padded batch's
    rows on the host instead, with the same counts. Under a data-parallel
    ``group`` the losses and the matrix are the global batch's and
    ``preds`` the rank's rows; under ``space`` the logits and labels are
    the rank's rows of them and ``preds`` is gathered back to whole images."""
    losses = combined_segmentation_loss(logits, labels, sample_weight=valid,
                                        group=group, space=space, **loss_cfg.kwargs())
    preds = sliced_argmax(logits)
    cm = confusion_matrix_batch(preds, labels, num_classes, loss_cfg.ignore_index,
                                valid=valid)
    return (_group_mean(losses, group), spatial.gather_rows(preds, space),
            _group_sum(cm, group))


class SegTrainStep:
    """``step(state, images_u8, labels, generator) -> (losses, cm)`` and
    ``step.with_draws(state, images_u8, labels, draws, dropout=None)``;
    built by :func:`make_seg_train_step`."""

    def __init__(self, num_classes: int, loss_cfg: SegLossConfig,
                 aug_cfg: AugmentConfig, with_confusion: bool, grad_accum: int,
                 remat: str = "none", group=None, space=None):
        self.num_classes = num_classes
        self.loss_cfg = loss_cfg
        self.aug_cfg = aug_cfg
        self.with_confusion = with_confusion
        self.grad_accum = grad_accum
        self.remat = remat
        self.group = group
        self.space = space

    def _check_batch(self, n: int) -> None:
        if n % self.grad_accum:
            raise ValueError(f"seg train step: batch size {n} is not divisible "
                             f"by grad_accum={self.grad_accum}")

    def draws(self, model, n: int, generator: torch.Generator
              ) -> Tuple[List[AugmentDraws], List[Keep]]:
        """The augment draws and dropout draws (the model's
        ``sample_dropout``: a keep mask or a tuple of them) of each
        microbatch of the global batch whose rows this rank's ``n`` are,
        drawn in that order, microbatch by microbatch."""
        self._check_batch(n)
        m = n * _data_coords(self.group, self.space)[0] // self.grad_accum
        sample_dropout = getattr(model, "sample_dropout", None)
        augment, dropout = [], []
        for _ in range(self.grad_accum):
            augment.append(sample_augment_draws(m, self.aug_cfg, generator))
            dropout.append(sample_dropout(m, generator) if sample_dropout else None)
        return augment, dropout

    def __call__(self, state: TrainState, images_u8, labels, generator: torch.Generator):
        augment, dropout = self.draws(state.model, len(images_u8), generator)
        return self.with_draws(state, images_u8, labels, augment, dropout)

    def with_draws(self, state: TrainState, images_u8, labels,
                   draws: Union[AugmentDraws, List[AugmentDraws]],
                   dropout: Union[Keep, List[Keep]] = None):
        """One optimizer update from the batch under the given draws: one
        :class:`AugmentDraws` and one dropout draw (the model's: an (N, C5)
        keep mask, or TransUNet's or SegFormer's tuple of masks), or a list of
        ``grad_accum`` of each, for microbatches of the global batch.
        ``dropout=None`` is only for a model without dropout. Returns the
        loss scalars (the mean over microbatches) and
        the batch's (C, C) confusion matrix (None without ``with_confusion``),
        all on the device."""
        with span("train.step"):
            device = state.device
            images_u8, labels = _as_tensor(images_u8, device), _as_tensor(labels, device)
            g = self.grad_accum
            self._check_batch(len(images_u8))
            space, height = self.space, images_u8.shape[1]
            spatial.check_rows(height, space.size if space is not None else 1)
            draws = [draws] if isinstance(draws, AugmentDraws) else list(draws)
            if dropout is None:
                dropout = [None] * g
            elif not isinstance(dropout, list):
                dropout = [dropout]
            if len(draws) != g or len(dropout) != g:
                raise ValueError(f"{len(draws)} draw sets and {len(dropout)} dropout masks "
                                 f"for grad_accum={g}")
            model = state.model.train()
            if space is not None:
                refuse_train_only(model, "the 'space' axis")
            with span("train.optimizer"):
                state.optimizer.zero_grad(set_to_none=True)
            losses: List[Dict[str, torch.Tensor]] = []
            cm = None
            rows = len(images_u8) // g
            # A model may replay CUDA graphs where their gradient buffers may
            # become .grad: the first microbatch, no group, no remat.
            graphs = self.group is None and self.remat == "none"
            for i, (img_u8, lbl, d, keep) in enumerate(zip(images_u8.chunk(g), labels.chunk(g),
                                                           draws, dropout)):
                with span("train.augment"):
                    # Labels ship as uint8; the geometry is nearest on them, so
                    # the cast to int64 (which the gathers take) after it is
                    # exact. Whole images through the augment, then this space
                    # rank's rows.
                    img, lbl = train_transform(img_u8, lbl[..., None],
                                               _local_draws(d.to(device), self.group, rows,
                                                            space),
                                               **self.aug_cfg.transform_kwargs())
                    img = spatial.split_rows(img, space)
                    lbl = spatial.split_rows(lbl[..., 0], space).to(torch.int64)
                    keep = _map_keep(lambda k: k.to(device), keep)
                    if self.group is not None:
                        keep = _map_keep(lambda k: _rows(k, self.group, rows, space), keep)
                with spatial.scope(space, height):
                    with span("train.forward"), (graph_replay() if graphs and i == 0
                                                 else contextlib.nullcontext()):
                        logits = _remat_call(self.remat,
                                             lambda x, k=keep: _seg_logits(model, x, k), img)
                    with span("train.loss"):
                        ld, logits = _seg_train_losses(logits, lbl, self.loss_cfg,
                                                       self.group, space)
                    with span("train.backward"):
                        ld["total_loss"].backward()
                losses.append({k: v.detach() for k, v in ld.items()})
                if self.with_confusion:
                    with span("train.confusion"):
                        part = confusion_matrix_batch(sliced_argmax(logits.detach()), lbl,
                                                      self.num_classes,
                                                      self.loss_cfg.ignore_index)
                        cm = part if cm is None else cm + part
            with span("train.optimizer"):
                _finish_gradients(model, g, self.group)
                state.optimizer.step()
            state.step += 1
            with span("train.loss"):
                return (_group_mean({k: torch.stack([ld[k] for ld in losses]).mean()
                                     for k in losses[0]}, self.group),
                        _group_sum(cm, self.group))


def make_seg_train_step(num_classes: int, loss_cfg: SegLossConfig = SegLossConfig(),
                        aug_cfg: AugmentConfig = AugmentConfig(),
                        with_confusion: bool = True, grad_accum: int = 1,
                        remat: str = "none", group=None, space=None) -> SegTrainStep:
    """The segmentation train step.

    images_u8: (N, H, W, 3) uint8; labels: (N, H, W) integer class ids
    (uint8 as the datasets ship them). The image and its labels go through
    the paired augment (bilinear on the image, nearest on the labels), the
    model in train mode (the bottleneck dropout under the step's keep mask),
    the loss on float32 logits and one optimizer update. The batch's
    confusion matrix comes from ``sliced_argmax`` of the augmented batch's
    logits and stays on the device. With UNet++'s deep supervision the loss
    is the mean of the four heads' losses, key by key, and the predictions
    come from the deepest head (``logits[-1]``).

    ``grad_accum=G`` runs G microbatches in sequence, each with its own
    augment draws and dropout mask and its own batch statistics (the running
    statistics chain through them); the gradient sum is divided by G, one
    update runs, the losses are the microbatches' mean and the confusion
    matrices their sum. ``remat`` 'full_res' (the blocks that
    ``SegmentationUNet(..., remat_full_res=True)`` tags; UNet++ and the
    attention UNet have no tags) or 'full' recomputes activations in the
    backward, as in :func:`make_anomaly_train_step`. ``group``: data
    parallelism over a process group; ``space``: the rows of each image
    split over the space ranks, ``group`` then the batch group (module
    docstring).
    """
    _check_step_flags(grad_accum, remat)
    return SegTrainStep(num_classes, loss_cfg, aug_cfg, with_confusion, grad_accum, remat,
                        group, space)


def make_seg_eval_step(num_classes: int, loss_cfg: SegLossConfig = SegLossConfig(),
                       group=None, space=None):
    """``step(state, images_u8, labels, valid=None) -> (losses, preds, cm)``.

    The model runs in eval mode on ``eval_transform``'s output (K1 on CUDA
    tensors). ``valid`` (optional (N,) bool or float) marks the real rows of
    a padded batch: the loss and the confusion matrix cover those rows only
    (:func:`seg_eval_outputs`). ``preds`` is (N, H, W) int64. Under
    ``space`` K1 and the model run on this rank's rows of the images, and
    ``preds`` comes back whole (module docstring).
    """

    def step(state: TrainState, images_u8, labels, valid=None):
        device = state.device
        model = state.model
        if space is not None:
            refuse_train_only(model, "the 'space' axis")
        was_training = model.training
        model.eval()
        try:
            height = images_u8.shape[1]
            with torch.no_grad(), spatial.scope(space, height):
                img, lbl = space_rows(_as_tensor(images_u8, device),
                                      _as_tensor(labels, device), space)
                img = eval_transform(img)
                if valid is not None:
                    valid = _as_tensor(valid, device)
                return seg_eval_outputs(_seg_logits(model, img), lbl, num_classes,
                                        loss_cfg, valid, group, space)
        finally:
            model.train(was_training)

    return step


def space_rows(images_u8: torch.Tensor, labels: torch.Tensor, space):
    """This space rank's rows of an eval batch's NHWC images and (N, H, W)
    labels (int64), after the heights check; the whole batch without
    ``space``."""
    if space is not None:
        spatial.check_rows(images_u8.shape[1], space.size)
    return (spatial.split_rows(images_u8, space),
            spatial.split_rows(labels, space).to(torch.int64))
