"""Train and eval steps of the MVTec anomaly task (counterpart of the anomaly
half of ``tpu_unet/train/steps.py``).

A train step takes a uint8 NHWC batch and its masks, runs the device
augment (``ops/augment.py::train_transform``), the model in train mode on
the NCHW view of the batch (channels_last in memory), the combined loss on
NHWC views of the outputs, the backward pass and one optimizer update. It
updates the :class:`TrainState` in place and returns the loss scalars as
device tensors, so the host waits for nothing inside a run of steps.

The JAX step draws its augmentation from a key. Here
``step(state, images_u8, masks, generator)`` makes the draws from a
``torch.Generator`` on the state's device, and
``step.with_draws(state, images_u8, masks, draws)`` takes them as given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from tpu_unet_torch.losses.anomaly import combined_anomaly_loss
from tpu_unet_torch.metrics.anomaly import anomaly_error_map, anomaly_score
from tpu_unet_torch.ops.augment import (AugmentDraws, eval_transform,
                                        sample_augment_draws, train_transform)
from tpu_unet_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    degrees: float = 10.0
    p_flip: float = 0.5
    brightness: float = 0.1
    contrast: float = 0.1
    saturation: float = 0.1
    hue: float = 0.05
    # 'per_batch_shear' (default): one angle per batch, three shear matmuls;
    # 'per_sample_shear': one angle per image, K-tap banded shears;
    # 'per_sample': one angle per image, the 4-corner gather (reference
    # semantics). See ops/rotate_shear.py.
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
    return torch.as_tensor(x).to(device)


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
                 dual_decoder: bool, grad_accum: int):
        self.loss_cfg = loss_cfg
        self.aug_cfg = aug_cfg
        self.dual_decoder = dual_decoder
        self.grad_accum = grad_accum

    def draws(self, n: int, generator: torch.Generator) -> List[AugmentDraws]:
        """One draw set per microbatch of a batch of ``n``."""
        self._check_batch(n)
        return [sample_augment_draws(n // self.grad_accum, self.aug_cfg, generator)
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
        :class:`AugmentDraws`, or a list of ``grad_accum`` of them)."""
        device = state.device
        images_u8, masks = _as_tensor(images_u8, device), _as_tensor(masks, device)
        draws = [draws] if isinstance(draws, AugmentDraws) else list(draws)
        g = self.grad_accum
        self._check_batch(len(images_u8))
        if len(draws) != g:
            raise ValueError(f"{len(draws)} draw sets for grad_accum={g}")
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        losses: List[Dict[str, torch.Tensor]] = []
        # Microbatches in sequence; BN running statistics chain through them
        # and the gradients add up in .grad.
        for img_u8, msk, d in zip(images_u8.chunk(g), masks.chunk(g), draws):
            img, m = train_transform(img_u8, msk, d.to(device),
                                     **self.aug_cfg.transform_kwargs())
            # Masks may ship as uint8; the geometric step is nearest on masks,
            # so the cast after it is exact.
            m = m.to(torch.float32)
            recon, amap = _forward_anomaly(model, img, self.dual_decoder)
            ld = combined_anomaly_loss(recon, amap, img, m, **self.loss_cfg.kwargs())
            ld["total_loss"].backward()
            losses.append({k: v.detach() for k, v in ld.items()})
        if g > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(g)
        state.optimizer.step()
        state.step += 1
        return {k: torch.stack([ld[k] for ld in losses]).mean() for k in losses[0]}


def make_anomaly_train_step(loss_cfg: AnomalyLossConfig = AnomalyLossConfig(),
                            aug_cfg: AugmentConfig = AugmentConfig(),
                            dual_decoder: bool = True, grad_accum: int = 1,
                            remat: str = "none") -> AnomalyTrainStep:
    """The anomaly train step.

    images_u8: (N, H, W, 3) uint8; masks: (N, H, W, 1) float32 in [0, 1] or
    uint8 {0, 1}. ``dual_decoder=False`` trains a plain UNet as a focal-loss
    segmenter (the recon term is then 0).

    ``grad_accum=G`` runs G microbatches of N/G in sequence, each with its own
    draws and its own batch statistics (the running statistics chain through
    them); the gradient sum is divided by G and one update runs. The losses
    are the mean over microbatches.

    ``remat`` other than 'none' is not ported: recomputing the forward in the
    backward (``torch.utils.checkpoint``) would update the BN running
    statistics twice.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if remat in ("full_res", "full"):
        raise NotImplementedError(f"remat={remat!r} is not ported: a recomputed "
                                  "forward would update the BN running statistics twice")
    if remat != "none":
        raise ValueError(f"remat must be 'none'|'full_res'|'full', got {remat!r}")
    return AnomalyTrainStep(loss_cfg, aug_cfg, dual_decoder, grad_accum)


def make_anomaly_eval_step(loss_cfg: AnomalyLossConfig = AnomalyLossConfig(),
                           dual_decoder: bool = True):
    """``step(state, images_u8, masks, valid=None) -> outputs``.

    The model runs in eval mode (running statistics, no update) on
    ``eval_transform``'s output (K1 on CUDA tensors). ``valid`` (optional
    (N,) bool or float) marks the real rows of a padded batch; the loss
    scalars cover those rows only. The outputs, all NHWC or per image:
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
                                               **loss_cfg.kwargs())
                return {
                    "losses": losses,
                    "score": anomaly_score(recon, img),
                    "error_map": anomaly_error_map(recon, img),
                    "anomaly_map": amap[..., 0],
                    "reconstruction": recon,
                    "image": img,
                }
        finally:
            model.train(was_training)

    return step
