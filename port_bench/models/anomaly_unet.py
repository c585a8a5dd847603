"""AnomalyUNet: a shared encoder, a reconstruction and a segmentation
decoder; trained on images and anomaly masks with MSE + focal loss, served
as an anomaly score per image (the reconstruction's mean squared error)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from port_bench import compare
from port_bench.reference import augment, int8, losses


def heads(config: Dict, score_only: bool = False) -> Tuple[int, ...]:
    """Both decoders' heads; the reconstruction's alone in the score path."""
    c = config.get("n_channels", 3)
    return (c,) if score_only else (c, 1)


# The system under test.

def model_kwargs(config: Dict) -> Dict:
    return {}


def train_step(config: Dict, aug):
    """The port's train step: (state, images, masks, draws, keep) -> the
    total loss on the device."""
    from tpu_unet_torch.train.steps import AnomalyLossConfig, make_anomaly_train_step

    step = make_anomaly_train_step(AnomalyLossConfig(**config["loss"]), aug)

    def call(state, images, targets, draws, keep):
        return step.with_draws(state, images, targets, draws)["total_loss"]

    return call


def serving_engine(config: Dict, weights: Dict[str, torch.Tensor], common: Dict):
    from tpu_unet_torch.serve import AnomalyScorer

    engine = AnomalyScorer.from_state_dict(weights, image_size=config["image_height"],
                                           **common)
    return engine, engine.score_array


# What feeds and judges the reference.

def train_targets(region_map: np.ndarray) -> np.ndarray:
    """The anomaly mask, (N, H, W, 1)."""
    return region_map[..., None]


def keep_mask(config: Dict, n: int, gen: torch.Generator):
    return None


def reference_loss(model, config: Dict, p, imgs, targets, d, keep, lowp):
    x, t = augment.paired_augment(imgs, targets, d, config["augment"])
    outs, stats = model.forward(p, x.permute(0, 3, 1, 2), bn="train", keep=keep, lowp=lowp)
    recon, amap = (o.permute(0, 2, 3, 1) for o in outs)
    return losses.anomaly(recon, amap, x, t, config["loss"]), stats


def reference_answers(head: torch.Tensor, images: torch.Tensor, as_program: bool) -> np.ndarray:
    """Each image's anomaly score from the reconstruction head's output."""
    x = int8.nchw_input(images).double()
    return ((head.double() - x) ** 2).mean(dim=(1, 2, 3)).float().cpu().numpy()


def serve_numbers(prog, truth) -> Dict[str, float]:
    return compare.score_numbers(np.asarray(prog, np.float64), np.asarray(truth, np.float64))
