"""SegmentationUNet: one decoder, a class per pixel, bottleneck dropout
under a keep mask; trained on images and label maps with class-weighted CE
+ Dice, served as each pixel's class and the mean confidence."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench import compare, inputs
from port_bench.reference import augment, losses


def heads(config: Dict, score_only: bool = False) -> Tuple[int, ...]:
    return (config["n_classes"],)


# The system under test.

def model_kwargs(config: Dict) -> Dict:
    return {"n_classes": config["n_classes"], "dropout": config.get("dropout", 0.0)}


def train_step(config: Dict, aug):
    """The port's train step: (state, images, label maps, draws, keep) ->
    the total loss on the device."""
    from tpu_unet_torch.train.steps import SegLossConfig, make_seg_train_step

    loss = dict(config["loss"])
    if loss.get("class_weights") is not None:
        loss["class_weights"] = tuple(loss["class_weights"])
    step = make_seg_train_step(config["n_classes"], SegLossConfig(**loss), aug)

    def call(state, images, targets, draws, keep):
        out, _ = step.with_draws(state, images, targets, draws, dropout=keep)
        return out["total_loss"]

    return call


def serving_engine(config: Dict, weights: Dict[str, torch.Tensor], common: Dict):
    from tpu_unet_torch.serve import SegmentationPredictor

    engine = SegmentationPredictor.from_state_dict(
        weights, num_classes=config["n_classes"],
        image_size_hw=(config["image_height"], config["image_width"]),
        dropout=config.get("dropout", 0.0), fold_bn=True, **common)
    return engine, engine.predict_array


# What feeds and judges the reference.

def train_targets(region_map: np.ndarray) -> np.ndarray:
    """The label map, (N, H, W)."""
    return region_map


def keep_mask(config: Dict, n: int, gen: torch.Generator):
    """The bottleneck dropout's keep mask, drawn by the harness."""
    if config.get("dropout", 0.0) <= 0:
        return None
    return inputs.dropout_keep(n, config["base_features"] * 16, config["dropout"], gen)


def reference_loss(model, config: Dict, p, imgs, targets, d, keep, lowp):
    x, t = augment.paired_augment(imgs, targets[..., None], d, config["augment"])
    outs, stats = model.forward(p, x.permute(0, 3, 1, 2), bn="train", keep=keep, lowp=lowp)
    return losses.segmentation(outs[0].permute(0, 2, 3, 1), t[..., 0].long(),
                               config["loss"]), stats


def reference_answers(head: torch.Tensor, images: torch.Tensor, as_program: bool) -> List:
    """The reference's (C, H, W) logits of each image; in the program's
    place (the control), each pixel's class as the program serves it."""
    if not as_program:
        return list(head.unbind(0))
    return [(argmax_first(t).cpu().numpy().astype(np.uint8), None) for t in head.unbind(0)]


def serve_numbers(prog, truth) -> Dict[str, float]:
    return compare.seg_numbers(prog, truth)


def argmax_first(logits: torch.Tensor) -> torch.Tensor:
    """The class of each pixel of (C, H, W) logits, the first on ties."""
    best, cls = logits[0], torch.zeros(logits.shape[1:], dtype=torch.int64, device=logits.device)
    for c in range(1, logits.shape[0]):
        take = logits[c] > best
        cls = torch.where(take, c, cls)
        best = torch.where(take, logits[c], best)
    return cls
