"""SegFormer (MiT encoder, all-MLP head): a class per pixel, trained as
SegmentationUNet is, on images and label maps with class-weighted CE + Dice,
through the port's seg train step. Its dropout is, a step, the two (N,)
stochastic-depth masks of each block of nonzero rate and the head's (N, E)
Dropout2d mask, which the harness draws in one packed uniform tensor
(:func:`keep_mask`) and splits (:func:`masks`) for the program and the
reference alike. It is not served: the serving functions raise."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from port_bench.reference import augment, losses
from port_bench.reference.segformer import drop_path_rates


def heads(config: Dict, score_only: bool = False) -> Tuple[int, ...]:
    return (config["n_classes"],)


# The system under test.

def model_kwargs(config: Dict) -> Dict:
    """``build_model('segformer', ...)``'s keywords beside ``n_channels``,
    ``base_features`` (which SegFormer ignores) and ``policy``."""
    return {"n_classes": config["n_classes"], "dropout": config.get("dropout", 0.0),
            "embed_dims": tuple(config["embed_dims"]), "num_heads": tuple(config["num_heads"]),
            "mlp_ratios": tuple(config["mlp_ratios"]), "depths": tuple(config["depths"]),
            "sr_ratios": tuple(config["sr_ratios"]),
            "drop_path_rate": config["drop_path_rate"],
            "embedding_dim": config["embedding_dim"]}


def train_step(config: Dict, aug):
    """The port's seg train step: (state, images, label maps, draws, packed
    keep draw) -> the total loss on the device."""
    from tpu_unet_torch.train.steps import SegLossConfig, make_seg_train_step

    loss = dict(config["loss"])
    if loss.get("class_weights") is not None:
        loss["class_weights"] = tuple(loss["class_weights"])
    step = make_seg_train_step(config["n_classes"], SegLossConfig(**loss), aug)

    def call(state, images, targets, draws, keep):
        out, _ = step.with_draws(state, images, targets, draws, dropout=masks(config, keep))
        return out["total_loss"]

    return call


def serving_engine(config: Dict, weights: Dict[str, torch.Tensor], common: Dict):
    raise ValueError("SegFormer has no serving cell: the port serves it with no engine")


# What feeds and judges the reference.

def train_targets(region_map: np.ndarray) -> np.ndarray:
    """The label map, (N, H, W)."""
    return region_map


def _rates(config: Dict) -> list:
    """Each column's rate in the packed draw: two columns of each block of
    nonzero stochastic-depth rate at that rate, then the head's E at the
    dropout rate."""
    rate = config.get("dropout", 0.0)
    return [r for r in drop_path_rates(config) if r > 0 for _ in range(2)] + \
        [rate] * (config["embedding_dim"] if rate > 0 else 0)


def keep_mask(config: Dict, n: int, gen: torch.Generator):
    """Every keep draw of a step in one packed (n, 2 B + E) float32 uniform
    tensor (B blocks of nonzero rate, head embedding E); slicing it by rows
    slices every mask. :func:`masks` thresholds and splits it."""
    cols = len(_rates(config))
    if not cols:
        return None
    return torch.rand((n, cols), generator=gen, device=gen.device)


_THRESHOLDS: Dict[Tuple, torch.Tensor] = {}


def _thresholds(rates: list, device) -> torch.Tensor:
    """The rates as a float32 tensor on ``device``, made once: a copy from
    the host in the timed window would wait for the device to drain."""
    key = (tuple(rates), torch.device(device))
    if key not in _THRESHOLDS:
        _THRESHOLDS[key] = torch.tensor(rates, dtype=torch.float32, device=device)
    return _THRESHOLDS[key]


def masks(config: Dict, packed):
    """The packed draw as the model's keep masks, in its order: a column
    keeps where the draw is at or above its rate; the two (n,) masks of
    each block of nonzero rate, then the head's (n, E). None without a
    draw."""
    if packed is None:
        return None
    rates = _rates(config)
    keep = packed >= _thresholds(rates, packed.device)
    e = config["embedding_dim"] if config.get("dropout", 0.0) > 0 else 0
    out = [keep[:, c] for c in range(len(rates) - e)]
    if e:
        out.append(keep[:, len(rates) - e:])
    return tuple(out)


def reference_loss(model, config: Dict, p, imgs, targets, d, keep, lowp):
    x, t = augment.paired_augment(imgs, targets[..., None], d, config["augment"])
    outs, stats = model.forward(p, x.permute(0, 3, 1, 2), bn="train", keep=masks(config, keep),
                                lowp=lowp)
    return losses.segmentation(outs[0].permute(0, 2, 3, 1), t[..., 0].long(),
                               config["loss"]), stats


def reference_answers(head: torch.Tensor, images: torch.Tensor, as_program: bool):
    raise ValueError("SegFormer has no serving cell")


def serve_numbers(prog, truth) -> Dict[str, float]:
    raise ValueError("SegFormer has no serving cell")
