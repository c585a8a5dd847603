"""TransUNet (R50-ViT-B/16): a hybrid ResNet and ViT encoder, a bilinear
decoder with skips, a class per pixel; trained as SegmentationUNet is, on
images and label maps with class-weighted CE + Dice, through the port's seg
train step. Its dropout is 25 keep masks a step (the embedding's, and two
in each of the 12 blocks), which the harness draws in one packed tensor
(:func:`keep_mask`) and splits (:func:`masks`) for the program and the
reference alike. It is not served: the serving functions raise."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from port_bench.reference import augment, losses


def heads(config: Dict, score_only: bool = False) -> Tuple[int, ...]:
    return (config["n_classes"],)


# The system under test.

def model_kwargs(config: Dict) -> Dict:
    """``build_model('transunet', ...)``'s keywords beside ``n_channels``,
    ``base_features`` (the ResNet's width) and ``policy``."""
    return {"n_classes": config["n_classes"], "dropout": config.get("dropout", 0.0),
            "image_size_hw": (config["image_height"], config["image_width"]),
            "resnet_units": tuple(config["resnet_units"]),
            "hidden_size": config["hidden_size"], "num_layers": config["num_layers"],
            "num_heads": config["num_heads"], "mlp_dim": config["mlp_dim"],
            "decoder_channels": tuple(config["decoder_channels"])}


def train_step(config: Dict, aug):
    """The port's seg train step: (state, images, label maps, draws, packed
    keep masks) -> the total loss on the device."""
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
    raise ValueError("TransUNet has no serving cell: the port serves it with no engine")


# What feeds and judges the reference.

def train_targets(region_map: np.ndarray) -> np.ndarray:
    """The label map, (N, H, W)."""
    return region_map


def keep_mask(config: Dict, n: int, gen: torch.Generator):
    """Every keep mask of a step in one packed (n, T, D + L (M + D)) bool
    tensor (T tokens, hidden D, L blocks, MLP width M): one uint8 draw an
    element, uniform over 0..99, kept at or above 100 x rate. Slicing it
    by rows slices every mask; :func:`masks` splits it."""
    rate = config.get("dropout", 0.0)
    if rate <= 0:
        return None
    q = round(100 * rate)
    if abs(q - 100 * rate) > 1e-9:
        raise ValueError(f"the packed draw takes dropout rates in steps of 0.01, got {rate}")
    d, m, layers = config["hidden_size"], config["mlp_dim"], config["num_layers"]
    t = (config["image_height"] // 16) * (config["image_width"] // 16)
    u = torch.randint(0, 100, (n, t, d + layers * (m + d)), dtype=torch.uint8, generator=gen,
                      device=gen.device)
    return u.ge_(q).view(torch.bool)


def masks(config: Dict, packed):
    """The packed draw split into the model's masks, in its order: the
    embedding's (n, T, D), then fc1's (n, T, M) and fc2's (n, T, D) of each
    block; None without dropout."""
    if packed is None:
        return None
    d, m = config["hidden_size"], config["mlp_dim"]
    out = [packed[..., :d]]
    for i in range(config["num_layers"]):
        a = d + i * (m + d)
        out += [packed[..., a:a + m], packed[..., a + m:a + m + d]]
    return tuple(out)


def reference_loss(model, config: Dict, p, imgs, targets, d, keep, lowp):
    x, t = augment.paired_augment(imgs, targets[..., None], d, config["augment"])
    outs, stats = model.forward(p, x.permute(0, 3, 1, 2), bn="train", keep=masks(config, keep),
                                lowp=lowp)
    return losses.segmentation(outs[0].permute(0, 2, 3, 1), t[..., 0].long(),
                               config["loss"]), stats


def reference_answers(head: torch.Tensor, images: torch.Tensor, as_program: bool):
    raise ValueError("TransUNet has no serving cell")


def serve_numbers(prog, truth) -> Dict[str, float]:
    raise ValueError("TransUNet has no serving cell")
