"""The system under test, built from the port's (``tpu_unet_torch``) public
entry points: the benchmark hands it weights and inputs it made itself and
times it from outside. Only this module and the family modules under
``port_bench/models/`` import the port, and those only inside the functions
that build it.

- :class:`TrainProgram`: ``create_train_state`` over ``build_model`` with
  the benchmark's weights, and the family's train step called with the
  benchmark's draws;
- :func:`serving_engine`: the family's serving engine built from a
  state_dict, whose ``serve(batch_u8)`` answers one host uint8 batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from port_bench import models


def _model(config: Dict, precision: str):
    from tpu_unet_torch.core.precision import get_policy
    from tpu_unet_torch.models import build_model

    with torch.device("meta"):
        return build_model(config["model"], n_channels=config.get("n_channels", 3),
                           base_features=config["base_features"],
                           policy=get_policy(precision),
                           **models.load(config["family"]).model_kwargs(config))


class TrainProgram:
    """The port's train state and step for a configuration, from the
    benchmark's weights (copied: the step updates its own)."""

    def __init__(self, config: Dict, weights: Dict[str, torch.Tensor], device):
        from tpu_unet_torch.train.state import create_train_state
        from tpu_unet_torch.train.steps import AugmentConfig

        model = _model(config, config["precision"])
        model.load_state_dict({k: v.clone() for k, v in weights.items()}, assign=True)
        opt = config["optimizer"]
        self.state = create_train_state(model, opt["name"], opt["lr"], opt["weight_decay"],
                                        device=device)
        self.step = models.load(config["family"]).train_step(
            config, AugmentConfig(**config["augment"]))

    def __call__(self, images: torch.Tensor, targets: torch.Tensor, draws: Dict,
                 keep: Optional[torch.Tensor]) -> torch.Tensor:
        """One optimizer update; returns the total loss (on the device)."""
        from tpu_unet_torch.ops.augment import AugmentDraws

        return self.step(self.state, images, targets, AugmentDraws(**draws), keep)

    def first_gradients(self) -> Dict[str, torch.Tensor]:
        """Each parameter's gradient as the optimizer took it in its first
        step, read back from Adam's first moment: m_1 = (1 - beta1) g_1
        (zero where the optimizer holds no moment: it took none)."""
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        return {name: opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                for name, p in self.state.model.named_parameters()}

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The parameters and BatchNorm running statistics by name."""
        m = self.state.model
        return {**dict(m.named_parameters()),
                **{k: v for k, v in m.named_buffers() if not k.endswith("num_batches_tracked")}}


def serving_engine(config: Dict, traffic: Dict, weights: Dict[str, torch.Tensor], device,
                   calib_images: Optional[np.ndarray] = None):
    """The port's serving engine for the configuration, built as a user
    builds one from a state_dict, and its ``serve(batch_u8)``, which
    answers one request."""
    common = dict(batch_size=traffic["batch"], precision=traffic["precision"],
                  quantize=traffic.get("quantize"), calib_images=calib_images,
                  base_features=config["base_features"], device=device)
    return models.load(config["family"]).serving_engine(config, weights, common)
