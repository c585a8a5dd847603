"""Training state (counterpart of ``tpu_unet/train/state.py``): the model
(parameters and BatchNorm statistics), its optimizer and the step count.
The train step updates it in place."""

from __future__ import annotations

import dataclasses

import torch

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.train.optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model: torch.nn.Module, optimizer_name: str = "adam",
                       learning_rate: float = 1e-3, weight_decay: float = 1e-4,
                       device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (channels_last on CUDA), put it in train
    mode and build its optimizer. ``device`` defaults to ``cuda`` and raises
    when there is no GPU."""
    device = resolve_device(device)
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model = model.to(device, memory_format=fmt).train()
    return TrainState(model, make_optimizer(model.parameters(), optimizer_name,
                                            learning_rate, weight_decay))


def num_params(state_or_model) -> int:
    model = getattr(state_or_model, "model", state_or_model)
    return sum(p.numel() for p in model.parameters())
