"""Optimizers and learning-rate schedules (counterpart of
``tpu_unet/train/optim.py``), as torch optimizers with the JAX package's
semantics:

- ``adam``: ``torch.optim.Adam(weight_decay=wd)``, L2 added to the gradient
  before the moments (optax: add_decayed_weights -> scale_by_adam), eps 1e-8;
- ``adamw``: ``torch.optim.AdamW``, decoupled decay (optax: scale_by_adam ->
  add_decayed_weights -> scale(-lr), the same update);
- ``sgd``: momentum 0.9, no dampening, no Nesterov, L2 ``wd``.

Weight decay applies to every parameter (conv kernels, biases, BN scale and
bias), as over the flax tree. On CUDA the Adam variants run PyTorch's fused
implementation.

``LRScheduler`` is the host-side per-epoch rule (cosine, step, plateau with
torch's 1e-4 relative threshold, none); :func:`set_learning_rate` writes its
value into the optimizer's param groups.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adam",
                   learning_rate: float = 1e-3,
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params``."""
    params = list(params)
    name = name.lower()
    fused = {"fused": True} if params and params[0].is_cuda else {}
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, **fused)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, **fused)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=0.9, dampening=0.0,
                               nesterov=False, weight_decay=weight_decay)
    raise ValueError(f"Unknown optimizer: {name!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class LRScheduler:
    """Host-side per-epoch learning-rate schedule with torch's rules:
    cosine (T_max = epochs, eta_min), step (step_size = epochs // 3, gamma
    0.1), plateau (mode min, patience, factor) or none."""

    def __init__(self, name: str = "cosine", base_lr: float = 1e-3,
                 num_epochs: int = 100, eta_min: float = 1e-6,
                 plateau_patience: int = 10, plateau_factor: float = 0.5):
        self.name = (name or "none").lower()
        self.base_lr = base_lr
        self.num_epochs = num_epochs
        self.eta_min = eta_min
        self.plateau_patience = plateau_patience
        self.plateau_factor = plateau_factor
        self._lr = base_lr  # plateau state
        self._best: Optional[float] = None
        self._bad_epochs = 0

    def lr_for_epoch(self, epoch: int) -> float:
        """The learning rate during ``epoch`` (cosine, step, none); plateau
        returns its current value, moved by :meth:`step_plateau`."""
        if self.name == "cosine":
            return self.eta_min + (self.base_lr - self.eta_min) * 0.5 * (
                1 + np.cos(np.pi * epoch / self.num_epochs))
        if self.name == "step":
            step_size = max(self.num_epochs // 3, 1)
            return self.base_lr * (0.1 ** (epoch // step_size))
        if self.name == "plateau":
            return self._lr
        return self.base_lr  # 'none'

    def step_plateau(self, val_loss: float) -> float:
        """ReduceLROnPlateau(mode=min) after a validation; returns the new rate.

        An epoch improves only if ``loss < best * (1 - 1e-4)`` (torch's
        default relative threshold); after more than ``plateau_patience`` bad
        epochs the rate is multiplied by ``plateau_factor``.
        """
        if self._best is None or val_loss < self._best * (1.0 - 1e-4):
            self._best = val_loss
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.plateau_patience:
                self._lr *= self.plateau_factor
                self._bad_epochs = 0
        return self._lr
