"""Adam with L2 weight decay (Kingma and Ba, arXiv:1412.6980): the decay is
added to the gradient before the moments, as torch's ``Adam(weight_decay=)``
and optax's add_decayed_weights -> scale_by_adam do."""

from __future__ import annotations

from typing import Dict

import torch


class Adam:
    def __init__(self, lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def effective_grad(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The gradient as the moments take it: g + wd * p."""
        return g + self.wd * p

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for name, p in params.items():
            g = self.effective_grad(p, grads[name])
            m = self.m[name] = self.b1 * self.m.get(name, torch.zeros_like(p)) + (1 - self.b1) * g
            v = self.v[name] = (self.b2 * self.v.get(name, torch.zeros_like(p))
                                + (1 - self.b2) * g * g)
            p -= self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
