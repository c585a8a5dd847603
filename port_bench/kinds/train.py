"""``train``: closed-loop training. Set-up makes the weights and a pool of
``pool_batches`` device-resident batches from the seed, builds the
program's train state from the weights, and runs its first three steps
through the window's own call, each on its own batch, recording what the
check compares; then ``warmup_steps`` more. The window runs steps back to
back, each drawing its augment (and dropout) from the harness's seeded
generator, the losses kept on the device and fetched at its end.

Parameters: ``batch``, ``pool_batches``, ``target_probs`` and
``target_cell`` (the masks' or label maps' regions), ``warmup_steps``,
``trace_seconds``, ``limits``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from port_bench import cells, compare, inputs, reference
from port_bench.reference.adam import Adam
from port_bench.reference.lowp import fp8

CHECKED_STEPS = 3
PARAM_ROLES = ("conv", "bn_weight", "bn_bias", "up_weight", "head_weight", "bias")
STAT_ROLES = ("running_mean", "running_var")


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.linalg.vector_norm(t.detach().double()) for k, t in tensors.items()}


def _floats(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([tensors[k] for k in names]).cpu().tolist() if names else []
    return dict(zip(names, values))


class Cell(cells.Base):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        n, pool = traffic["batch"], traffic["pool_batches"]
        imgs = inputs.images(inputs.host_rng(seed, inputs.STREAM_IMAGES), n * pool, self.h, self.w)
        targets = self.family.train_targets(inputs.region_map(
            inputs.host_rng(seed, inputs.STREAM_TARGETS), n * pool, self.h, self.w,
            traffic["target_probs"], traffic["target_cell"]))
        self.pool = [(torch.from_numpy(imgs[i * n:(i + 1) * n]).to(self.device),
                      torch.from_numpy(targets[i * n:(i + 1) * n]).to(self.device))
                     for i in range(pool)]
        self.gen = inputs.device_generator(seed, inputs.STREAM_DRAWS, self.device)
        self.first = [self._draw() for _ in range(CHECKED_STEPS)]
        self.next = 0

    def _draw(self) -> Tuple[Dict, Optional[torch.Tensor]]:
        n = self.traffic["batch"]
        d = inputs.augment_draws(n, self.config["augment"], self.gen)
        return d, self.family.keep_mask(self.config, n, self.gen)

    def _step(self, draws) -> torch.Tensor:
        imgs, targets = self.pool[self.next % len(self.pool)]
        self.next += 1
        return self.program(imgs, targets, *draws)

    def start_program(self) -> None:
        """Build the program's state and run its first steps (set-up)."""
        from port_bench.program import TrainProgram

        self.program = TrainProgram(self.config, self.weights, self.device)
        self.loss = []
        for i, draws in enumerate(self.first):
            self.loss.append(self._step(draws))
            if i == 0:
                self.grad = _norms(self.program.first_gradients())
        self.change = _norms({k: t - self.weights[k] for k, t in self.program.tensors().items()})
        for _ in range(self.traffic["warmup_steps"]):
            self._step(self._draw())
        torch.stack(self.loss).cpu()

    def run(self, seconds: float) -> cells.Record:
        out = []
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            out.append(self._step(self._draw()))
            if time.perf_counter() >= end:
                break
        values = torch.stack(out).cpu()
        dt = time.perf_counter() - t0
        return cells.Record(seconds=dt, images=len(out) * self.traffic["batch"], steps=len(out),
                            failed=int((~torch.isfinite(values)).sum()))

    def stop_program(self) -> None:
        self.program = None
        cells.release(self.device)

    def program_outputs(self) -> Dict:
        return {"loss": torch.stack(self.loss).cpu().tolist(), "grad": _floats(self.grad),
                "change": _floats(self.change)}

    def reference_outputs(self, variant: str = "f32") -> Dict:
        """The reference's first three steps from the same weights, batches
        and draws: 'f32'; 'fp8' (the control: every conv's operands, output
        and gradients rounded to float8); the faults 'half' (each step on the
        first half of its batch) and 'frozen' (each step leaves the state,
        the optimizer's included, unchanged)."""
        specs = self.model.specs()
        p = {k: v.clone() for k, v in self.weights.items()}
        names = [k for k, _, role in specs if role in PARAM_ROLES]
        for k in names:
            p[k].requires_grad_(True)
        opt = Adam(self.config["optimizer"]["lr"], self.config["optimizer"]["weight_decay"])
        out = {"loss": [], "grad": {}}
        lowp = fp8 if variant == "fp8" else (lambda t: t)
        with reference.exact_float32():
            for i, (d, keep) in enumerate(self.first):
                imgs, targets = self.pool[i]
                if variant == "half":
                    m = len(imgs) // 2
                    imgs, targets = imgs[:m], targets[:m]
                    d = {k: (v if v.dim() == 0 else v[:m]) for k, v in d.items()}
                    keep = None if keep is None else keep[:m]
                loss, stats = self.family.reference_loss(self.model, self.config, p, imgs,
                                                         targets, d, keep, lowp)
                grads = dict(zip(names, torch.autograd.grad(loss, [p[k] for k in names])))
                if i == 0:
                    first = {k: opt.effective_grad(p[k].detach(), g) for k, g in grads.items()}
                    if variant == "frozen":  # the state's first moment stays 0
                        first = {k: torch.zeros_like(g) for k, g in first.items()}
                    out["grad"] = _floats(_norms(first))
                if variant != "frozen":
                    opt.step({k: p[k] for k in names}, grads)
                    with torch.no_grad():
                        for k, v in stats.items():
                            p[k].copy_(v)
                out["loss"].append(loss.item())
                del loss, grads, stats
        leaves = [k for k, _, role in specs if role in PARAM_ROLES + STAT_ROLES]
        out["change"] = _floats(_norms({k: p[k].detach() - self.weights[k] for k in leaves}))
        return out

    def numbers(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        return compare.train_numbers(prog, ref)

    def check(self) -> Dict[str, float]:
        return self.numbers(self.program_outputs(), self.reference_outputs("f32"))
