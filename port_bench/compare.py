"""The numbers that decide ``correct``: each run's outputs against the plain
reference's, each number held to its limit (a cell's traffic file holds the
limits; PERF.md gives the readings they were set from).

Training (the first three steps of the run, through the window's own call):
- ``loss_gap``: the largest relative gap of a step's total loss;
- ``grad_gap_median``: for each parameter, the gap between the norms of the
  first step's gradient (as the optimizer took it, weight decay included)
  on the two sides, over the larger of the reference's norm of that leaf
  and of the median leaf; the median of these gaps over the parameters.
  The worst leaf's gap is not compared: it swings from seed to seed with
  bf16's rounding of one leaf whose gradient nearly cancels (the first
  conv's weight under BatchNorm read 0.39 on one seed in 52, and so does
  the reference rounded to bf16 at its convs; PERF.md). The median leaf's
  is steady near bf16's rounding, and a step on part of its batch moves
  every leaf's norm;
- ``change_gap``: the worst leaf's gap (as above) of the change of each
  parameter and BatchNorm running statistic over the three steps. A
  parameter whose reference gradient is under a thousandth of the median
  leaf's (nought but for rounding) moves under Adam by round-off alone and
  is left out.

Serving (a sample, drawn from the seed, of the requests the window served):
- ``score_gap``: the largest relative gap of an anomaly score;
- ``logit_gap``: the widest gap by which the reference's logit of the class
  the program served lies below the reference's best, over every pixel.
  The served mean confidence is not compared: averaged over half a
  million pixels, a lower precision moves it no more than bf16 rounding
  does, so no limit separates the two (PERF.md).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

SMALL_GRAD = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str]
               ) -> Dict[str, float]:
    med = float(np.median([ref[k] for k in names]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def _moved(ref: Dict) -> List[str]:
    med = float(np.median(list(ref["grad"].values())))
    return [k for k in sorted(ref["change"])
            if k not in ref["grad"] or ref["grad"][k] >= SMALL_GRAD * med]


def _train_leaves(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    return {"grad_gap": _leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"])),
            "change_gap": _leaf_gaps(prog["change"], ref["change"], _moved(ref))}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {'loss': [3 floats], 'grad': {param: norm},
    'change': {leaf: norm}}."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    leaves = _train_leaves(prog, ref)
    return {"loss_gap": loss,
            "grad_gap_median": float(np.median(list(leaves["grad_gap"].values()))),
            "change_gap": max(leaves["change_gap"].values())}


def train_detail(prog: Dict, ref: Dict) -> Dict:
    """Where each training number's leaves stand: the worst leaf with its
    gap, and the median leaf's gap (the look at seeds that read high)."""
    out = {}
    for name, values in _train_leaves(prog, ref).items():
        worst = max(values, key=values.get)
        out[name] = {"worst_leaf": worst, "worst": values[worst],
                     "median_leaf": float(np.median(list(values.values())))}
    out["excluded"] = sorted(set(ref["change"]) - set(_moved(ref)))
    return out


def score_numbers(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    return {"score_gap": float(np.max(np.abs(prog - ref) / np.abs(ref)))}


def seg_numbers(prog: List[Tuple[np.ndarray, float]], ref_logits: List[torch.Tensor]
                ) -> Dict[str, float]:
    """``prog``: (mask (H, W) uint8, mean confidence) per sample;
    ``ref_logits``: the reference's (C, H, W) float32 logits of each."""
    logit = 0.0
    for (mask, _), logits in zip(prog, ref_logits):
        served = torch.from_numpy(np.ascontiguousarray(mask)).to(logits.device).long()
        below = logits.amax(0) - logits.gather(0, served[None])[0]
        logit = max(logit, float(below.max()))
    return {"logit_gap": logit}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """Whether every number is within its limit, and each beside its limit."""
    rows = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, rows
