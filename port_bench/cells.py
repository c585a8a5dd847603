"""The general generator. A traffic file's ``kind`` names the module that
reads its parameters, ``port_bench/kinds/<kind>.py`` (its class ``Cell``),
and a configuration's ``family`` names the module of its model family,
``port_bench/models/<family>.py``; both are found by name, so a new kind
of traffic or a new family is a new file.

A cell makes its weights and inputs from the seed, builds the program and
warms it up (``start_program``, set-up), runs the traffic for a window
(``run``), releases the program (``stop_program``) and has the reference
recompute what the check compares (``check``, ``compare.py``), in float32
with TF32 off, or in the configuration's integer scheme.
"""

from __future__ import annotations

import gc
import importlib
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from port_bench import inputs, models, reference


@dataclass
class Record:
    """What one window did: its work and its length on the host's clock."""
    seconds: float
    images: int
    steps: int = 0
    requests: int = 0
    failed: int = 0
    latencies_ms: List[float] = field(default_factory=list)


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def kind(name: str):
    """The traffic kind's module, ``port_bench/kinds/<name>.py``."""
    return importlib.import_module(f"port_bench.kinds.{name}")


def make(config: Dict, traffic: Dict, seed: int, device):
    return kind(traffic["kind"]).Cell(config, traffic, seed, device)


class Base:
    """What every kind of cell starts from: the reference model, the
    family's module and the weights from the seed."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.model = reference.load(config["reference"]).build(config)
        self.family = models.load(config["family"])
        self.weights = inputs.weights(self.model.specs(), seed, self.device)
        self.h, self.w = config["image_height"], config["image_width"]
