"""One module per model family, found by a configuration's ``family``:
``port_bench/models/<family>.py``. It holds what the harness does
differently for that family, so that a new family is a new file:

- ``heads(config, score_only)``: the head widths its forward runs (the
  frozen FLOP formulas read them);
- the system under test, built from the port's public entry points (the
  port imported inside each function): ``model_kwargs(config)``,
  ``train_step(config, augment)`` and ``serving_engine(config, weights,
  common)``;
- what feeds and judges the reference: ``train_targets``, ``keep_mask``,
  ``reference_loss``, ``reference_answers`` and ``serve_numbers``.
"""

import importlib


def load(name: str):
    """The family module ``name`` of this package."""
    return importlib.import_module(f"{__name__}.{name}")
