"""What the TransUNet readers share: device time per traced train step
under one of the model's spans (``models/transunet.py``) within
``train.forward``, joined as ``_spans.py`` joins them."""

from __future__ import annotations

from typing import Optional

from port_bench.layer_metrics._spans import joined


def forward_span_ms(ctx, name: str) -> Optional[float]:
    """Device milliseconds per kept ``train.step`` issued under ``name``
    within ``train.forward``; None where no step or no span ``name`` was
    kept, or the trace holds no device work."""
    j = joined(ctx)
    units = j.units_named("train.step") if j is not None else []
    if not units or not ctx.trace.device or all(s.name != name for s in j.spans.values()):
        return None
    ids = {u.id for u in units}
    us = j.device_us(lambda s: s is not None and s.unit in ids and j.under(s, name)
                     and j.under(s, "train.forward"))
    return us / 1e3 / len(units)
