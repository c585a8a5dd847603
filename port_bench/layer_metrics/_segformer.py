"""What the SegFormer readers of single kernels share: device time per
traced train step of the kernels a name test accepts, issued under
``segformer.encoder`` within ``train.forward``. The train step replays each
block as one CUDA graph (``models/segformer.py``), whose kernels the join
gives to the span open at the graph's launch, the encoder; so the attention
cores and the depthwise convs are told from the rest by their kernels'
names."""

from __future__ import annotations

import re
from typing import Optional

from port_bench.layer_metrics._spans import joined

# The fused attention forward of each of SDPA's backends the core takes:
# flash (``flash_fwd*``), memory-efficient (``fmha_cutlassF*``) and cuDNN's
# (``*sdpa*``).
ATTENTION = re.compile(r"flash|fmha|sdpa", re.IGNORECASE)
# A depthwise conv: cuDNN's kernels of one channel a group (``*_c1_k1_*``)
# or PyTorch's own (``conv_depthwise2d*``).
DWCONV = re.compile(r"c1_k1|depthwise", re.IGNORECASE)


def encoder_kernel_ms(ctx, pattern: re.Pattern) -> Optional[float]:
    """Device milliseconds per kept ``train.step`` of the device events
    whose name ``pattern`` finds, issued under ``segformer.encoder`` within
    ``train.forward``; None where no step or no encoder span was kept, or no
    such event ran."""
    j = joined(ctx)
    units = j.units_named("train.step") if j is not None else []
    if not units or all(s.name != "segformer.encoder" for s in j.spans.values()):
        return None
    ids = {u.id for u in units}
    us = sum(float(e["dur"]) for e, s in j.issued
             if s is not None and s.unit in ids and pattern.search(e.get("name", ""))
             and j.under(s, "segformer.encoder") and j.under(s, "train.forward"))
    return us / 1e3 / len(units) if us else None
