"""The attention core the port's transformers share (``models/transunet.py``,
``models/segformer.py``): ``softmax(q k^T / sqrt(d)) v`` per head.

Queries are (N, heads, T, d) and keys and values (N, heads, M, d), with M
equal to T (TransUNet) or shorter (SegFormer's keys come from a reduced
copy of the queries' map). The core is ``F.scaled_dot_product_attention``;
on CUDA it may take only the fused backends (flash first, then cuDNN and
memory-efficient) and raises where none applies, instead of holding every
head's (T, M) scores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over (N, heads, T, d) queries and (N,
    heads, M, d) keys and values; (N, heads, T, d). On CUDA only the fused
    backends may run it (flash first); none applying raises."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
             SDPBackend.EFFICIENT_ATTENTION]
    with sdpa_kernel(fused, set_priority=True):
        return F.scaled_dot_product_attention(q, k, v)
