"""Precision policy (counterpart of ``tpu_unet/core/precision.py``).

Parameters and normalization stay float32; convolutions run in the compute
dtype (bfloat16 under the ``bf16`` policy); model outputs are float32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtypes threaded through the model.

    Attributes:
      param_dtype:   dtype parameters are stored in (always float32).
      compute_dtype: dtype convolutions run in.
      norm_dtype:    dtype the BN affine, the folded bias and ReLU run in.
      output_dtype:  dtype model outputs are cast to.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    norm_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_to_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)


def get_policy(name: str) -> Policy:
    """Resolve a policy by CLI name ('f32' | 'bf16')."""
    name = name.lower()
    if name in ("f32", "float32", "fp32"):
        return DEFAULT_POLICY
    if name in ("bf16", "bfloat16", "mixed"):
        return BF16_POLICY
    raise ValueError(f"Unknown precision policy: {name!r} (expected 'f32' or 'bf16')")
