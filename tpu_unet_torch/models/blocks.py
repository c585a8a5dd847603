"""UNet building blocks as PyTorch modules (counterpart of
``tpu_unet/models/blocks.py``).

Module and parameter names follow the reference state_dict
(``double_conv.{0,1,3,4}``, ``maxpool_conv.1``, ``up``/``conv``, ``conv``; a
bilinear ``Up`` has no ``up``), so a reference-layout checkpoint loads with
``strict=True``; an attention-gated ``Up``'s gate is ``att``
(``models/attention.py``). Tensors are NCHW (channels_last in memory on the
GPU), PyTorch's habit.

Precision follows the policy, as in the JAX blocks: convolutions run in the
compute dtype with float32 parameters cast at use; the BN affine (or, once
``ops/fold_bn.py`` has folded it, the conv bias) and ReLU run in float32, and
the result is cast back to the compute dtype. The transposed conv and the
1x1 head add their bias in the compute dtype; heads return float32. The
bilinear upsample runs in the compute dtype, as matmuls
(``ops/resize.py``).

BatchNorm follows flax's, as the JAX blocks configure it: eps 1e-5; in train
mode it normalizes by the batch's biased variance and moves the running
statistics by 0.1 (torch's convention; flax ``momentum=0.9``) towards the
batch mean and the *biased* batch variance, where ``nn.BatchNorm2d`` would
take the unbiased one. Eval mode is ``nn.BatchNorm2d``'s own forward.

Rematerialization (the train steps' ``remat``): ``DoubleConv``, ``Down`` and
``Up`` take a ``remat_tag``; under :func:`remat_scope` of that tag a block
runs under :func:`checkpoint`, which keeps only its inputs and recomputes the
rest in the backward. The recomputation runs in :func:`recomputing` mode, in
which a train-mode BatchNorm normalizes by the batch statistics as before and
leaves its running statistics alone, so they move once per step, as flax's
functional ``batch_stats`` do under ``jax.checkpoint``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.ops.resize import upsample2x_bilinear_align_corners


_STATE = threading.local()  # per thread: the remat scope's tag, recomputing


def recomputing() -> bool:
    """Whether this thread is recomputing a checkpointed forward."""
    return getattr(_STATE, "recomputing", False)


@contextlib.contextmanager
def _recompute_mode():
    before = recomputing()
    _STATE.recomputing = True
    try:
        yield
    finally:
        _STATE.recomputing = before


def checkpoint(fn, *args):
    """``fn(*args)``, keeping ``args`` and recomputing the rest in the
    backward (``torch.utils.checkpoint``, non-reentrant) in
    :func:`recomputing` mode."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute_mode()))


@contextlib.contextmanager
def remat_scope(tag: Optional[str]):
    """Blocks built with ``remat_tag == tag`` run under :func:`checkpoint`
    inside this scope (in this thread)."""
    before = getattr(_STATE, "tag", None)
    _STATE.tag = tag
    try:
        yield
    finally:
        _STATE.tag = before


def _remat(tag: Optional[str]) -> bool:
    return tag is not None and getattr(_STATE, "tag", None) == tag


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates ``running_var`` with the
    biased batch variance, as flax does, and not at all while
    :func:`recomputing`. Statistics are float32 (the policy's
    ``norm_dtype``); parameter and buffer names are unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if recomputing():
            return out
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                 else self.momentum)
            # The kernel saved 1 / sqrt(var + eps); var is recovered from it.
            var = invstd.double().pow(-2).sub(self.eps).clamp(min=0).float()
            self.running_mean.mul_(1.0 - f).add_(mean, alpha=f)
            self.running_var.mul_(1.0 - f).add_(var, alpha=f)
        return out


def conv_bn(conv: nn.Conv2d, norm: nn.Module, x: torch.Tensor, policy: Policy,
            padding: int = 0, stride: int = 1) -> torch.Tensor:
    """A bias-free conv in the compute dtype, then its BatchNorm in float32
    (after ``ops/fold_bn.py``, the conv's float32 bias and an identity).
    ``stride`` 2 (a 1x1 conv) samples the even rows and columns first: the
    same sums as a stride-2 conv, whose backward on a channels_last CPU
    tensor corrupts memory in PyTorch's CPU build."""
    cd = policy.compute_dtype
    if stride > 1:
        x = x[:, :, ::stride, ::stride]
    y = F.conv2d(x.to(cd), conv.weight.to(cd), padding=padding).to(policy.norm_dtype)
    if conv.bias is not None:  # BN folded into the conv (ops/fold_bn.py)
        y = y + conv.bias.view(-1, 1, 1)
    return norm(y)


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU) twice, optionally with a narrower mid width."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None,
                 policy: Policy = DEFAULT_POLICY, remat_tag: Optional[str] = None):
        super().__init__()
        mid = mid_channels if mid_channels is not None else out_channels
        self.policy = policy
        self.remat_tag = remat_tag
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1, bias=False),
            BatchNorm2d(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _remat(self.remat_tag):
            return checkpoint(self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in (0, 3):
            y = conv_bn(self.double_conv[i], self.double_conv[i + 1], x, self.policy, padding=1)
            x = F.relu(y).to(self.policy.compute_dtype)
        return x


class Down(nn.Module):
    """2x2 max-pool (stride 2) followed by DoubleConv (which takes the
    ``remat_tag``: the pooled input is kept)."""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY, remat_tag: Optional[str] = None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2),
            DoubleConv(in_channels, out_channels, policy=policy, remat_tag=remat_tag))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Upsample x1 2x, pad it to the skip's extent, concat(skip, x1), DoubleConv.

    ``in_channels`` is the concat's width. The transposed conv (``up``) maps
    x1's ``in_channels`` to half; the bilinear upsample (``bilinear=True``,
    align corners, no parameters) keeps x1's ``in_channels // 2`` and the
    DoubleConv narrows to ``in_channels // 2`` in the middle, as the
    reference's does. ``attention=True`` gates the skip through an
    :class:`~tpu_unet_torch.models.attention.AttentionGate` (``att``) before
    the upsample; the gating signal is the coarse x1. Under its
    ``remat_tag`` the whole block (upsample, pad, concat and DoubleConv) is
    checkpointed; x1 and the skip are kept.
    """

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool = False,
                 policy: Policy = DEFAULT_POLICY, attention: bool = False,
                 remat_tag: Optional[str] = None):
        super().__init__()
        self.policy = policy
        self.remat_tag = remat_tag
        skip = in_channels // 2
        if attention:
            from tpu_unet_torch.models.attention import AttentionGate
            self.att = AttentionGate(in_channels // 2 if bilinear else in_channels, skip,
                                     f_int=max(1, skip // 2), policy=policy)
        if bilinear:
            self.conv = DoubleConv(in_channels, out_channels, in_channels // 2, policy=policy)
        else:
            self.up = nn.ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
            self.conv = DoubleConv(in_channels, out_channels, policy=policy)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if _remat(self.remat_tag):
            return checkpoint(self._forward, x1, x2)
        return self._forward(x1, x2)

    def _forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        if hasattr(self, "att"):
            x2 = self.att(x1, x2)
        if hasattr(self, "up"):
            x1 = F.conv_transpose2d(x1.to(cd), self.up.weight.to(cd),
                                    self.up.bias.to(cd), stride=2)
        else:
            x1 = upsample2x_bilinear_align_corners(x1.to(cd))
        # Static pad to the skip's extent (zero for power-of-two sizes).
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2.to(x1.dtype), x1], dim=1))


class OutConv(nn.Module):
    """1x1 convolution head; output cast to the policy's output dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 policy: Policy = DEFAULT_POLICY):
        super().__init__()
        self.policy = policy
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        y = F.conv2d(x.to(cd), self.conv.weight.to(cd), self.conv.bias.to(cd))
        return self.policy.cast_to_output(y)
