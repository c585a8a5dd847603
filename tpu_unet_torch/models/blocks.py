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

Tensor parallelism (``parallel/tensor.py::shard_state``) leaves each rank
a channel slice of the sharded convs and BatchNorms and tags each sharded
conv ``tp`` 'column' or 'row'. :func:`conv_bn` and :func:`up_conv` then put
the collectives over the 'model' group around it: before a column conv the
identity whose backward all-reduces the input's gradient, after a row conv
the all-reduce of the partial sums (in float32, after the cast to the norm
dtype, so under the bf16 policy the ranks' partials are added in float32),
after a column transposed conv the all-gather of the channel slices.

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
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from tpu_unet_torch.core.precision import DEFAULT_POLICY, Policy
from tpu_unet_torch.ops.resize import upsample2x_bilinear_align_corners
from tpu_unet_torch.parallel import spatial
from tpu_unet_torch.parallel.tensor import copy_to_model, gather_channels, reduce_from_model


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
    :func:`recomputing` mode, under the 'space' scope of the forward (the
    backward may run in another thread)."""
    ex = spatial.current()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute_scope(ex)))


@contextlib.contextmanager
def _recompute_scope(ex):
    with _recompute_mode(), spatial.scope(ex):
        yield


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
    ``norm_dtype``); parameter and buffer names are unchanged.

    With a ``process_group`` (:func:`sync_batchnorm`) train mode takes the
    statistics of the global batch, as flax's BatchNorm does over a
    'data'-sharded batch (:class:`_GlobalBatchNorm`: an all-reduce of (sum
    x, sum x^2, count) in float32 and its derivative, the biased variance in
    flax's form E[x^2] - E[x]^2), and the running statistics move by the
    global values."""

    process_group = None  # not a parameter or buffer: state_dicts keep their names

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            out, mean, var = self._global_batch_norm(x)
        else:
            out, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            # The kernel saved 1 / sqrt(var + eps); var is recovered from it.
            var = None if recomputing() else \
                invstd.detach().double().pow(-2).sub(self.eps).clamp(min=0).float()
        if recomputing():
            return out
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                 else self.momentum)
            self.running_mean.mul_(1.0 - f).add_(mean.detach(), alpha=f)
            self.running_var.mul_(1.0 - f).add_(var.detach(), alpha=f)
        return out

    def _global_batch_norm(self, x: torch.Tensor):
        return _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.process_group)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over a process group's global batch, in float32.

    Forward: one all-reduce of (sum x, sum x^2, count), the biased variance
    as flax takes it, E[x^2] - E[x]^2, and the normalization as a fused
    inference-mode batch norm. Backward: the all-reduce differentiated, one
    all-reduce of (sum dy, sum dy (x - mean)), so each rank's input gradient
    carries the other ranks' terms: dx = w invstd (dy - mean_g(dy) - (x -
    mean) invstd^2 mean_g(dy (x - mean))). The weight and bias gradients are
    the rank's own sums, which the train step averages with the others.
    Returns (out, mean, var); the statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        stats = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                           x.new_full((1,), x.numel() // c)])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        out = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps), n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        shape = (1, c, 1, 1)
        xmu = x - mean.view(shape)
        sums = torch.cat([dy.sum(dim=(0, 2, 3)), (dy * xmu).sum(dim=(0, 2, 3))])
        grad_weight, grad_bias = sums[c:] * invstd, sums[:c].clone()
        dist.all_reduce(sums, group=ctx.group)
        k = invstd * weight
        # dy k - mean_g(dy) k - xmu invstd^2 mean_g(dy xmu) k, in two fused passes
        dx = torch.addcmul((-sums[:c] / n * k).view(shape), dy, k.view(shape))
        dx = torch.addcmul(dx, xmu, (sums[c:] / n * invstd * invstd * k).view(shape), value=-1)
        return dx, grad_weight, grad_bias, None, None


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Give every :class:`BatchNorm2d` of ``model`` the process group whose
    global batch its train mode normalizes by (None: this rank's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    return model


def conv_bn(conv: nn.Conv2d, norm: nn.Module, x: torch.Tensor, policy: Policy,
            padding: int = 0, stride: int = 1) -> torch.Tensor:
    """A bias-free conv in the compute dtype, then its BatchNorm in float32
    (after ``ops/fold_bn.py``, the conv's float32 bias and an identity).
    ``stride`` 2 (a 1x1 conv) samples the even rows and columns first: the
    same sums as a stride-2 conv, whose backward on a channels_last CPU
    tensor corrupts memory in PyTorch's CPU build. A tensor-parallel conv
    (module docstring) takes its collective: a row conv's all-reduce runs on
    the float32 output, before the bias. Under a 'space' scope
    (``parallel/spatial.py``) a padded conv takes one halo row above and
    below from the neighbouring ranks and pads the columns only, which gives
    exactly the rank's rows of the whole image's conv."""
    cd = policy.compute_dtype
    if stride > 1:
        x = x[:, :, ::stride, ::stride]
    tp = getattr(conv, "tp", None)
    x = x.to(cd)
    if tp == "column":
        x = copy_to_model(x, conv.tp_group)
    ex = spatial.current()
    if padding and ex is not None:
        if padding != 1:
            raise ValueError(f"a 'space' halo is one row; got padding {padding}")
        x, padding = spatial.halo_rows(x, ex), (0, 1)
    y = F.conv2d(x, conv.weight.to(cd), padding=padding).to(policy.norm_dtype)
    if tp == "row":
        y = reduce_from_model(y, conv.tp_group)
    if conv.bias is not None:  # BN folded into the conv (ops/fold_bn.py)
        y = y + conv.bias.view(-1, 1, 1)
    return norm(y)


def up_conv(up: nn.ConvTranspose2d, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """The k2s2 transposed conv in the compute dtype, bias added there; a
    tensor-parallel one gathers its output channels from the 'model' ranks."""
    x = x.to(cd)
    tp = getattr(up, "tp", None) == "column"
    if tp:
        x = copy_to_model(x, up.tp_group)
    y = F.conv_transpose2d(x, up.weight.to(cd), up.bias.to(cd), stride=2)
    return gather_channels(y, up.tp_group) if tp else y


def check_even_pad(dh: int) -> None:
    """Under a 'space' scope every level's rows split evenly
    (``parallel/spatial.py::check_rows``), so no row pad may be needed."""
    if dh and spatial.current() is not None:
        raise ValueError(f"a {dh}-row pad to the skip under 'space' sharding; "
                         f"{spatial.UNEVEN}")


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
            x1 = up_conv(self.up, x1, cd)
        else:
            x1 = upsample2x_bilinear_align_corners(x1.to(cd))
        # Static pad to the skip's extent (zero for power-of-two sizes).
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        check_even_pad(dh)
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
